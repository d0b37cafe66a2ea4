"""Micro-experiment: stream a G-shaped array (the P=4 32^3 metric, 6
components a node) through a weighted-sum kernel in the stiffness
kernels' per-cell layout (cells, 6, n^3) and in a component-major layout
(6, cells, n^3), to see whether the layout holds the G stream back.
Counterpart of ``demos/exp_g_layout.py`` (its padded (ey, ez) and flat
(ey ez) TPU layouts; the card pads nothing); runs on the card unless
--device cpu is given (the plain version, a correctness run only).

    python -m fustpu_torch.demos.exp_g_layout [--nc 32] [--degree 4]

Prints, for each layout, the ms per call, the logical GB/s and the
result against the plain version (einsum).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fustpu_torch.demos.common import check_device, clock, rel_l2
from fustpu_torch.ops import probes
from fustpu_torch.utils.benchmarks import time_apply


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nc", type=int, default=32, help="cells per axis")
    p.add_argument("--degree", type=int, default=4)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--chain", type=int, default=16)
    p.add_argument("--reps", type=int, default=5)
    return p


def main(argv=None) -> dict:
    """Returns G in each layout, c, nc, and by layout the output, the
    plain version's and the (median, std) seconds per call."""
    args = parser().parse_args(argv)
    check_device(args)
    dev = torch.device(args.device)
    nc, n = (args.nc,) * 3, args.degree + 1
    rng = np.random.default_rng(0)
    # the JAX probe's array: (ncx, n, 6, ey, ez), per x-slab
    Gx = torch.as_tensor(rng.standard_normal(
        (nc[0], n, 6, nc[1] * n, nc[2] * n)) * 1e-3, dtype=torch.float32)
    G = probes.to_cells(Gx, nc).to(dev)
    del Gx
    c = torch.zeros((nc[1] * n, nc[2] * n), dtype=torch.float32, device=dev)
    nbytes = G.numel() * G.element_size()
    print(f"G {tuple(G.shape)} f32 ({nbytes:,} B), {args.device}")
    arrays, outs, plains, times = {}, {}, {}, {}
    for layout in probes.LAYOUTS:
        arrays[layout] = Ga = probes.to_layout(G, layout)
        outs[layout] = probes.g_weighted_sum(Ga, c, nc, layout)
        plains[layout] = probes.g_weighted_sum_plain(Ga, c, nc, layout)
        times[layout] = time_apply(
            lambda g, v, layout=layout: probes.g_weighted_sum(g, v, nc,
                                                              layout),
            Ga, c, chain=args.chain, reps=args.reps)
        t = times[layout][0]
        print(f"{layout:<12} {t * 1e3:8.4f} ms  logical "
              f"{nbytes / t / 1e9:7.1f} GB/s; vs plain rel-l2 "
              f"{rel_l2(outs[layout], plains[layout]):.2e}", flush=True)
    print(f"   timed by {clock(dev)}")
    return dict(G=arrays, c=c, nc=nc, outs=outs, plains=plains,
                times=times)


if __name__ == "__main__":
    main()
