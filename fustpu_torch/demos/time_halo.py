"""The exchange's cost in a sharded step, the analogue of the reference's
time_scatterer: the sharded Westervelt box over spawned ranks of
torch.distributed, stepped with and without the exchange of shared
entries (the case key `exchange=False` of ``parallel.multihost.
solve_cases``: each rank's stiffness module skips its sum), in one process
group; ms per step of each, the difference and its share.

    python -m fustpu_torch.demos.time_halo [--ranks 4] [--elements 16]
        [--degree 4] [--steps 20] [--backend gloo|nccl]
        [--device cuda|cpu] [--dtype f32|f64]

Counterpart of ``demos/time_halo.py``, which replaces the JAX package's
`halo_sum` by the identity for its second run; the port patches no module
global.  The rank grid is (ranks, 1, 1) as there; with `--backend gloo
--device cuda` the ranks share one card, so this measures the exchange
of ranks that share a card, not a multi-card speed.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch

from fustpu_torch.config import Material, Source
from fustpu_torch.demos.common import (add_device_args, add_rank_args,
                                       check_device, pick_dtype)
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.models.westervelt import WesterveltModel


def parser():
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--elements", type=int, default=16)
    p.add_argument("--degree", type=int, default=4)
    p.add_argument("--steps", type=int, default=20)
    add_rank_args(add_device_args(p))
    p.set_defaults(ranks=4)
    return p


def build(elements: int, degree: int, dtype: torch.dtype, device="cpu"):
    """(model, dt): the JAX demo's Westervelt box, 1 cm a side, a 1.1 MHz
    source on the x- face, every boundary absorbing."""
    mesh = build_box_mesh((elements,) * 3, degree, hi=(0.01,) * 3)
    mat = Material(sound_speed=1480.0, density=1000.0, nonlinearity=3.5,
                   attenuation_dB=0.2)
    src = Source(frequency=1.1e6, amplitude=1e5)
    model = WesterveltModel(mesh, mat, src, mesh.boundary_facets("x-"),
                            mesh.all_boundary_facets(), dtype=dtype,
                            device=device)
    return model, model.cfl_dt(0.4)[0]


def cases(model, dt: float, steps: int, ranks: int) -> list[dict]:
    """The two cases of one process group: the sharded box on the
    (ranks, 1, 1) grid with the exchange, then without it (`model`: the
    one-rank model or the path of its saved copy)."""
    case = dict(model=model, grid=(ranks, 1, 1), steps=steps, dt=dt)
    return [dict(case), dict(case, exchange=False)]


def report(with_ms: float, without_ms: float) -> dict:
    """Prints ms per step with and without the exchange and the exchange's
    share; returns them."""
    cost = with_ms - without_ms
    print(f"per step with halo:    {with_ms:8.3f} ms")
    print(f"per step without halo: {without_ms:8.3f} ms")
    print(f"exchange cost:         {cost:8.3f} ms/step "
          f"({cost / with_ms * 100:.1f}%)", flush=True)
    return {"with_ms": with_ms, "without_ms": without_ms,
            "exchange_ms": cost, "share": cost / with_ms}


def main(argv=None) -> dict:
    """Returns `report`'s numbers and the rel-l2 of u without the exchange
    against u with it (`differ`: the switch bites)."""
    from fustpu_torch.parallel import multihost

    args = parser().parse_args(argv)
    check_device(args)
    model, dt = build(args.elements, args.degree, pick_dtype(args.dtype))
    print(f"dofs={model.mesh.ndofs}, rank grid ({args.ranks}, 1, 1), "
          f"{args.backend} on {args.device}")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "model.pt")      # the ranks load host data
        torch.save(model, path)
        res = multihost.spawn(multihost.solve_cases, args.ranks,
                              args.backend, args.device, args=(
                                  cases(path, dt, args.steps, args.ranks),))
    on, off = res[0]
    out = report(on["ms_per_step"], off["ms_per_step"])
    out["differ"] = float(np.linalg.norm(off["u"] - on["u"])
                          / np.linalg.norm(on["u"]))
    print(f"u without the exchange vs with it: rel-l2 {out['differ']:.3e}")
    return out


if __name__ == "__main__":
    main()
