"""Time the two-slab kernels against the production structured kernel on
one field: slab2 (adjacent slab pairs) and slab2w (far slab pairs, two
sweeps meeting at a seam), at the headline configuration (P=4, 32^3,
float32).  Counterpart of ``demos/exp_slab2w.py``; runs on the card unless
--device cpu is given (the plain versions, a correctness run only).

    python -m fustpu_torch.demos.exp_slab2w [f32|f64] [degree] [nc]

Prints each pairing's cross-check against the production kernel (rel-l2)
and, for the production kernel, slab2 and slab2w, the ms per apply
(median of --reps runs of --chain applies) and GDOF/s.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fustpu_torch.demos.common import (check_device, clock, pick_dtype,
                                       rel_l2)
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.ops import cuda_slab2 as c2
from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.ops import precompute as pre
from fustpu_torch.ops import slab2 as s2
from fustpu_torch.utils.benchmarks import time_apply


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("dtype", nargs="?", choices=["f32", "f64"], default="f32")
    p.add_argument("degree", nargs="?", type=int, default=4)
    p.add_argument("nc", nargs="?", type=int, default=32,
                   help="cells per axis")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--chain", type=int, default=20)
    p.add_argument("--reps", type=int, default=5)
    return p


def main(argv=None) -> dict:
    """Returns the operators, the field, the outputs, the cross-checks and
    the (median, std) seconds per apply by kernel name."""
    args = parser().parse_args(argv)
    check_device(args)
    dev, dtype = torch.device(args.device), pick_dtype(args.dtype)
    nc, P = args.nc, args.degree
    mesh = build_box_mesh((nc,) * 3, P, perturb=0.05, seed=1)
    _, G = pre.cell_geometry_factors(mesh)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    op = cs.CellStiffness(G=t(cs.pack_G(G)), D=t(mesh.element.deriv_1d),
                          nc=mesh.nc)
    ops = {"production": op, "slab2": s2.with_pairing(op, far=False),
           "slab2w": s2.with_pairing(op, far=True)}
    fns = {"production": cs.stiffness, "slab2": c2.slab2,
           "slab2w": c2.slab2w}
    x = t(np.random.default_rng(0).standard_normal(mesh.grid_shape))
    print(f"mesh {nc}^3 P={P}, dofs {mesh.ndofs}, {args.dtype}, "
          f"{args.device}")
    ys = {name: fns[name](ops[name], x) for name in fns}
    rel = {}
    for name in ("slab2", "slab2w"):
        rel[name] = rel_l2(ys[name], ys["production"])
        print(f"cross-check {name} vs production: rel {rel[name]:.2e}")
    times = {}
    for name, fn in fns.items():
        mean, std = time_apply(fn, ops[name], x, chain=args.chain,
                               reps=args.reps)
        times[name] = (mean, std)
        print(f"{name:12s}: {mean * 1e3:8.4f} ms/apply (+-{std * 1e3:.4f})  "
              f"{mesh.ndofs / mean / 1e9:6.2f} GDOF/s", flush=True)
    print(f"   timed by {clock(dev)}")
    return dict(mesh=mesh, ops=ops, x=x, ys=ys, rel=rel, times=times)


if __name__ == "__main__":
    main()
