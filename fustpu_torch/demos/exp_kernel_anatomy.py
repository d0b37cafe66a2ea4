"""Anatomy of the parity-class structured stiffness kernel (#1, which the
main path ran before the z-pencil kernel): time variants of it that keep
one part of its work, on the same grid, to see where its time goes.
Counterpart of ``demos/exp_kernel_anatomy.py`` (whose vpu / mxu variants
are gstream / contract here); runs on the card unless --device cpu is
given (the plain versions, a correctness run only).

Variants (``fustpu_torch.ops.anatomy``):
  full      the parity-class kernel #1 itself
  gstream   the x and G loads, the pointwise metric and the scatter; the
            1-D contractions replaced by the identity
  contract  the sum factorisation with a constant metric, no G read
  ywin      the operator, with x staged by a cooperative copy

    python -m fustpu_torch.demos.exp_kernel_anatomy [--nc 32] [--degree 4]

Prints each variant's ms per apply, each against its plain version and
full and ywin against each other (rel-l2), and full - gstream - contract.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fustpu_torch.demos.common import check_device, clock, rel_l2
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.ops import anatomy
from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.ops import precompute as pre
from fustpu_torch.utils.benchmarks import time_apply


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nc", type=int, default=32)
    p.add_argument("--degree", type=int, default=4)
    p.add_argument("--variants", default="",
                   help="comma list (default: all)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--chain", type=int, default=50)
    p.add_argument("--reps", type=int, default=5)
    return p


def main(argv=None) -> dict:
    """Returns the operator, the field, and by variant its output, its
    plain version's output and its (median, std) seconds per apply."""
    args = parser().parse_args(argv)
    check_device(args)
    dev = torch.device(args.device)
    mesh = build_box_mesh((args.nc,) * 3, args.degree)
    _, G = pre.cell_geometry_factors(mesh)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    op = cs.CellStiffness(G=t(cs.pack_G(G)), D=t(mesh.element.deriv_1d),
                          nc=mesh.nc)
    x = t(np.random.default_rng(0).standard_normal(mesh.grid_shape))
    names = (tuple(args.variants.split(",")) if args.variants
             else anatomy.VARIANTS)
    print(f"mesh {args.nc}^3 P={args.degree}, dofs {mesh.ndofs}, f32, "
          f"{args.device}")
    outs, plains, times = {}, {}, {}
    for name in names:
        outs[name] = anatomy.variant(op, x, name)
        plains[name] = anatomy.variant_plain(op, x, name)
        times[name] = time_apply(lambda o, v: anatomy.variant(o, v, name),
                                 op, x, chain=args.chain, reps=args.reps)
        print(f"{name:<8}: {times[name][0] * 1e3:.4f} ms "
              f"(+-{times[name][1] * 1e3:.4f}); vs its plain version "
              f"rel-l2 {rel_l2(outs[name], plains[name]):.2e}", flush=True)
    if "ywin" in outs and "full" in outs:
        err = rel_l2(outs["ywin"], outs["full"])
        print(f"ywin vs full rel-err: {err:.2e} (the same operator; "
              "expect float32 summation-order noise)")
    if all(k in times for k in ("full", "gstream", "contract")):
        resid = times["full"][0] - times["gstream"][0] - times["contract"][0]
        print(f"full - gstream - contract = {resid * 1e3:+.4f} ms "
              "(negative => the G stream and the contractions overlap; "
              "~0 => serial)")
    print(f"   timed by {clock(dev)}")
    return dict(mesh=mesh, op=op, x=x, outs=outs, plains=plains,
                times=times)


if __name__ == "__main__":
    main()
