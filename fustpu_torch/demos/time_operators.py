"""Operator micro-benchmark, the analogue of the reference's
time_operators scripts (10-rep times of the mass and stiffness applies,
P=4 on a 32^3 box): `utils.benchmarks.bench_operators` at each degree,
the stiffness apply on the card being the z-pencil kernel (#1), with the
apply's least bytes and whether they fit in the card's L2 (then the rate
is a warm one), and #1 against its plain version (``ops.spectral_mm``).

    python -m fustpu_torch.demos.time_operators [--nc 32]
        [--degrees 2 3 4 5 6] [--dtype f32|f64|bf16] [--reps 5]
        [--device cpu]

Counterpart of ``demos/time_operators.py`` (bf16: #1's bfloat16 form,
its least bytes at 2 bytes a value).  The mass apply is one
multiply by the assembled diagonal: ~2.1M values at 32^3, P=4, which the
card streams in microseconds, so its time is bounded by the enqueue.
"""

from __future__ import annotations

import argparse

import torch

from fustpu_torch.demos.common import (add_device_args, check_device, clock,
                                       pick_dtype, rel_l2)
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.models.discretization import StructuredStiffness
from fustpu_torch.utils import benchmarks as B


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nc", type=int, default=32)
    p.add_argument("--degrees", type=int, nargs="+", default=[4])
    p.add_argument("--reps", type=int, default=5)
    return add_device_args(p)


def main(argv=None) -> dict:
    """Prints each degree's rows; returns {degree: (results, rel-l2 of
    the timed stiffness apply against its plain version, least bytes of
    the stiffness apply)}."""
    args = parser().parse_args(argv)
    check_device(args)
    dev, dtype = torch.device(args.device), pick_dtype(args.dtype)
    out = {}
    for deg in args.degrees:
        mesh = build_box_mesh((args.nc,) * 3, deg)
        x, benches = B.operator_benches(mesh, dtype, dev)
        res = B.time_benches(mesh, x, benches, dtype, args.reps)
        op = benches[1][2]
        plain = (StructuredStiffness(op.cell_op, "mm") if op.impl == "cuda"
                 else op)
        rel = rel_l2(op(x), plain(x))
        for r in res:
            mb = B.min_bytes(r.name, mesh, dtype)
            print(f"{r.row()}  min {mb / 1e6:.1f} MB "
                  f"({B.warmth(mb, dev)})", flush=True)
        print(f"stiffness ({op.kernel or 'plain'}) vs plain rel-l2 "
              f"{rel:.3e}", flush=True)
        out[deg] = (res, rel, B.min_bytes("stiffness", mesh, dtype))
    print(f"   timed by {clock(dev)}")
    return out


if __name__ == "__main__":
    main()
