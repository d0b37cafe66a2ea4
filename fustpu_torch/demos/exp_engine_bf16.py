"""The staged engine's bfloat16 contraction (#9) and scatter (#10): the
redesigned kernels (``csrc/engine_bf16.cu``: `cen.contract`, `cen.scatter`)
against their first designs kept as the comparison (``csrc/engine.cu``:
`cen.contract_cells`, `cen.scatter_dofs`), on the same buffers, in turns;
with `--indexed`, #11 in bfloat16 instead: the lean chunk kernel
(``csrc/indexed_lean.cu``, `ci.indexed`) against the first bfloat16 chunk
kernel (``csrc/indexed_chunk.cu``, `ci.indexed_first`) at each of
`--degrees`, single field (a per-cell coefficient in G) and pair.

    python -m fustpu_torch.demos.exp_engine_bf16 [--nc 64 40 40]
        [--degree 4] [--turns 2] [--device cpu]
    python -m fustpu_torch.demos.exp_engine_bf16 --indexed
        [--degrees 2 3 4 5 6 7 8] [--nc 64 40 40] [--turns 2]

The mesh is a perturbed box of `--nc` cells read as a general mesh (64 x
40 x 40 at P = 4: the bodyfit bowl's 102,400 cells and 6,661,697 dofs), in
its cells' lexicographic order.  For each contraction mode (unit, per-cell
coefficient, pair) and for the scatter: the two designs' outputs compared
(the scatter bitwise; the contraction's differing values counted, and its
rel-l2), then ms per call in turns (old, new, new, old, `--turns` times),
each beside the least bytes the call must move at 3.35 TB/s
(``tools.profile_step.engine_bytes``); then the composed apply on each
pair of designs, beside its three kernels' least bytes summed.
With `--indexed`, at each degree and form that the main path runs on the
lean chunk kernel (``cuda_indexed.LEAN_BF16``): the two designs' outputs
on the same schedule (bitwise, by design: the differing values counted),
ms per apply in turns, each beside the apply's least bytes (G, x, y once,
the dofmap) at 3.35 TB/s, and first / lean; at the others the first
design's ms alone, the lean kernel being built only where it runs.  On
the CPU both designs are the plain versions and the times are host-clock
CPU times, not device times.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fustpu_torch.demos.common import add_device_args, check_device, clock
from fustpu_torch.demos.common import rel_l2
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.mesh.unstructured import from_box
from fustpu_torch.models.discretization import Discretization
from fustpu_torch.ops import cuda_engine as cen
from fustpu_torch.ops import cuda_indexed as ci
from fustpu_torch.tools.profile_step import engine_bytes
from fustpu_torch.utils.benchmarks import time_apply

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nc", type=int, nargs=3, default=[64, 40, 40])
    p.add_argument("--degree", type=int, default=4)
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("--indexed", action="store_true",
                   help="time #11 in bf16: the lean chunk kernel against "
                        "the first bf16 chunk kernel at each --degrees")
    p.add_argument("--degrees", type=int, nargs="+",
                   default=[2, 3, 4, 5, 6, 7, 8])
    return add_device_args(p, dtype="bf16")


def _ms(fn, x) -> float:
    return time_apply(lambda _, __: fn(), None, x, chain=20, reps=1)[0] * 1e3


def run(nc, degree: int, device, turns: int = 2) -> dict:
    """Times both designs of #9 (each mode) and #10 and the composed apply
    on the box; returns {case: {"old": [ms], "new": [ms], "bound_ms",
    "differ", "values", "rel"}}."""
    mesh = from_box(build_box_mesh(tuple(nc), degree, perturb=0.1, seed=0))
    disc = Discretization(mesh)
    rng = np.random.default_rng(0)
    bf = lambda a: torch.as_tensor(a, device=device).to(torch.bfloat16)
    c1 = rng.uniform(0.5, 2.0, mesh.num_cells)
    c2 = rng.uniform(-1.5, -0.5, mesh.num_cells)
    x1, x2 = bf(rng.standard_normal(mesh.ndofs)), \
        bf(rng.standard_normal(mesh.ndofs))
    print(f"{mesh.num_cells} cells, {mesh.ndofs} dofs, P={degree}, bf16; "
          f"timed by {clock(device)}", flush=True)
    out, card = {}, torch.device(device).type == "cuda"

    def turn(name, new, old, nbytes, ys):
        differ = int((ys[0] != ys[1]).sum())
        r = dict(old=[], new=[], bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                 differ=differ, values=ys[0].numel(),
                 rel=rel_l2(ys[0], ys[1]))
        for which in ("old", "new", "new", "old") * turns:
            r[which].append(_ms(new if which == "new" else old, x1))
        out[name] = r
        share = (f" (new {r['bound_ms'] / min(r['new']):.1%}, old "
                 f"{r['bound_ms'] / min(r['old']):.1%})" if card else "")
        print(f"{name:18s} old " + " / ".join(f"{t:.4f}" for t in r["old"])
              + "  new " + " / ".join(f"{t:.4f}" for t in r["new"])
              + f" ms; the card's bound {r['bound_ms']:.4f} ms{share}; new "
              f"vs old: {differ} of {r['values']} values differ, rel-l2 "
              f"{r['rel']:.3e}", flush=True)

    for mode, kw in (("plain", {}), ("coeff", {"coeff": c1}),
                     ("pair", {"pair": (c1, c2)})):
        op = disc.stiffness_op(torch.bfloat16, device, engine=True, **kw)
        us = cen.gather2(op, x1, x2) if mode == "pair" else \
            (cen.gather(op, x1),)
        _, cb, sb = engine_bytes(op)
        yk = cen.contract(op, *us)
        turn(f"contract {mode}", lambda: cen.contract(op, *us),
             lambda: cen.contract_cells(op, *us), cb,
             (yk, cen.contract_cells(op, *us)))
        if mode == "plain":
            ys = (cen.scatter(op, yk), cen.scatter_dofs(op, yk))
            turn("scatter", lambda: cen.scatter(op, yk),
                 lambda: cen.scatter_dofs(op, yk), sb, ys)
            gb = engine_bytes(op)[0]
            old = lambda: cen.scatter_dofs(op, cen.contract_cells(
                op, cen.gather(op, x1)))
            turn("apply", lambda: cen.engine(op, x1), old, gb + cb + sb,
                 (cen.engine(op, x1), old()))
        if mode == "pair":
            old = lambda: cen.scatter_dofs(op, cen.contract_cells(
                op, *cen.gather2(op, x1, x2)))
            turn("apply pair", lambda: cen.engine_pair(op, x1, x2), old,
                 sum(engine_bytes(op)), (cen.engine_pair(op, x1, x2), old()))
    return out


def run_indexed(nc, degrees, device, turns: int = 2) -> dict:
    """#11 in bf16 on the box at each degree, single (a per-cell
    coefficient) and pair: the lean chunk kernel against the first bf16
    chunk kernel in turns where the main path runs the lean one, the first
    alone elsewhere; returns {(P, form): {"old": [ms], "new": [ms],
    "bound_ms", "differ", "values"}}."""
    out, card = {}, torch.device(device).type == "cuda"
    for P in degrees:
        mesh = from_box(build_box_mesh(tuple(nc), P, perturb=0.1, seed=0))
        disc = Discretization(mesh)
        rng = np.random.default_rng(P)
        c1 = rng.uniform(0.5, 2.0, mesh.num_cells)
        c2 = rng.uniform(-1.5, -0.5, mesh.num_cells)
        xs = [torch.as_tensor(rng.standard_normal(mesh.ndofs),
                              device=device).to(torch.bfloat16)
              for _ in range(2)]
        print(f"P={P}: {mesh.num_cells} cells, {mesh.ndofs} dofs, bf16; "
              f"timed by {clock(device)}", flush=True)
        for pair, kw in ((False, {"coeff": c1}), (True, {"pair": (c1, c2)})):
            op = disc.stiffness_op(torch.bfloat16, device, **kw)
            a = xs[:1 + pair]
            new = lambda: (ci.indexed_pair if pair else ci.indexed)(op, *a)
            old = lambda: (ci.indexed_pair_first if pair
                           else ci.indexed_first)(op, *a)
            nbytes = (op.G.numel() * 2 + mesh.ndofs * 2 * (len(a) + 1)
                      + op.dofmap.numel() * 4 + (op.C.numel() * 2 if pair
                                                 else 0))
            lean = ci.lean_runs(P, pair, torch.bfloat16)
            r = dict(old=[], new=[], bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3)
            form = "pair" if pair else "single"
            if lean:
                yn, yo = new(), old()
                r.update(differ=int((yn != yo).sum()), values=yn.numel())
            for which in ("old", "new", "new", "old") * turns:
                if lean or which == "old":
                    r[which].append(_ms(new if which == "new" else old, a[0]))
            out[P, form] = r
            b = r["bound_ms"]
            share = (lambda t: f" ({b / min(t):.1%} of the bound)") if card \
                else (lambda t: "")
            line = (f"P={P} {form:6s} first " + " / ".join(
                f"{t:.4f}" for t in r["old"]) + f" ms{share(r['old'])}")
            if lean:
                line += (" lean " + " / ".join(f"{t:.4f}" for t in r["new"])
                         + f" ms{share(r['new'])}; first / lean "
                         f"{min(r['old']) / min(r['new']):.4f}; lean vs "
                         f"first: {r['differ']} of {r['values']} values "
                         f"differ")
            else:
                line += " (the main path runs the first design here)"
            print(line + f"; the card's bound {b:.4f} ms", flush=True)
    return out


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    check_device(args)
    if args.dtype != "bf16":
        raise SystemExit("exp_engine_bf16 times the bf16 kernels: --dtype "
                         "bf16")
    if args.indexed:
        return run_indexed(args.nc, args.degrees, torch.device(args.device),
                           args.turns)
    return run(args.nc, args.degree, torch.device(args.device), args.turns)


if __name__ == "__main__":
    main()
