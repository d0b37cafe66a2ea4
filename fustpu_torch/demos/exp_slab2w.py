"""Time the two-slab kernels against #1's pencil kernel on one field, on
the same buffers: slab2 (adjacent slab pairs) and slab2w (far slab pairs,
two sweeps meeting at a seam), at the headline configuration (P=4, 32^3,
float32) or the cells given.  Counterpart of ``demos/exp_slab2w.py``;
runs on the card unless --device cpu is given (the plain versions, a
correctness run only).

    python -m fustpu_torch.demos.exp_slab2w [f32|f64] [degree]
        [--nc N | --nc NX NY NZ] [--design pencil|classes|both]

Designs: ``pencil``, the z-pencil walk with a slab pair as its work item
(the pair's two pencils in turn); ``classes``, the first CUDA design, a
class-launch one (one pair of cells a block); ``both`` times them in turns
(classes, pencil, pencil, classes), #1 in the pencil turns.

Prints each kernel's cross-check against #1 (rel-l2), its ms per apply
in each turn (median of --reps runs of --chain applies), GDOF/s and, on
the card, its share of the bound (the least bytes, G and x read once and
y written once, at 3.35 TB/s), and each design's schedule and class
counts.
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

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
ROUNDS = {"pencil": ("new", "new"), "classes": ("old", "old"),
          "both": ("old", "new", "new", "old")}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("dtype", nargs="?", choices=["f32", "f64"], default="f32")
    p.add_argument("degree", nargs="?", type=int, default=4)
    p.add_argument("--nc", type=int, nargs="+", default=[32],
                   help="cells per axis: one for a cube, or three")
    p.add_argument("--design", choices=list(ROUNDS), default="both")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--chain", type=int, default=20)
    p.add_argument("--reps", type=int, default=5)
    return p


def kernels(design: str) -> dict:
    """By round ("new", "old"): the kernels timed, name -> (pairing,
    apply)."""
    new = {"production": (None, cs.stiffness),
           "slab2": ("adjacent", c2.slab2),
           "slab2w": ("far", c2.slab2w)}
    old = {"slab2_classes": ("adjacent", c2.slab2_classes),
           "slab2w_classes": ("far", c2.slab2w_classes)}
    return {r: {"new": new, "old": old}[r] for r in set(ROUNDS[design])}


def main(argv=None) -> dict:
    """Returns the mesh, the operators by pairing, the field, by kernel
    name its output, its cross-check against #1 and its (median, std)
    seconds per apply in each of its turns, the least bytes and, on the
    card, each walk's schedule."""
    args = parser().parse_args(argv)
    check_device(args)
    if len(args.nc) not in (1, 3):
        raise SystemExit("--nc takes one or three ints")
    nc = tuple(args.nc) * (3 if len(args.nc) == 1 else 1)
    dev, dtype = torch.device(args.device), pick_dtype(args.dtype)
    P = args.degree
    mesh = build_box_mesh(nc, P, perturb=0.05, seed=1)
    _, G = pre.cell_geometry_factors(mesh)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    op = cs.CellStiffness(G=t(cs.pack_G(G)), D=t(mesh.element.deriv_1d),
                          nc=mesh.nc)
    ops = {None: op, "adjacent": s2.with_pairing(op, far=False),
           "far": s2.with_pairing(op, far=True)}
    x = t(np.random.default_rng(0).standard_normal(mesh.grid_shape))
    b = op.G.element_size()
    nbytes = op.G.numel() * b + 2 * mesh.ndofs * b
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    print(f"mesh {nc} cells, P={P}, dofs {mesh.ndofs}, {args.dtype}, "
          f"{args.device}, design {args.design}")
    by_round = kernels(args.design)
    fns = {name: kv for r in by_round.values() for name, kv in r.items()}
    ys = {name: fn(ops[pairing], x) for name, (pairing, fn) in fns.items()}
    ys.setdefault("production", cs.stiffness(op, x))
    rel = {}
    for name in fns:
        if name != "production":
            rel[name] = rel_l2(ys[name], ys["production"])
            print(f"cross-check {name} vs production: rel {rel[name]:.2e}")
    times = {name: [] for name in fns}
    for r in ROUNDS[args.design]:
        for name, (pairing, fn) in by_round[r].items():
            times[name].append(time_apply(fn, ops[pairing], x,
                                          chain=args.chain, reps=args.reps))
    card = dev.type == "cuda"
    for name, tt in times.items():
        ms = " / ".join(f"{mean * 1e3:.4f}" for mean, _ in tt)
        best = min(mean for mean, _ in tt)
        share = (f", {bound / (best * 1e3):.1%} of the bound {bound:.4f} ms"
                 if card else "")
        print(f"{name:16s}: {ms} ms/apply (+-{tt[0][1] * 1e3:.4f})  "
              f"{mesh.ndofs / best / 1e9:6.2f} GDOF/s{share}", flush=True)
    schedules = {}
    if card and "new" in by_round:
        for name, pairing in (("slab2", "adjacent"), ("slab2w", "far")):
            s = c2.card_schedule(ops[pairing], x)
            schedules[name] = s
            print(f"schedule {name}: {s.cpb} cells a pencil a "
                  f"chunk, {s.colours} pair colours, {len(s.classes)} "
                  f"classes of {s.classes[:, 1].tolist()} work items, "
                  f"{s.classes[0, 2]} chunks an item, {len(s.chunks)} "
                  f"chunks, {s.stages} stages of {s.stage_bytes:,} B, "
                  f"{s.smem:,} B shared a block, {s.blocks_per_sm} blocks "
                  f"an SM, {s.blocks} blocks, drain {s.drain}")
        s = cs.card_schedule(op, x, False)
        print(f"schedule production: {s.cpb} cells a chunk, {len(s.classes)}"
              f" classes, {s.blocks_per_sm} blocks an SM, {s.blocks} blocks")
    if "old" in by_round:
        for pairing in ("adjacent", "far"):
            print(f"classes {pairing}: {len(ops[pairing].bounds) - 1} class "
                  "launches of one pair of cells a block")
    print(f"   timed by {clock(dev)}")
    return dict(mesh=mesh, ops=ops, x=x, ys=ys, rel=rel, times=times,
                nbytes=nbytes, schedules=schedules)


if __name__ == "__main__":
    main()
