"""Anatomy of the structured stiffness kernel #1: time variants of it that
keep one part of its work, on the same grid, to see where its time goes,
in two designs: the z-pencil walk that the main path runs (``pencil``)
and the first CUDA design, the parity-class kernel (``classes``).
Counterpart of
``demos/exp_kernel_anatomy.py`` (whose vpu / mxu variants are gstream /
contract here); runs on the card unless --device cpu is given (the plain
versions, a correctness run only).

Variants (``fustpu_torch.ops.anatomy``):
  full       #1 itself (on the walk: ``cuda_stiffness.stiffness``)
  gstream    the x and G traffic, the pointwise metric and the scatter;
             the 1-D contractions replaced by the identity
  contract   the sum factorisation with a constant metric, no G read
  ywin       the operator, with x arriving another way (the walk: bulk
             copies of its z-line runs; the parity-class kernel: a
             cooperative copy)
  full_pair  #2, the pair form of full

    python -m fustpu_torch.demos.exp_kernel_anatomy [--nc 32 | --nc NX NY
        NZ] [--degree 4] [--design pencil|classes|both] [--sweep]

Prints each variant's ms per apply in each turn (both designs: classes,
pencil, pencil, classes), its rate over its least bytes and its share of
its own bound (the larger of those bytes at 3.35 TB/s and its operations
at 67 TFLOP/s), each against its plain version (rel-l2), full - gstream -
contract for each design, and the pencil schedule each ran (cells a
chunk, stages, blocks an SM).  --sweep (on the card) also times each
pencil variant under every cells a chunk that its kernel takes and prints
the schedule's choice beside the fastest.
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

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
PEAK_F32_PER_S = 67e12          # and float32 outside the tensor cores
NAMES = (*anatomy.VARIANTS, "full_pair")
TURNS = {"pencil": ("pencil", "pencil"), "classes": ("classes", "classes"),
         "both": ("classes", "pencil", "pencil", "classes")}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nc", type=int, nargs="+", default=[32],
                   help="cells per axis: one for a cube, or three")
    p.add_argument("--degree", type=int, default=4)
    p.add_argument("--design", choices=list(TURNS), default="pencil")
    p.add_argument("--variants", default="",
                   help="comma list (default: all, and full_pair)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--chain", type=int, default=50)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--sweep", action="store_true",
                   help="the pencil variants under every cells a chunk")
    return p


def sweep(op, x, names, costs, chain: int, reps: int) -> dict:
    """Each pencil variant of `names` timed under every cells a chunk
    (`cpb`) that its kernel takes; prints each time, its rate over the
    variant's least bytes (`costs`) and the schedule's choice beside the
    fastest.  Returns by name the chosen cpb and the (cpb, blocks an SM,
    ms) rows."""
    out = {}
    for name in names:
        if name == "full_pair":
            continue
        chosen = anatomy.card_schedule(op, x, name).cpb
        rows = []
        for cpb in range(1, cs.MAX_THREADS // (op.P + 1) ** 2 + 1):
            try:
                s = anatomy.card_schedule(op, x, name, cpb=cpb)
            except ValueError:           # beyond the kernel's bounds
                continue
            ms = time_apply(lambda _, __, c=cpb: anatomy.variant(
                op, x, name, cpb=c), None, x, chain=chain,
                reps=reps)[0] * 1e3
            rows.append((cpb, s.blocks_per_sm, ms))
            print(f"sweep {name}: {cpb} cells a chunk, {s.blocks_per_sm} "
                  f"blocks an SM: {ms:.4f} ms, "
                  f"{costs[name][0] / ms / 1e9:.4f} TB/s", flush=True)
        best = min(rows, key=lambda r: r[2])
        mine = next(r for r in rows if r[0] == chosen)
        print(f"sweep {name}: the schedule's {chosen} cells {mine[2]:.4f} ms, "
              f"the fastest {best[0]} cells {best[2]:.4f} ms "
              f"({mine[2] / best[2]:.4f}x)", flush=True)
        out[name] = dict(chosen=chosen, rows=rows)
    return out


def pair_cost(op: cs.CellStiffness, ndofs: int) -> tuple[int, int]:
    """(least bytes, operations) of #2: G, both fields and (c1, c2) read
    once, y written once; 3 more operations a node to combine."""
    cells, _, nnn = op.G.shape
    b = op.G.element_size()
    nbytes = op.G.numel() * b + 3 * ndofs * b + op.C.numel() * b
    return nbytes, cells * nnn * (12 * (op.P + 1) + 19)


def main(argv=None) -> dict:
    """Returns the mesh, the operator (with pair coefficients), the
    fields, and by design and variant its output and its (median, std)
    seconds per apply in each turn; by variant its plain version's output,
    its (least bytes, operations) and, on the card, its pencil schedule."""
    args = parser().parse_args(argv)
    check_device(args)
    if len(args.nc) not in (1, 3):
        raise SystemExit("--nc takes one or three ints")
    nc = tuple(args.nc) * (3 if len(args.nc) == 1 else 1)
    dev = torch.device(args.device)
    mesh = build_box_mesh(nc, args.degree)
    _, G = pre.cell_geometry_factors(mesh)
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    C = np.stack([rng.uniform(0.5, 2.0, mesh.num_cells),
                  rng.uniform(-2.0, 2.0, mesh.num_cells)], axis=1)
    op = cs.CellStiffness(G=t(cs.pack_G(G)), D=t(mesh.element.deriv_1d),
                          nc=mesh.nc, C=t(C))
    x = t(rng.standard_normal(mesh.grid_shape))
    x2 = t(rng.standard_normal(mesh.grid_shape))
    names = (tuple(args.variants.split(",")) if args.variants else NAMES)
    designs = sorted(set(TURNS[args.design]), reverse=True)

    def run(name, design):
        if name == "full_pair":
            return anatomy.full_pair(op, x, x2, design)
        return anatomy.variant(op, x, name, design)

    print(f"mesh {nc} cells, P={args.degree}, dofs {mesh.ndofs}, f32, "
          f"{args.device}, design {args.design}")
    card = dev.type == "cuda"
    outs = {d: {} for d in designs}
    times = {d: {} for d in designs}
    plains, costs, schedules = {}, {}, {}
    for name in names:
        plains[name] = (cs.stiffness_pair_plain(op, x, x2)
                        if name == "full_pair"
                        else anatomy.variant_plain(op, x, name))
        costs[name] = (pair_cost(op, mesh.ndofs) if name == "full_pair"
                       else anatomy.variant_cost(op, mesh.ndofs, name))
        nbytes, flops = costs[name]
        bound = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S) * 1e3
        for design in designs:
            outs[design][name] = run(name, design)
            times[design][name] = []
        for design in TURNS[args.design]:
            times[design][name].append(time_apply(
                lambda _, __, d=design: run(name, d), None, x,
                chain=args.chain, reps=args.reps))
        for design in designs:
            tt = times[design][name]
            ms = [mean * 1e3 for mean, _ in tt]
            rate = (f", {nbytes / min(ms) / 1e9:.4f} TB/s over {nbytes:,} B, "
                    f"{bound / min(ms):.1%} of its bound {bound:.4f} ms"
                    if card else "")
            print(f"{design:7s} {name:9s}: "
                  + " / ".join(f"{v:.4f}" for v in ms) + f" ms{rate}; vs "
                  f"its plain version rel-l2 "
                  f"{rel_l2(outs[design][name], plains[name]):.2e}",
                  flush=True)
        if card and "pencil" in designs:
            s = (cs.card_schedule(op, x, True) if name == "full_pair"
                 else anatomy.card_schedule(op, x, name))
            schedules[name] = s
            print(f"   pencil schedule ({name}): {s.cpb} cells a chunk, "
                  f"{s.stages} stages of {s.stage_bytes:,} B, {s.smem:,} B "
                  f"shared a block, {s.blocks_per_sm} blocks an SM, "
                  f"{s.blocks} blocks, {len(s.chunks)} chunks")
    for design in designs:
        tm = times[design]
        if all(k in tm for k in ("full", "gstream", "contract")):
            best = {k: min(m for m, _ in tm[k]) for k in tm}
            resid = best["full"] - best["gstream"] - best["contract"]
            print(f"{design}: full - gstream - contract = "
                  f"{resid * 1e3:+.4f} ms (negative => the G stream and the "
                  "contractions overlap; ~0 => serial)")
        if "pencil" == design and "ywin" in outs[design] and \
                "full" in outs[design]:
            same = torch.equal(outs[design]["ywin"], outs[design]["full"])
            print(f"pencil: ywin bitwise full: {same}")
    swept = (sweep(op, x, names, costs, args.chain, args.reps)
             if args.sweep and card else None)
    print(f"   timed by {clock(dev)}")
    return dict(mesh=mesh, op=op, x=x, x2=x2, outs=outs, plains=plains,
                times=times, costs=costs, schedules=schedules, sweep=swept)


if __name__ == "__main__":
    main()
