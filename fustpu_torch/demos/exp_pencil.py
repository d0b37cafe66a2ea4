"""The parity-class structured stiffness kernels (#1 single, #2 pair: eight
parity classes of scattered cells) against the z-pencil kernels that
replaced them on the main path, timed in turns on the same operator and
fields: parity-class, pencil, pencil, parity-class.  Runs on the card
unless --device cpu is given (the plain versions, a correctness run only).

    python -m fustpu_torch.demos.exp_pencil [--nc 64 40 40] [--degree 4]
        [--corner] [--bf16 [--degrees 2 3 ...] [--rounds 1]] [--sweep]

For the single-field and the pair form it prints each kernel's ms per
apply in its two turns, the rate over the apply's least bytes (G, each
input field and the pair coefficients read once, y written once)
and the share of the bound (those bytes at the H100's published 3.35
TB/s), the two kernels against each other and against the plain version
(rel-l2), and the pencil kernel's schedule (cells a chunk, stages, blocks
per SM, classes).  The box is generated (`build_box_mesh`), float32; the
flagship bowl has the same cells and bytes.  With --corner it times #3,
the corner-streamed capacity mode, instead: the class-launch design (8
parity classes of scattered cells, `cuda_corner.corner_classes`) against
the walk of box pencils with the corner metric (`cuda_corner.corner`),
single (a per-cell coefficient) and pair, each one's share of the larger
of its byte and operation bounds (``exp_imported.compare_corner``).
`--corner --sweep` then times the walk on the card under every cells a
chunk that its kernel takes, single and pair, float32 and float64, and
prints the schedule's choice (``cuda_stiffness.pencil_schedule``) beside
the fastest; `--sweep` without --corner does the same for the G stream's
#1 and #2 in float32 and bfloat16 (whose stages hold half the bytes a
cell): in bfloat16 both the first bfloat16 walk and, where the main path
runs it (``cuda_stiffness.lean_runs``), the lean walk
(``csrc/pencil_lean.cuh``).  With --bf16 it times the first bfloat16 walk
against the lean walk, in turns (first, lean, lean, first), single and
pair, with each one's share of the bound, the values that differ between
the two and each design's schedule (``compare_bf16``), in place of the
float32 comparison; with --degrees, at each of those degrees on a box of
the flagship's grid (``compare_degrees``), where the lean walk runs.
With --corner --bf16 it times the first bfloat16 corner walk against the
lean corner walk (``csrc/corner_lean.cuh``) on the box in corner mode, in
turns, single and pair (``exp_imported.compare_corner_bf16``); with
--degrees at each of those degrees on a box of the flagship's grid, where
the lean corner walk runs (``cuda_corner.LEAN_CORNER_BF16``).
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


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nc", type=int, nargs=3, default=[64, 40, 40])
    p.add_argument("--degree", type=int, default=4)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--chain", type=int, default=20)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--corner", action="store_true",
                   help="#3, the corner forms, in place of #1 and #2")
    p.add_argument("--sweep", action="store_true",
                   help="the walk under every cells a chunk (#3 with "
                        "--corner; #1 / #2 in float32 and bfloat16 else)")
    p.add_argument("--bf16", action="store_true",
                   help="the first bfloat16 walk against the lean walk, "
                        "in turns, in place of the float32 comparison")
    p.add_argument("--degrees", type=int, nargs="+",
                   help="with --bf16: the comparison at each of these "
                        "degrees on a box of the flagship's grid")
    p.add_argument("--rounds", type=int, default=1,
                   help="with --corner --bf16: rounds of turns")
    return p


def sweep_corner(disc, dev, chain: int = 20, reps: int = 3) -> dict:
    """The box walk of `disc`'s corner operator timed under every cells a
    chunk (`cpb`) that its kernel takes, single (a per-cell coefficient)
    and pair, float32 and float64; prints each time and the schedule's
    choice beside the fastest.  Returns by (form, dtype) the chosen cpb
    and the (cpb, blocks an SM, ms) rows."""
    from fustpu_torch.ops import cuda_corner as cc

    mesh = disc.mesh
    rng = np.random.default_rng(0)
    c1 = rng.uniform(0.5, 2.0, mesh.nc)
    c2 = rng.uniform(-2.0, 2.0, mesh.nc)
    x64 = [rng.standard_normal(mesh.grid_shape) for _ in range(2)]
    out = {}
    for dtype in (torch.float32, torch.float64):
        xs = [torch.as_tensor(x, dtype=dtype, device=dev) for x in x64]
        for form, kw, fn in (("single", {"coeff": c1}, cc.corner),
                             ("pair", {"pair": (c1, c2)}, cc.corner_pair)):
            pair = form == "pair"
            op = disc.stiffness_op(dtype, dev, corner=True, **kw)
            a = xs if pair else xs[:1]
            chosen = cc.card_schedule(op, a[0], pair).cpb
            rows = []
            for cpb in range(1, cs.MAX_THREADS // (op.P + 1) ** 2 + 1):
                try:
                    s = cc.card_schedule(op, a[0], pair, cpb=cpb)
                except ValueError:       # beyond the kernel's bounds
                    continue
                ms = time_apply(lambda _, __, c=cpb: fn(op, *a, cpb=c),
                                None, a[0], chain=chain, reps=reps)[0] * 1e3
                rows.append((cpb, s.blocks_per_sm, ms))
                print(f"sweep #3 {form} {str(dtype)[6:]}: {cpb} cells a "
                      f"chunk, {s.blocks_per_sm} blocks an SM: {ms:.4f} ms",
                      flush=True)
            best = min(rows, key=lambda r: r[2])
            mine = next(r for r in rows if r[0] == chosen)
            print(f"sweep #3 {form} {str(dtype)[6:]} P={op.P}: the "
                  f"schedule's {chosen} cells {mine[2]:.4f} ms, the fastest "
                  f"{best[0]} cells {best[2]:.4f} ms ({mine[2] / best[2]:.4f}"
                  "x)", flush=True)
            out[form, dtype] = dict(chosen=chosen, rows=rows)
    return out


def _sweep_rows(label: str, schedule, apply, P: int, chain: int,
                reps: int, x) -> list:
    """(cpb, blocks an SM, ms) of apply(cpb) under every cells a chunk that
    `schedule(cpb)` takes (ValueError beyond the kernel's bounds), each
    printed under `label`."""
    rows = []
    for cpb in range(1, cs.MAX_THREADS // (P + 1) ** 2 + 1):
        try:
            s = schedule(cpb)
        except ValueError:               # beyond the kernel's bounds
            continue
        ms = time_apply(lambda _, __, c=cpb: apply(c), None, x, chain=chain,
                        reps=reps)[0] * 1e3
        rows.append((cpb, s.blocks_per_sm, ms))
        print(f"sweep {label}: {cpb} cells a chunk, {s.blocks_per_sm} "
              f"blocks an SM: {ms:.4f} ms", flush=True)
    return rows


def sweep_gstream(op: cs.CellStiffness, xs, dev, chain: int = 20,
                  reps: int = 3) -> dict:
    """#1 (single) and #2 (pair: `op` with C) of the float32 operator `op`
    and of its bfloat16 cast timed under every cells a chunk that the
    kernel takes, on the fields `xs`: float32 on its walk, bfloat16 on the
    first bfloat16 walk ("first") and, where the main path runs it, on the
    lean walk ("lean"); prints each time and the schedule's choice beside
    the fastest.  Returns by (form, dtype, design) the chosen cpb and the
    (cpb, blocks an SM, ms) rows."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        o = op._replace(**{k: v.to(dtype) for k, v in op._asdict().items()
                           if isinstance(v, torch.Tensor)})
        a = [x.to(dtype) for x in xs]
        for form in ("single", "pair"):
            pair = form == "pair"
            oo = o if pair else o._replace(C=None)
            args = a if pair else a[:1]
            tag = f"#{2 if pair else 1} {form} {str(dtype)[6:]}"
            main = cs.stiffness_pair if pair else cs.stiffness
            if dtype == torch.float32:
                designs = {"first": main}
            else:
                designs = {"first": cs.stiffness_pair_first if pair
                           else cs.stiffness_first}
                if cs.lean_runs(op.P, pair, dtype):
                    designs["lean"] = main
            for name, fn in designs.items():
                design = name if dtype == torch.bfloat16 else "first"
                chosen = cs._card_schedule(
                    tuple(op.nc), op.P, dtype, pair, args[0].device,
                    design=design)[0].cpb
                rows = _sweep_rows(
                    f"{tag} {name}",
                    lambda c: cs._card_schedule(
                        tuple(op.nc), op.P, dtype, pair, args[0].device,
                        cpb=c, design=design)[0],
                    lambda c: fn(oo, *args, cpb=c), op.P, chain, reps,
                    args[0])
                best = min(rows, key=lambda r: r[2])
                mine = next(r for r in rows if r[0] == chosen)
                print(f"sweep {tag} {name} P={op.P}: the schedule's "
                      f"{chosen} cells {mine[2]:.4f} ms, the fastest "
                      f"{best[0]} cells {best[2]:.4f} ms "
                      f"({mine[2] / best[2]:.4f}x)", flush=True)
                out[form, dtype, name] = dict(chosen=chosen, rows=rows)
    return out


def compare_bf16(op: cs.CellStiffness, xs, chain: int = 20,
                 reps: int = 5) -> dict:
    """The first bfloat16 walk (`cs.stiffness_first` / `_pair_first`)
    against the lean walk (the main path's `cs.stiffness` /
    `cs.stiffness_pair` at a degree where `cs.lean_runs`) on the bfloat16
    operator `op` (single; pair when it has C) and fields `xs`, in turns
    (first, lean, lean, first): ms of each turn, the least bytes' share,
    the two outputs compared (values that differ, rel-l2) and each
    design's schedule.  Returns {"first": [ms], "lean": [ms], "differ",
    "rel_l2", "nbytes", "y_lean", "y_first"}."""
    pair = op.C is not None
    args = xs[:2] if pair else xs[:1]
    if not cs.lean_runs(op.P, pair, args[0].dtype):
        raise ValueError(f"compare_bf16: P={op.P} {'pair' if pair else ''} "
                         "keeps the first bfloat16 walk")
    fns = {"first": cs.stiffness_pair_first if pair else cs.stiffness_first,
           "lean": cs.stiffness_pair if pair else cs.stiffness}
    ys = {k: f(op, *args) for k, f in fns.items()}
    times = {k: [] for k in fns}
    for k in ("first", "lean", "lean", "first"):
        times[k].append(time_apply(lambda o, _, f=fns[k]: f(o, *args), op,
                                   args[0], chain=chain, reps=reps)[0] * 1e3)
    nbytes = least_bytes(op, args[0].numel(), len(args))
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    differ = int((ys["lean"] != ys["first"]).sum())
    err = rel_l2(ys["lean"], ys["first"])
    for k in fns:
        sch = cs._card_schedule(tuple(op.nc), op.P, args[0].dtype, pair,
                                args[0].device, design=k)[0]
        print(f"#{2 if pair else 1} bf16 {k:5s}: "
              + " / ".join(f"{t:.4f}" for t in times[k])
              + f" ms, {bound / min(times[k]):.1%} of the bound "
              f"{bound:.4f} ms ({nbytes:,} B); {sch.cpb} cells a chunk, "
              f"{sch.blocks_per_sm} blocks an SM, {sch.blocks} blocks",
              flush=True)
    print(f"#{2 if pair else 1} bf16 lean vs first: {differ} of "
          f"{ys['lean'].numel()} values differ, rel-l2 {err:.3e}; "
          f"{min(times['first']) / min(times['lean']):.4f}x", flush=True)
    return dict(**times, differ=differ, rel_l2=err, nbytes=nbytes,
                y_lean=ys["lean"], y_first=ys["first"])


def compare_degrees(degrees, dev, chain: int = 20, reps: int = 3) -> dict:
    """`compare_bf16` at each degree P of `degrees` on a box of the
    flagship's grid, (256 / P, 160 / P, 160 / P) cells rounded (64 x 40 x
    40 at P = 4), its operator set up on the card: single (a per-cell
    coefficient in G) and pair, each where the lean walk runs
    (`cs.lean_runs`).  Returns {P: {"single": ..., "pair": ...}} without
    the outputs."""
    from fustpu_torch.models.discretization import Discretization

    out = {}
    rng = np.random.default_rng(0)
    for P in degrees:
        nc = (round(256 / P), round(160 / P), round(160 / P))
        mesh = build_box_mesh(nc, P)
        disc = Discretization(mesh, device=dev)
        c1 = rng.uniform(0.5, 2.0, nc)
        c2 = rng.uniform(-2.0, 2.0, nc)
        xs = [torch.as_tensor(rng.standard_normal(mesh.grid_shape),
                              device=dev).to(torch.bfloat16)
              for _ in range(2)]
        print(f"P={P}: {nc} cells, {mesh.ndofs} DOF, bf16", flush=True)
        out[P] = {}
        for form, kw in (("single", {"coeff": c1}),
                         ("pair", {"pair": (c1, c2)})):
            if not cs.lean_runs(P, form == "pair", torch.bfloat16):
                print(f"P={P} {form}: the first bfloat16 walk runs here "
                      "(cuda_stiffness.FIRST_DESIGN_BF16)", flush=True)
                continue
            r = compare_bf16(disc.stiffness_op(torch.bfloat16, dev, **kw),
                             xs, chain, reps)
            out[P][form] = {k: v for k, v in r.items()
                            if not k.startswith("y_")}
        del disc, xs
    return out


def least_bytes(op: cs.CellStiffness, ndofs: int, fields: int) -> int:
    """G, each input field and the pair coefficients read once, y written
    once."""
    b = op.G.element_size()
    pair = op.C.numel() * b if fields == 2 else 0
    return op.G.numel() * b + (fields + 1) * ndofs * b + pair


def main(argv=None) -> dict:
    """Returns by form ("single", "pair") the operator, the fields, each
    kernel's output ("parity", "pencil"; with --corner "classes", "walk"),
    the plain version's, the two turns' (median, std) seconds per apply of
    each kernel and the least bytes."""
    args = parser().parse_args(argv)
    check_device(args)
    dev = torch.device(args.device)
    mesh = build_box_mesh(tuple(args.nc), args.degree)
    if args.corner and args.bf16:
        from fustpu_torch.demos import exp_imported
        from fustpu_torch.models.discretization import Discretization

        if args.degrees:
            out = {"mesh": mesh}
            if dev.type == "cuda":
                out["degrees"] = exp_imported.corner_degrees_bf16(
                    args.degrees, dev, ("box",), args.chain, args.reps,
                    args.rounds)
            print(f"   timed by {clock(dev)}")
            return out
        print(f"mesh {tuple(mesh.nc)} cells, P={args.degree}, {mesh.ndofs} "
              f"DOF, bf16, {args.device}, corner mode")
        mesh = build_box_mesh(tuple(args.nc), args.degree, perturb=0.1,
                              seed=0)
        out = exp_imported.corner_forms_bf16(Discretization(mesh), dev, "#3",
                                             args.chain, args.reps,
                                             args.rounds)
        print(f"   timed by {clock(dev)}")
        return {"mesh": mesh, **out}
    if args.corner:
        from fustpu_torch.demos import exp_imported
        from fustpu_torch.models.discretization import Discretization

        print(f"mesh {tuple(mesh.nc)} cells, P={args.degree}, {mesh.ndofs} "
              f"DOF, f32, {args.device}, corner mode")
        disc = Discretization(mesh)
        out = exp_imported.corner_forms(disc, dev, "#3", args.chain,
                                        args.reps)
        if args.sweep and dev.type == "cuda":
            out["sweep"] = sweep_corner(disc, dev)
        print(f"   timed by {clock(dev)}")
        return {"mesh": mesh, **out}
    if args.bf16 and args.degrees:
        out = {"mesh": mesh}
        if dev.type == "cuda":
            out["degrees"] = compare_degrees(args.degrees, dev, args.chain,
                                             args.reps)
        print(f"   timed by {clock(dev)}")
        return out
    _, G = pre.cell_geometry_factors(mesh)
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    C = np.stack([rng.uniform(0.5, 2.0, mesh.num_cells),
                  rng.uniform(-2.0, 2.0, mesh.num_cells)], axis=1)
    x1 = t(rng.standard_normal(mesh.grid_shape))
    x2 = t(rng.standard_normal(mesh.grid_shape))
    base = cs.CellStiffness(G=t(cs.pack_G(G)), D=t(mesh.element.deriv_1d),
                            nc=mesh.nc)
    if args.bf16:
        print(f"mesh {tuple(mesh.nc)} cells, P={args.degree}, {mesh.ndofs} "
              f"DOF, bf16, {args.device}")
        b16 = lambda a: a.to(torch.bfloat16)
        op16 = base._replace(G=b16(base.G), D=b16(base.D))
        xs16 = [b16(x1), b16(x2)]
        out = {"mesh": mesh}
        if dev.type == "cuda":
            out["single"] = compare_bf16(op16, xs16, args.chain, args.reps)
            out["pair"] = compare_bf16(op16._replace(C=b16(t(C))), xs16,
                                       args.chain, args.reps)
        if args.sweep and dev.type == "cuda":
            out["sweep"] = sweep_gstream(base._replace(C=t(C)), (x1, x2),
                                         dev)
        print(f"   timed by {clock(dev)}")
        return out
    forms = {
        "single": dict(op=base, xs=(x1,), kernels={
            "parity": lambda o, xs: anatomy.variant_classes(o, xs[0],
                                                            "full"),
            "pencil": lambda o, xs: cs.stiffness(o, xs[0])},
            plain=lambda o, xs: cs.stiffness_plain(o, xs[0])),
        "pair": dict(op=base._replace(C=t(C)), xs=(x1, x2), kernels={
            "parity": lambda o, xs: anatomy.full_pair_classes(o, *xs),
            "pencil": lambda o, xs: cs.stiffness_pair(o, *xs)},
            plain=lambda o, xs: cs.stiffness_pair_plain(o, *xs))}
    print(f"mesh {tuple(mesh.nc)} cells, P={args.degree}, {mesh.ndofs} DOF, "
          f"f32, {args.device}")
    out = {"mesh": mesh}
    for form, f in forms.items():
        op, xs, kern = f["op"], f["xs"], f["kernels"]
        nbytes = least_bytes(op, mesh.ndofs, len(xs))
        ys = {name: k(op, xs) for name, k in kern.items()}
        plain = f["plain"](op, xs)
        times = {name: [] for name in kern}
        for name in ("parity", "pencil", "pencil", "parity"):
            times[name].append(time_apply(
                lambda o, _, k=kern[name]: k(o, xs), op, xs[0],
                chain=args.chain, reps=args.reps))
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        for name in kern:
            ms = [tt[0] * 1e3 for tt in times[name]]
            rate = (f", {nbytes / min(ms) / 1e9:.4f} TB/s over {nbytes:,} B"
                    f", {bound / min(ms):.1%} of the bound {bound:.4f} ms"
                    if dev.type == "cuda" else "")
            print(f"{form:6s} {name:6s}: {ms[0]:.4f} / {ms[1]:.4f} ms per "
                  f"apply{rate}; vs plain rel-l2 "
                  f"{rel_l2(ys[name], plain):.3e}", flush=True)
        speed = min(tt[0] for tt in times["parity"]) / \
            min(tt[0] for tt in times["pencil"])
        print(f"{form:6s} pencil vs parity-class: rel-l2 "
              f"{rel_l2(ys['pencil'], ys['parity']):.3e}"
              + (f", {speed:.4f}x faster" if dev.type == "cuda" else ""),
              flush=True)
        out[form] = dict(op=op, xs=xs, ys=ys, plain=plain, times=times,
                         nbytes=nbytes)
    if args.sweep and dev.type == "cuda":
        out["sweep"] = sweep_gstream(forms["pair"]["op"], (x1, x2), dev)
    if dev.type == "cuda":
        for form, f in forms.items():
            s = cs.card_schedule(f["op"], x1, form == "pair")
            print(f"schedule ({form}): {s.cpb} cells a chunk "
                  f"({(args.degree + 1) ** 2 * s.cpb} threads), {s.stages} "
                  f"stages of {s.stage_bytes:,} B, {s.smem:,} B shared a "
                  f"block, {s.blocks_per_sm} blocks an SM, {s.blocks} "
                  f"blocks, {len(s.classes)} classes, {len(s.chunks)} "
                  "chunks")
    print(f"   timed by {clock(dev)}")
    return out


if __name__ == "__main__":
    main()
