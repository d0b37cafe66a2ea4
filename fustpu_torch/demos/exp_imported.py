"""The class-launch imported-mesh stiffness kernels against the kernels that
replaced them on the main path, timed in turns on the same operators and
fields (old, new, new, old):

- #6, extruded meshes: one launch per (stack colour, layer parity) class
  of scattered cells (`extruded_classes`) against the stack walk of the
  z-pencil kernel (`extruded`), at the imported bowl's stacks;
- #11, general meshes: one launch per colour class of scattered cells
  (`indexed_classes`) against locality-ordered cell chunks with a
  bulk-copied G ring (`indexed`), and both against the composed staged
  engine (#7-#10, `engine`), at the bodyfit bowl, and at P = 6;
- with --corner in their place, #6c, the corner-streamed capacity mode:
  one launch per (stack colour, layer parity) class of scattered cells,
  each rebuilding its metric from its channels
  (`cuda_corner.extruded_corner_classes`), against the stack walk of the
  z-pencil kernel with the corner metric (`extruded_corner`), at the
  imported bowl as hex8 and, with --hex27, as hex27 (the same geometry on
  the 27-node lattice, 163 channels a cell).

Runs on the card unless --device cpu is given (the plain versions, a
correctness run only).

    python -m fustpu_torch.demos.exp_imported [--elements 64] [--degree 4]
        [--p6-elements 48] [--sweep] [--corner [--hex27]
        [--bf16 [--degrees 2 3 ...] [--rounds 1]]]

For the single-field and the pair form it prints each kernel's ms per
apply in its turns, the rate over the apply's least bytes (G, each input
field and the pair coefficients read once, y written once, and
the row ids or the dofmap once) and the share of the bound (those bytes
at the H100's published 3.35 TB/s), the kernels against each other and
against the plain version (rel-l2), each new kernel's schedule, the bytes
of the chunk kernel's own layout, and the new kernel's time under a few
other schedules (cells a chunk, z-segments a stack) than its model's.
`--sweep` then times the single-field new kernels over every schedule:
the stack kernel at each (cells a chunk, segments) pair of a grid, with
the cost model's value (``cuda_stiffness.class_cost``) beside it, the
chunk kernel at each cells a chunk, with its classes; with --corner the
corner stack walk over the same grid.  For the corner forms the bound is
the larger of the least bytes at 3.35 TB/s and the operations at the
H100's published 67 TFLOP/s float32 (``cuda_corner.apply_cost``).
Float32; the meshes are the bowl demo's (`nonlinear_bowl`).  With --corner
--bf16 it times the first bfloat16 corner walk against the lean corner walk
(``csrc/corner_lean.cuh``) in turns (first, lean, lean, first), single and
pair, on the imported bowl as hex8 (and with --hex27 as hex27), with each
one's share of the bound, the values that differ between the two and each
design's blocks an SM (`compare_corner_bf16`); with --degrees, at each of
those degrees on stacks of the flagship's grid (`corner_degrees_bf16`),
where the lean walk runs (``cuda_corner.LEAN_CORNER_BF16``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fustpu_torch.demos import nonlinear_bowl
from fustpu_torch.demos.common import check_device, clock, rel_l2
from fustpu_torch.mesh import shapes
from fustpu_torch.models.discretization import Discretization
from fustpu_torch.ops import cuda_corner as cc
from fustpu_torch.ops import cuda_engine as cen
from fustpu_torch.ops import cuda_extruded as ce
from fustpu_torch.ops import cuda_indexed as ci
from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.utils.benchmarks import time_apply

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
PEAK_F32_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
F32 = torch.float32


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--elements", type=int, default=64)
    p.add_argument("--degree", type=int, default=4)
    p.add_argument("--p6-elements", type=int, default=48,
                   help="elements of the P = 6 bodyfit bowl (0: none)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--chain", type=int, default=20)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--sweep", action="store_true",
                   help="time the new kernels over every schedule")
    p.add_argument("--corner", action="store_true",
                   help="the corner forms (#6c) in place of #6 and #11")
    p.add_argument("--hex27", action="store_true",
                   help="with --corner, also the bowl as hex27")
    p.add_argument("--bf16", action="store_true",
                   help="with --corner, the first bfloat16 corner walk "
                        "against the lean corner walk")
    p.add_argument("--degrees", type=int, nargs="+",
                   help="with --corner --bf16: the comparison at each of "
                        "these degrees on stacks of the flagship's grid")
    p.add_argument("--rounds", type=int, default=1,
                   help="with --corner --bf16: rounds of turns")
    return p


def least_bytes(G: torch.Tensor, ndofs: int, fields: int,
                index_bytes: int) -> int:
    """G, each input field and the pair coefficients read once, y written
    once, and the index data (row ids or dofmap) once."""
    b = G.element_size()
    pair = G.shape[0] * 2 * b if fields == 2 else 0
    return G.numel() * b + (fields + 1) * ndofs * b + pair + index_bytes


def chunk_bytes(op: ci.IndexedCellStiffness, sched: ci.ChunkSchedule,
                fields: int) -> int:
    """What the chunk kernel's layout reads and writes once an apply: G,
    each chunk's unique dofs' x (x2), earlier y and y, their ids and
    ends, the positions, the table rows and the pair coefficients."""
    b = op.G.element_size()
    tab = op.plan.tables(sched.cpb)
    u = int(tab.nu.sum())
    pair = op.G.shape[0] * 2 * b if fields == 2 else 0
    return (op.G.numel() * b + u * ((fields + 2) * b + 4 + 2)
            + tab.pos.size * 2 + sched.chunks.size * 8 + pair)


def _turns(kernels: dict, order: tuple, x, chain: int, reps: int) -> dict:
    """Each kernel's (median, std) seconds per apply in each of its turns,
    the kernels run in `order`."""
    times = {name: [] for name in kernels}
    for name in order:
        times[name].append(time_apply(lambda _, __, k=kernels[name]: k(),
                                      None, x, chain=chain, reps=reps))
    return times


def _report(label: str, form: str, ys: dict, plain, times: dict,
            nbytes: int, cuda: bool) -> None:
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    for name in ys:
        ms = [t[0] * 1e3 for t in times[name]]
        rate = (f", {nbytes / min(ms) / 1e9:.4f} TB/s over {nbytes:,} B, "
                f"{bound / min(ms):.1%} of the bound {bound:.4f} ms"
                if cuda else "")
        print(f"{label} {form:6s} {name:8s}: "
              + " / ".join(f"{m:.4f}" for m in ms)
              + f" ms per apply{rate}; vs plain rel-l2 "
              f"{rel_l2(ys[name], plain):.3e}", flush=True)


def compare_extruded(disc: Discretization, dev, chain: int = 20,
                     reps: int = 5, label: str = "#6") -> dict:
    """#6 on the extruded mesh of `disc`: the class-launch kernel against
    the stack kernel, single and pair, in turns; then the stack kernel
    under other schedules than its model's.  Returns by form the operator,
    fields, outputs, plain output, turns and least bytes."""
    mesh = disc.mesh
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, dtype=F32, device=dev)
    c1 = rng.uniform(0.5, 2.0, mesh.num_cells)
    c2 = rng.uniform(-2.0, 2.0, mesh.num_cells)
    x1 = t(rng.standard_normal(mesh.ndofs))
    x2 = t(rng.standard_normal(mesh.ndofs))
    cuda = dev.type == "cuda"
    out = {}
    for form, kw, xs in (("single", {}, (x1,)),
                         ("pair", {"pair": (c1, c2)}, (x1, x2))):
        op = disc.stiffness_op(F32, dev, **kw)
        if form == "single":
            kern = {"classes": lambda: ce.extruded_classes(op, x1),
                    "stack": lambda: ce.extruded(op, x1)}
            plain = ce.extruded_plain(op, x1)
        else:
            kern = {"classes": lambda: ce.extruded_classes_pair(op, x1, x2),
                    "stack": lambda: ce.extruded_pair(op, x1, x2)}
            plain = ce.extruded_pair_plain(op, x1, x2)
        ys = {name: k() for name, k in kern.items()}
        times = _turns(kern, ("classes", "stack", "stack", "classes"), x1,
                       chain, reps)
        nbytes = least_bytes(op.G, mesh.ndofs, len(xs), op.rows.numel() * 4)
        _report(label, form, ys, plain, times, nbytes, cuda)
        print(f"{label} {form:6s} stack vs classes rel-l2 "
              f"{rel_l2(ys['stack'], ys['classes']):.3e}", flush=True)
        out[form] = dict(op=op, xs=xs, ys=ys, plain=plain, times=times,
                         nbytes=nbytes)
        if not cuda:
            continue
        s = ce.card_schedule(op, x1, form == "pair")
        print(f"{label} {form:6s} schedule: {s.cpb} cells a chunk "
              f"({(op.P + 1) ** 2 * s.cpb} threads), {s.segments} "
              f"segment(s) a stack, {s.stages} stages of "
              f"{s.stage_bytes:,} B, {s.smem:,} B shared a block, "
              f"{s.blocks_per_sm} blocks an SM, {s.blocks} blocks, "
              f"{len(s.classes)} classes of {s.classes[:, 1].tolist()} "
              f"segments, {len(s.chunks)} chunks", flush=True)
        if form == "single":
            others = [dict(segments=g) for g in (2, 4, 8)
                      if g != s.segments] + \
                [dict(cpb=c, segments=1) for c in (3, 5) if c != s.cpb]
            for o in others:
                ms = time_apply(lambda _, __, o=o: ce.extruded(op, x1, **o),
                                None, x1, chain=chain, reps=reps)[0] * 1e3
                so = op.plan.card(op.P, F32, False, dev, o.get("segments"),
                                  o.get("cpb"))[0]
                print(f"{label} single other schedule {o}: {ms:.4f} ms "
                      f"({so.cpb} cells a chunk, {so.segments} segments, "
                      f"{so.blocks_per_sm} blocks an SM, "
                      f"{len(so.classes)} classes)", flush=True)
    return out


def compare_indexed(disc: Discretization, dev, chain: int = 20,
                    reps: int = 5, label: str = "#11", pair: bool = True,
                    others: tuple = (5, 8)) -> dict:
    """#11 on the general mesh of `disc`: the class-launch kernel against
    the chunk kernel and the composed engine, single (and pair), in turns
    (classes, chunks, engine, engine, chunks, classes); then the chunk
    kernel with other cells a chunk (`others`) than its model's."""
    mesh = disc.mesh
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, dtype=F32, device=dev)
    c1 = rng.uniform(0.5, 2.0, mesh.num_cells)
    c2 = rng.uniform(-2.0, 2.0, mesh.num_cells)
    x1 = t(rng.standard_normal(mesh.ndofs))
    x2 = t(rng.standard_normal(mesh.ndofs))
    cuda = dev.type == "cuda"
    out = {}
    forms = [("single", {}, (x1,))]
    if pair:
        forms.append(("pair", {"pair": (c1, c2)}, (x1, x2)))
    for form, kw, xs in forms:
        op = disc.stiffness_op(F32, dev, **kw)
        eop = cen.build(mesh, disc._G_host, disc._D_host, F32, dev, **kw)
        if form == "single":
            kern = {"classes": lambda: ci.indexed_classes(op, x1),
                    "chunks": lambda: ci.indexed(op, x1),
                    "engine": lambda: cen.engine(eop, x1)}
            plain = ci.indexed_plain(op, x1)
        else:
            kern = {"classes": lambda: ci.indexed_classes_pair(op, x1, x2),
                    "chunks": lambda: ci.indexed_pair(op, x1, x2),
                    "engine": lambda: cen.engine_pair(eop, x1, x2)}
            plain = ci.indexed_pair_plain(op, x1, x2)
        ys = {name: k() for name, k in kern.items()}
        times = _turns(kern, ("classes", "chunks", "engine", "engine",
                              "chunks", "classes"), x1, chain, reps)
        nbytes = least_bytes(op.G, mesh.ndofs, len(xs),
                             op.dofmap.numel() * 4)
        _report(label, form, ys, plain, times, nbytes, cuda)
        print(f"{label} {form:6s} chunks vs classes rel-l2 "
              f"{rel_l2(ys['chunks'], ys['classes']):.3e}, vs engine "
              f"{rel_l2(ys['chunks'], ys['engine']):.3e}", flush=True)
        out[form] = dict(op=op, eop=eop, xs=xs, ys=ys, plain=plain,
                         times=times, nbytes=nbytes)
        del eop
        if not cuda:
            continue
        s = ci.card_schedule(op, x1, form == "pair")
        own = chunk_bytes(op, s, len(xs))
        print(f"{label} {form:6s} schedule: {s.cpb} cells a chunk "
              f"({(op.P + 1) ** 2 * s.cpb} threads), {s.stages} stages of "
              f"{s.stage_bytes:,} B, {s.smem:,} B shared a block (at most "
              f"{s.maxu} unique dofs a chunk), {s.blocks_per_sm} blocks an "
              f"SM, {s.blocks} blocks, {len(s.classes)} classes of "
              f"{int(s.classes[:, 1].min())}-{int(s.classes[:, 1].max())} "
              f"chunks ({len(s.chunks)} in all); the layout's own bytes "
              f"{own:,} (the minimum {nbytes:,})", flush=True)
        out[form]["layout_bytes"] = own
        if form == "single":
            for c in others:
                if c == s.cpb:
                    continue
                ms = time_apply(lambda _, __, c=c: ci.indexed(op, x1, c),
                                None, x1, chain=chain, reps=reps)[0] * 1e3
                so = op.plan.card(op.P, F32, False, dev, c)[0]
                print(f"{label} single with {c} cells a chunk: {ms:.4f} ms "
                      f"({so.blocks_per_sm} blocks an SM, "
                      f"{len(so.classes)} classes)", flush=True)
    return out


def compare_corner(op: cc.CornerCellStiffness, xs: tuple, ndofs: int,
                   label: str, chain: int = 20, reps: int = 5) -> dict:
    """The class-launch corner design against the walk on `op` (a box or
    extruded corner operator) and the field(s) `xs`, in turns (classes,
    walk, walk, classes); prints each one's ms per apply, its share of the
    bound and its launches an apply, the two against each other and the
    plain version, and the walk's schedule.  Returns the fields, outputs,
    plain output, turns, least bytes and operations."""
    pair, x = len(xs) == 2, xs[0]
    if op.box:
        kern = {"classes": cc.corner_classes_pair if pair
                else cc.corner_classes,
                "walk": cc.corner_pair if pair else cc.corner}
    else:
        kern = {"classes": cc.extruded_corner_classes_pair if pair
                else cc.extruded_corner_classes,
                "walk": cc.extruded_corner_pair if pair
                else cc.extruded_corner}
    plain = (cc.corner_pair_plain if pair else cc.corner_plain)(op, *xs)
    ys = {name: k(op, *xs) for name, k in kern.items()}
    times = _turns({name: lambda k=k: k(op, *xs)
                    for name, k in kern.items()},
                   ("classes", "walk", "walk", "classes"), x, chain, reps)
    index = op.rows.numel() * 4 if op.rows is not None else 0
    nbytes, flops = cc.apply_cost(op, ndofs, len(xs), index)
    bound = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S) * 1e3
    cuda = x.device.type == "cuda"
    form = "pair" if pair else "single"
    per = {"classes": 8 if op.box else sum(
        1 for a, b in zip(op.bounds, op.bounds[1:]) if b > a)}
    if cuda:
        s = cc.card_schedule(op, x, pair)
        per["walk"] = len(s.classes)
    for name in kern:
        ms = [t[0] * 1e3 for t in times[name]]
        rate = (f", {bound / min(ms):.1%} of the bound {bound:.4f} ms, "
                f"{per[name]} launches an apply" if cuda else "")
        print(f"{label} {form:6s} {name:8s}: "
              + " / ".join(f"{m:.4f}" for m in ms)
              + f" ms per apply{rate}; vs plain rel-l2 "
              f"{rel_l2(ys[name], plain):.3e}", flush=True)
    speed = min(t[0] for t in times["classes"]) / \
        min(t[0] for t in times["walk"])
    print(f"{label} {form:6s} walk vs classes rel-l2 "
          f"{rel_l2(ys['walk'], ys['classes']):.3e}"
          + (f", {speed:.4f}x faster" if cuda else ""), flush=True)
    if cuda:
        segs = (f", {s.segments} segment(s) a stack"
                if hasattr(s, "segments") else "")
        print(f"{label} {form:6s} walk schedule: {s.cpb} cells a chunk "
              f"({(op.P + 1) ** 2 * s.cpb} threads){segs}, {s.stages} "
              f"stages of {s.stage_bytes:,} B, {s.smem:,} B shared a "
              f"block, {s.blocks_per_sm} blocks an SM, {s.blocks} blocks, "
              f"{len(s.classes)} classes, {len(s.chunks)} chunks",
              flush=True)
    return dict(op=op, xs=xs, ys=ys, plain=plain, times=times,
                nbytes=nbytes, flops=flops)


def corner_forms(disc: Discretization, dev, label: str, chain: int = 20,
                 reps: int = 5) -> dict:
    """`compare_corner` on the corner operator of `disc`'s mesh, single
    (a per-cell coefficient) and pair, with seeded fields."""
    mesh = disc.mesh
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, dtype=F32, device=dev)
    shape = mesh.nc if hasattr(mesh, "nc") else (mesh.num_cells,)
    c1 = rng.uniform(0.5, 2.0, shape)
    c2 = rng.uniform(-2.0, 2.0, shape)
    x1 = t(rng.standard_normal(mesh.grid_shape))
    x2 = t(rng.standard_normal(mesh.grid_shape))
    return {form: compare_corner(disc.stiffness_op(F32, dev, corner=True,
                                                   **kw), xs, mesh.ndofs,
                                 label, chain, reps)
            for form, kw, xs in (("single", {"coeff": c1}, (x1,)),
                                 ("pair", {"pair": (c1, c2)}, (x1, x2)))}


def _corner_fns(op: cc.CornerCellStiffness, pair: bool) -> dict:
    """The first bfloat16 corner walk (the comparison) and the main path's
    wrapper of `op`'s form."""
    if op.box:
        return {"first": cc.corner_pair_first if pair else cc.corner_first,
                "lean": cc.corner_pair if pair else cc.corner}
    return {"first": cc.extruded_corner_pair_first if pair
            else cc.extruded_corner_first,
            "lean": cc.extruded_corner_pair if pair else cc.extruded_corner}


def compare_corner_bf16(op: cc.CornerCellStiffness, xs: tuple, ndofs: int,
                        label: str, chain: int = 20, reps: int = 5,
                        rounds: int = 1):
    """The first bfloat16 corner walk against the lean corner walk (the
    main path where ``cuda_corner.lean_runs``) on the bfloat16 corner
    operator `op` and field(s) `xs` (two: the pair form), in `rounds`
    rounds of turns (first, lean, lean, first): ms of each turn and its
    share of the bound (the
    larger of the least bytes at 3.35 TB/s and the operations at 67
    TFLOP/s, ``cuda_corner.apply_cost``), the values that differ between
    the two (each on its own schedule, which is the first design's), both
    against the plain version, each design's blocks an SM, and whether the
    lean walk's slowest turn beats the first design's fastest (a gain
    larger than the turns' spread).  None where the form keeps the first
    design (nothing to compare).  Returns {"first": [ms], "lean": [ms],
    "differ", "rel_l2", "bound_ms"}."""
    pair, x = len(xs) == 2, xs[0]
    form = "pair" if pair else "single"
    if not cc.lean_runs(op, pair, x.dtype):
        print(f"{label} {form:6s} P={op.P}: the first bfloat16 corner walk "
              "runs here (cuda_corner.LEAN_CORNER_BF16)", flush=True)
        return None
    fns = _corner_fns(op, pair)
    plain = (cc.corner_pair_plain if pair else cc.corner_plain)(op, *xs)
    ys = {k: f(op, *xs) for k, f in fns.items()}
    times = _turns({k: lambda f=f: f(op, *xs) for k, f in fns.items()},
                   ("first", "lean", "lean", "first") * rounds, x, chain,
                   reps)
    index = op.rows.numel() * 4 if op.rows is not None else 0
    nbytes, flops = cc.apply_cost(op, ndofs, len(xs), index)
    bound = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S) * 1e3
    cuda = x.device.type == "cuda"
    ms = {k: [t[0] * 1e3 for t in times[k]] for k in fns}
    for k in fns:
        sched = ""
        if cuda:
            s = cc.card_schedule(op, x, pair, design=k)
            segs = (f", {s.segments} segments a stack"
                    if hasattr(s, "segments") else "")
            sched = (f"; {s.cpb} cells a chunk{segs}, {s.smem:,} B shared, "
                     f"{s.blocks_per_sm} blocks an SM, {s.blocks} blocks")
        share = f", {bound / min(ms[k]):.1%} of the bound {bound:.4f} ms" \
            if cuda else ""
        print(f"{label} {form:6s} P={op.P} bf16 {k:5s}: "
              + " / ".join(f"{m:.4f}" for m in ms[k])
              + f" ms per apply{share}; vs plain rel-l2 "
              f"{rel_l2(ys[k], plain):.3e}{sched}", flush=True)
    differ = int((ys["lean"] != ys["first"]).sum())
    err = rel_l2(ys["lean"], ys["first"])
    print(f"{label} {form:6s} P={op.P} bf16 lean vs first: {differ} of "
          f"{x.numel() if op.box else ndofs} values differ, rel-l2 "
          f"{err:.3e}" + (
              f"; first / lean {min(ms['first']) / min(ms['lean']):.4f}; "
              f"turns first {min(ms['first']):.4f}-{max(ms['first']):.4f}, "
              f"lean {min(ms['lean']):.4f}-{max(ms['lean']):.4f}: lean "
              + ("faster in every turn" if max(ms["lean"]) < min(ms["first"])
                 else "not faster in every turn")
              if cuda else ""), flush=True)
    return dict(**ms, differ=differ, rel_l2=err, bound_ms=bound)


def corner_forms_bf16(disc: Discretization, dev, label: str,
                      chain: int = 20, reps: int = 5,
                      rounds: int = 1) -> dict:
    """`compare_corner_bf16` on the bfloat16 corner operator of `disc`'s
    mesh, single (a per-cell coefficient) and pair, with seeded fields."""
    mesh = disc.mesh
    rng = np.random.default_rng(0)
    shape = mesh.nc if hasattr(mesh, "nc") else (mesh.num_cells,)
    c1 = rng.uniform(0.5, 2.0, shape)
    c2 = rng.uniform(-2.0, 2.0, shape)
    xs = [torch.as_tensor(rng.standard_normal(mesh.grid_shape),
                          device=dev).to(torch.bfloat16) for _ in range(2)]
    return {form: compare_corner_bf16(
        disc.stiffness_op(torch.bfloat16, dev, corner=True, **kw),
        tuple(xs[:n]), mesh.ndofs, label, chain, reps, rounds)
        for form, kw, n in (("single", {"coeff": c1}, 1),
                            ("pair", {"pair": (c1, c2)}, 2))}


def corner_degrees_bf16(degrees, dev, geometries=("box", "hex8", "hex27"),
                        chain: int = 20, reps: int = 3,
                        rounds: int = 1) -> dict:
    """`corner_forms_bf16` at each degree P of `degrees` on the flagship's
    grid, (256 / P, 160 / P, 160 / P) cells rounded (64 x 40 x 40 at
    P = 4): a perturbed box on box pencils, and the box read as a general
    mesh and extruded back into stacks (hex8), and its curved hex27
    lattice (hex27).  Returns {(geometry, P): {"single": ..., "pair":
    ...}}."""
    from fustpu_torch.mesh.box import build_box_mesh
    from fustpu_torch.mesh.extruded import as_extruded
    from fustpu_torch.mesh.unstructured import from_box

    out = {}
    for P in degrees:
        nc = (round(256 / P), round(160 / P), round(160 / P))
        for geo in geometries:
            if geo == "box":
                mesh = build_box_mesh(nc, P, perturb=0.1, seed=P)
            elif geo == "hex8":
                mesh = as_extruded(from_box(build_box_mesh(nc, P),
                                            shuffle_seed=11))
            else:
                mesh = as_extruded(shapes.hex27_lattice(
                    from_box(build_box_mesh(nc, P), shuffle_seed=11),
                    shapes.curved_prism_map))
            print(f"P={P} {geo}: {nc} cells, {mesh.ndofs} DOF, bf16",
                  flush=True)
            out[geo, P] = corner_forms_bf16(Discretization(mesh), dev,
                                            f"#{'3' if geo == 'box' else '6c'}"
                                            f" {geo}", chain, reps, rounds)
    return out


SWEEP_CPB = (1, 2, 3, 4, 5, 6, 7, 8, 10)
SWEEP_SEGMENTS = (1, 2, 3, 4, 6, 8, 16, 43)


def sweep(disc: Discretization, dev, chain: int = 20, reps: int = 3,
          corner: bool = False) -> list:
    """The single-field new kernel of `disc`'s mesh (the stack kernel on an
    extruded mesh, the chunk kernel on any other; with `corner` the corner
    stack walk) timed under every schedule of the sweep's grid that fits;
    prints and returns (cells a chunk, segments or None, blocks an SM,
    classes, model cost or None, ms) for each."""
    mesh, out = disc.mesh, []
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        mesh.ndofs), dtype=F32, device=dev)
    op = disc.stiffness_op(F32, dev, corner=corner)
    stacks = isinstance(op, (ce.ExtrudedCellStiffness,
                             cc.CornerCellStiffness))
    geo = op.geom_deg if corner else 0
    cell_bytes = cs.cell_values(op.P, cs.corner_channels(geo) if geo
                                else 0) * 4
    for cpb in SWEEP_CPB:
        for seg in SWEEP_SEGMENTS if stacks else (None,):
            try:
                if stacks:
                    s = op.plan.card(op.P, F32, False, dev, seg, cpb,
                                     geo)[0]
                    run = (lambda: cc.extruded_corner(
                        op, x, segments=seg, cpb=cpb)) if corner else \
                        (lambda: ce.extruded(op, x, segments=seg, cpb=cpb))
                    cost = ce._stack_cost(
                        np.bincount(op.plan.colour),
                        ce.segment_lengths(op.nz, seg), cpb,
                        s.blocks_per_sm, s.blocks // s.blocks_per_sm,
                        cell_bytes)
                else:
                    s = op.plan.card(op.P, F32, False, dev, cpb)[0]
                    run = lambda: ci.indexed(op, x, cpb)
                    cost = None
            except ValueError:       # no such schedule at this shape
                continue
            ms = time_apply(lambda _, __: run(), None, x, chain=chain,
                            reps=reps)[0] * 1e3
            row = (cpb, seg, s.blocks_per_sm, len(s.classes), cost, ms)
            kind = ("corner stack" if corner else
                    "stack" if stacks else "chunk")
            print(f"sweep {kind}: {cpb} cells a "
                  f"chunk, {seg} segments, {s.blocks_per_sm} blocks an SM, "
                  f"{len(s.classes)} classes, model cost {cost}: "
                  f"{ms:.4f} ms", flush=True)
            out.append(row)
    return out


def main(argv=None) -> dict:
    """Builds the imported and bodyfit bowls (and the P = 6 bodyfit bowl)
    through the bowl demo and runs `compare_extruded` and
    `compare_indexed` on them; with --corner, `corner_forms` on the
    imported bowl (and its hex27 form) instead.  Returns their results by
    label."""
    args = parser().parse_args(argv)
    check_device(args)
    dev = torch.device(args.device)

    def disc(geometry, elements, degree):
        a = nonlinear_bowl.parser().parse_args(
            ["--elements", str(elements), "--degree", str(degree),
             "--geometry", geometry, "--device", args.device])
        return Discretization(nonlinear_bowl.problem(a).mesh)

    if args.corner and args.bf16 and args.degrees:
        out = {}
        if dev.type == "cuda":
            out = corner_degrees_bf16(
                args.degrees, dev, ("hex8", "hex27") if args.hex27
                else ("hex8",), args.chain, args.reps, args.rounds)
        print(f"   timed by {clock(dev)}")
        return out
    imported = disc("unstructured", args.elements, args.degree)
    if args.corner and args.bf16:
        discs = {"#6c hex8": imported}
        if args.hex27:
            discs["#6c hex27"] = Discretization(
                shapes.hex27_lattice(imported.mesh))
        out = {label: corner_forms_bf16(d, dev, label, args.chain, args.reps,
                                        args.rounds)
               for label, d in discs.items()}
        print(f"   timed by {clock(dev)}")
        return out
    if args.corner:
        discs = {"#6c hex8": imported}
        if args.hex27:
            discs["#6c hex27"] = Discretization(
                shapes.hex27_lattice(imported.mesh))
        out = {label: corner_forms(d, dev, label, args.chain, args.reps)
               for label, d in discs.items()}
        if args.sweep and dev.type == "cuda":
            out["sweep"] = {label: sweep(d, dev, corner=True)
                            for label, d in discs.items()}
        print(f"   timed by {clock(dev)}")
        return out
    bodyfit = disc("bodyfit", args.elements, args.degree)
    out = {"#6": compare_extruded(imported, dev, args.chain, args.reps),
           "#11": compare_indexed(bodyfit, dev, args.chain, args.reps)}
    if args.p6_elements:
        p6 = disc("bodyfit", args.p6_elements, 6)
        out["#11 P=6"] = compare_indexed(p6, dev, args.chain, args.reps,
                                         "#11 P=6", pair=False, others=())
    if args.sweep and dev.type == "cuda":
        out["sweep"] = {"#6": sweep(imported, dev), "#11": sweep(bodyfit, dev)}
        if args.p6_elements:
            out["sweep"]["#11 P=6"] = sweep(p6, dev)
    print(f"   timed by {clock(dev)}")
    return out


if __name__ == "__main__":
    main()
