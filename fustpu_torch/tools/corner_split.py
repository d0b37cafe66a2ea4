"""Where the bfloat16 corner walk's time goes (#3 and #6c in bf16, the
capacity mode): copies of the CUDA sources with one part of the first
bfloat16 corner walk removed, and of the lean corner walk with one of its
choices changed, each built at one degree in a temporary directory (never
the package's own build) and timed on the card in turns on the same
buffers.

    python -m fustpu_torch.tools.corner_split [--degree 4]
        [--nc 64 40 40] [--elements 64] [--forms box hex8 hex27]
        [--variants first "lean no_dreg+minb=111414" ...] [--turns 2]

The operators: a perturbed box of `--nc` cells (64 x 40 x 40 at P = 4: the
flagship's 102,400 cells and 6,661,697 dofs) on box pencils (#3), and the
imported bowl of the bowl demo at `--elements` (1,600 stacks of 64 layers
at 64, the same dofs) as hex8 and as hex27 stacks (#6c); single field (a
per-cell coefficient) and pair, each on the first design's schedule
(``ops/cuda_corner.py`` `_card`).  The first design's copies
(``csrc/corner_pencil.cu``, ``corner_stack.cu``, ``corner_stack27.cu``):
    first            unchanged (it must be bitwise the package's kernel);
    first no_fold    the channel fold without its channels: each J[p][q]
                     from the line's powers alone (constant coefficients a
                     line, so the fold leaves the chunk loop);
    first unit       the per-node metric replaced by a unit metric, f =
                     w_i s w, with every folded channel kept alive in s;
    first no_D       D's shared loads replaced by a constant (the same
                     FMAs, no load);
    first no_xy      the next chunk's x and y loads from one address (L1
                     hits) in place of its nodes'.
The lean walk's copies (``csrc/corner_lean*.cu``), "lean" and any of
these changes joined by "+", each a row of ``corner_lean.cuh``'s PlanP4
(the plan of every form at P = 4) set for every form:
    lean             unchanged (the main path's, where LEAN_CORNER_BF16
                     routes a form);
    no_dreg          D's rows and columns from a shared copy, not registers;
    dreg             D's rows and columns in registers;
    no_wide          the channels folded from the bf16 stage, not widened;
    wide             the channels widened;
    minb=M           the launch bounds' blocks an SM set to the digits M, one
                     a form in PlanP4's order: box, pair, hex8, pair, hex27,
                     pair (e.g. "lean no_dreg+minb=414111").
Each copy prints its ptxas registers and spills, ms per apply (the least
of `--turns` rounds of turns), its blocks an SM, and how many values
differ from the package's first design's output on the same schedule.
Needs nvcc and a card.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from fustpu_torch import _build
from fustpu_torch.ops import cuda_corner as cc
from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.tools import copies

BF16 = torch.bfloat16

# each form's sources: the first design's and the lean walk's
SOURCES = {"box": ("corner_pencil.cu", "corner_lean.cu"),
           "hex8": ("corner_stack.cu", "corner_lean_stack.cu"),
           "hex27": ("corner_stack27.cu", "corner_lean_stack27.cu")}

# the first design's parts, as (file, pattern, replacement) edits
_FOLD = [("corner.cuh",
          r"acc \+= widen<T>\(ch\[corner_channel<GD, BOX>\(q, p, mx, my,\s*"
          r"mz\)\]\) \*\s*pw\.yz\[my\]\[mz\];",
          "acc += pw.yz[my][mz];"),
         ("corner.cuh",
          r"s = widen<T>\(ch\[CornerChannels<GD>::NCH\]\) \* wq\[j\] \* "
          r"wq\[k\];", "s = wq[j] * wq[k];")]
_UNIT = [("corner.cuh",
          r"(s = widen<T>\(ch\[CornerChannels<GD>::NCH\]\) \* wq\[j\] \* "
          r"wq\[k\];)",
          r"\1\n    for (int q = 0; q < 3; ++q)\n"
          r"      for (int p = 0; p < 3; ++p)\n"
          r"        for (int m = 0; m <= GD; ++m) s += c[q][p][m] * T(1e-30);"),
         ("corner.cuh",
          r"    const T x = xq\[i\];.*?f2 = scale \* \(a20 \* t0 \+ a21 \* t1 "
          r"\+ a22 \* t2\);",
          "    f0 = wq[i] * s * wx;\n    f1 = wq[i] * s * wy;\n"
          "    f2 = wq[i] * s * wz;")]
_D = [("sum_factor.cuh", r"Ds\[[ijkr] \* N \+ [ijkr]\]", "T(0.5)")]
_XY = [("stiffness_pencil.cuh", r"xr\[e\] = x1\[g\];", "xr[e] = x1[0];"),
       ("stiffness_pencil.cuh", r"x2r\[e\] = x2\[g\];", "x2r[e] = x2[0];"),
       ("stiffness_pencil.cuh", r"yr\[e\] = y\[g\];", "yr[e] = y[0];")]
FIRST = {"first": [], "first no_fold": _FOLD, "first unit": _UNIT,
         "first no_D": _D, "first no_xy": _XY}
# the changes of a lean copy: the PlanP4 row each sets
ROWS = {"dreg": "DREG", "wide": "WIDE", "minb": "MINB"}


def lean_plan(name: str) -> str:
    """``corner_lean.cuh`` of the lean copy `name` ("lean", or "lean " and
    changes joined by "+"), with PlanP4's rows set as they say."""
    text = (_build.CSRC / "corner_lean.cuh").read_text()
    changes = name.removeprefix("lean").strip()
    for c in filter(None, changes.split("+")):
        key, _, value = c.partition("=")
        row = ROWS[key.removeprefix("no_")]
        values = ([int(d) for d in value] if row == "MINB"
                  else [str(not key.startswith("no_")).lower()] * 6)
        if len(values) != 6:
            raise ValueError(f"corner_split: {c!r} sets {len(values)} forms")
        kind = "int" if row == "MINB" else "bool"
        text, k = re.subn(
            rf"(static constexpr {kind} {row}\[6\] = )\{{[^}}]*\}};",
            rf"\g<1>{{{', '.join(map(str, values))}}};", text)
        assert k == 1, row
    return text


def variants(P: int, forms, names) -> dict:
    """{(form, name): (source, {file: text}, nvcc flags)} of every copy at
    degree P."""
    out = {}
    csrc = _build.CSRC
    for form in forms:
        first, lean = SOURCES[form]
        for name in names:
            if name in FIRST:
                texts = {f: (csrc / f).read_text() for f in
                         ("corner.cuh", "sum_factor.cuh",
                          "stiffness_pencil.cuh")}
                for f, a, b in FIRST[name]:
                    texts[f], k = re.subn(a, b, texts[f], flags=re.S)
                    assert k >= 1, (name, a)
                texts[first] = copies.at_degree((csrc / first).read_text(),
                                                P)
                # the degree list of the walk's launchers
                texts["stiffness_pencil.cuh"] = copies.at_degree(
                    texts["stiffness_pencil.cuh"], P, ["FUSTPU_DEGREES"])
                out[form, name] = (first, texts, [])
            elif name.startswith("lean"):
                texts = {lean: copies.at_degree((csrc / lean).read_text(), P),
                         "corner_lean.cuh": lean_plan(name)}
                out[form, name] = (lean, texts, [])
            else:
                raise ValueError(f"corner_split: no copy {name!r}")
    return out


def _declare(lib, kind: str) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    tail = ([p, p, i, i, i, i, i, i, i, i, p] if kind == "corner_pencil"
            else [p, p, p, i, i, i, i, i, i, i, p])
    for name, args in ((f"fustpu_{kind}_bf16", [p, p, p, p, p, i, *tail]),
                       (f"fustpu_{kind}_pair_bf16",
                        [p, p, p, p, p, p, p, i, *tail]),
                       (f"fustpu_{kind}_lean_bf16",
                        [p, p, p, p, p, i, *tail]),
                       (f"fustpu_{kind}_pair_lean_bf16",
                        [p, p, p, p, p, p, p, i, *tail]),
                       (f"fustpu_{kind}_lean_occupancy", [i, i, i, i])):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = i


def _is_form(mangled: str, lean: bool, pair: bool) -> bool:
    """Whether a kernel's mangled name is the bfloat16 walk of the design
    (`lean` or the first) and form (`pair` or not): the first design's
    corner_kernel / pencil_kernel<float, N, PAIR, ...> with bfloat16
    storage, the lean walk's lean_corner_kernel<N, GD, BOX, PAIR, ...>."""
    if lean:
        m = re.search(r"lean_corner_kernelILi\d+ELi\d+ELb[01]ELb([01])E",
                      mangled)
    else:
        m = re.search(r"(?:corner|pencil)_kernelIfLi\d+ELb([01])E", mangled)
        if "bfloat16" not in mangled:
            return False
    return bool(m) and m.group(1) == ("1" if pair else "0")


def operators(forms, nc, elements: int, P: int, dev) -> dict:
    """{form: (mesh, Discretization)} of the box and the imported bowl
    (hex8, and its hex27 lattice)."""
    from fustpu_torch.demos import nonlinear_bowl
    from fustpu_torch.mesh import shapes
    from fustpu_torch.mesh.box import build_box_mesh
    from fustpu_torch.models.discretization import Discretization

    out = {}
    if "box" in forms:
        out["box"] = Discretization(build_box_mesh(tuple(nc), P, perturb=0.1,
                                                   seed=0))
    if "hex8" in forms or "hex27" in forms:
        a = nonlinear_bowl.parser().parse_args(
            ["--elements", str(elements), "--degree", str(P),
             "--geometry", "unstructured"])
        imported = nonlinear_bowl.problem(a).mesh
        if "hex8" in forms:
            out["hex8"] = Discretization(imported)
        if "hex27" in forms:
            out["hex27"] = Discretization(shapes.hex27_lattice(imported))
    return out


def run(P: int, nc, elements: int, forms, names, turns: int = 2) -> dict:
    """Builds and times every copy, single and pair, on each form's
    operator; returns {(form, pair, name): {"ms": [...], "registers",
    "spills", "blocks_per_sm", "differ"}}."""
    dev = torch.device("cuda")
    discs = operators(forms, nc, elements, P, dev)
    rng = np.random.default_rng(0)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = copies.build(variants(P, forms, names), Path(tmp))
        for form, disc in discs.items():
            mesh = disc.mesh
            shape = mesh.nc if form == "box" else (mesh.num_cells,)
            c1 = rng.uniform(0.5, 2.0, shape)
            c2 = rng.uniform(-1.5, -0.5, shape)
            xs = [torch.as_tensor(rng.standard_normal(mesh.grid_shape),
                                  device=dev).to(BF16) for _ in range(2)]
            for pair in (False, True):
                op = disc.stiffness_op(BF16, dev, corner=True, **(
                    {"pair": (c1, c2)} if pair else {"coeff": c1}))
                kind = "corner_pencil" if op.box else f"{op.kernel}_stack"
                sched, chunks, ids, classes = cc._card(op, BF16, pair, dev)
                a = xs[:1 + pair]
                extra = (op.C.data_ptr(),) if pair else ()
                sms = torch.cuda.get_device_properties(
                    dev).multi_processor_count
                _, lean_smem = cc.lean_smem(op.P, sched.cpb, pair,
                                            not op.box, op.geom_deg)
                calls, rows = {}, {}
                for (f, name), (lib, res) in libs.items():
                    if f != form:
                        continue
                    _declare(lib, kind)
                    lean = name.startswith("lean")
                    r = [x for x in res if _is_form(x["mangled"], lean, pair)]
                    bps, smem = sched.blocks_per_sm, sched.smem
                    if lean:
                        smem = lean_smem
                        bps = getattr(lib, f"fustpu_{kind}_lean_occupancy")(
                            P, int(pair), sched.cpb, smem)
                        if bps < 1:
                            print(f"{form} {'pair' if pair else 'single'} "
                                  f"{name}: does not fit the first design's "
                                  f"block ({bps})", flush=True)
                            continue
                    rows[name] = dict(
                        ms=[], blocks_per_sm=bps,
                        registers=r[0]["registers"] if r else None,
                        spills=(r[0]["spill_stores"], r[0]["spill_loads"])
                        if r else None)
                    fn = getattr(lib, f"fustpu_{kind}{'_pair' if pair else ''}"
                                 f"{'_lean' if lean else ''}_bf16")
                    consts = ((cs.host_D(op.D), cs.host_D(op.Q)) if lean
                              else (op.D.data_ptr(), op.Q.data_ptr()))

                    def call(fn=fn, consts=consts, bps=bps, smem=smem,
                             name=name):
                        y = torch.zeros_like(a[0])
                        stream = torch.cuda.current_stream(dev).cuda_stream
                        args = (*(t.data_ptr() for t in a), *extra,
                                op.T.data_ptr(), *consts, y.data_ptr(), P,
                                chunks.data_ptr())
                        sched_args = (classes, len(sched.classes), bps * sms,
                                      sched.cpb, sched.stages,
                                      sched.stage_bytes, smem)
                        if op.box:
                            err = fn(*args, *sched_args, op.nc[1], op.nc[2],
                                     stream)
                        else:
                            err = fn(*args, ids.data_ptr(), *sched_args,
                                     op.nz, stream)
                        if err != 0:
                            raise RuntimeError(f"{name}: launch failed, "
                                               f"{err}")
                        return y

                    calls[name] = call
                ref = (cc.extruded_corner_pair_first if pair and not op.box
                       else cc.extruded_corner_first if not op.box
                       else cc.corner_pair_first if pair
                       else cc.corner_first)(op, *a)
                for n, c in calls.items():
                    rows[n]["differ"] = int((c() != ref).sum())
                order = list(calls)
                for _ in range(turns):
                    for n in order + order[::-1]:
                        rows[n]["ms"].append(copies.ms_per_call(calls[n]))
                label = f"{form} {'pair' if pair else 'single'}"
                segs = (f", {sched.segments} segments a stack"
                        if hasattr(sched, "segments") else "")
                print(f"P={P} {label}: the first design's schedule "
                      f"{sched.cpb} cells a chunk{segs}, "
                      f"{len(sched.classes)} classes of {len(sched.chunks)} "
                      f"chunks, {sched.smem} B ({lean_smem} B lean), "
                      f"{sched.blocks_per_sm} blocks an SM", flush=True)
                for n in order:
                    rw = rows[n]
                    print(f"   {label:12s} {n:20s} " + " ".join(
                        f"{t:.4f}" for t in rw["ms"]) + f"  least "
                        f"{min(rw['ms']):.4f} ms; {rw['registers']} "
                        f"registers, spills {rw['spills']}, "
                        f"{rw['blocks_per_sm']} blocks an SM; "
                        f"{rw['differ']} values differ from the first "
                        "design", flush=True)
                    out[form, pair, n] = rw
                del op
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--degree", type=int, default=4)
    p.add_argument("--nc", type=int, nargs=3, default=[64, 40, 40])
    p.add_argument("--elements", type=int, default=64)
    p.add_argument("--forms", nargs="+", default=list(SOURCES),
                   choices=list(SOURCES))
    p.add_argument("--variants", nargs="+",
                   default=[*FIRST, "lean", "lean no_dreg", "lean no_wide"],
                   help="names of the copies (see above)")
    p.add_argument("--turns", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("corner_split times CUDA kernels: no card here")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; CUDA events", flush=True)
    return run(args.degree, args.nc, args.elements, args.forms,
               args.variants, args.turns)


if __name__ == "__main__":
    main()
