"""Where the bfloat16 chunk kernel's time goes (#11 in bf16): copies of the
CUDA sources with one part of the first bfloat16 chunk kernel removed, and
of the lean chunk kernel without one of its changes, each built at one
degree in a temporary directory (never the package's own build) and timed
on the card in turns on the same buffers.

    python -m fustpu_torch.tools.chunk_split [--degree 4]
        [--nc 64 40 40] [--turns 2]

The mesh is a perturbed box of `--nc` cells read as a general mesh (64 x 40
x 40 at P = 4: the bodyfit bowl's 102,400 cells and 6,661,697 dofs), single
field (a per-cell coefficient in G) and pair, on the first design's
schedule (``ops/cuda_indexed.py`` `ChunkPlan.card`).  The first design's
copies (``csrc/indexed_chunk.cu``):
    full         unchanged (it must be bitwise the package's kernel);
    no_body      without the per-cell body (cell_apply, two of its five
                 barriers);
    no_build_u   without the scatter of each unique x to its positions;
    no_sum       without each unique dof's sum of its positions and its
                 store of y;
    no_xy        the next chunk's x and y loads from one address (L1 hits)
                 in place of the chunk's unique dofs;
    bookkeeping  none of build_u, sum and the x / y loads: the body, the G
                 ring and the tables alone.
The lean kernel's copies (``csrc/indexed_lean.cu``):
    lean         unchanged;
    lean flat    its class launches one after another, not overlapped
                 (no programmatic dependent launch);
    lean all-y   unchanged, given the plain inverse-map ends in place of
                 `lead_ends` (every dof reads the y that earlier classes
                 left, from a zeroed y);
    lean 128     a register cap of 128 in place of 96 (4 blocks of 4 warps
                 an SM);
    lean G late  the first chunks' G copies issued after the prologue's
                 barrier, as the first design does, not first of all;
    lean G wait  the same copies issued right after the wait for the
                 earlier class.
Each copy prints its ptxas registers and spills, ms per apply (the least
of `--turns` rounds of turns), its blocks an SM, and whether its output is
bitwise the package's first design's.  Needs nvcc and a card.
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
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.mesh.unstructured import from_box
from fustpu_torch.models.discretization import Discretization
from fustpu_torch.ops import cuda_indexed as ci
from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.tools import copies

BF16 = torch.bfloat16

# the first design's parts, as (pattern, replacement) edits of its source
_BUILD_U = (r"    build_u\(q\);\n", "")
_SUM = (r"    sum\(q\);\n", "")
_XY = [(r"xr\[e\] = x1\[id\];", "xr[e] = x1[0];"),
       (r"x2r\[e\] = x2\[id\];", "x2r[e] = x2[0];"),
       (r"yr\[e\] = y\[id\];", "yr[e] = y[0];")]
FIRST = {
    "full": [],
    "no_body": [(r"    cell_apply<T, N, false, STAGED_STORE>\(.*?"
                 r"NoLine\{\}\);\n", "")],
    "no_build_u": [_BUILD_U],
    "no_sum": [_SUM],
    "no_xy": _XY,
    "bookkeeping": [_BUILD_U, _SUM, *_XY],
}


def variants(P: int) -> dict:
    """{name: (source file, edited text)} of every copy at degree P."""
    first = copies.at_degree(
        (_build.CSRC / "indexed_chunk.cu").read_text(), P,
        ["FUSTPU_DEGREES"])
    lean = copies.at_degree(
        (_build.CSRC / "indexed_lean.cu").read_text(), P,
        ["FUSTPU_LEAN_CHUNK_SINGLE", "FUSTPU_LEAN_CHUNK_PAIR"])
    out = {}
    for name, edits in FIRST.items():
        text = first
        for a, b in edits:
            text, k = re.subn(a, b, text, flags=re.S)
            assert k == 1, (name, a, k)
        out[f"first {name}"] = ("indexed_chunk.cu", text)
    out["lean"] = ("indexed_lean.cu", lean)
    text, k = re.subn(r"cfg\.numAttrs = after \? 1 : 0;", "cfg.numAttrs = 0;",
                      lean)
    assert k == 1
    out["lean flat"] = ("indexed_lean.cu", text)
    text, k = re.subn(r"#define FUSTPU_LEAN_CHUNK_MAXREG \d+",
                      "#define FUSTPU_LEAN_CHUNK_MAXREG 128", lean)
    assert k == 1
    out["lean 128"] = ("indexed_lean.cu", text)
    first_g = ("    for (int q = 0; q < min(STAGES, mine); ++q) "
               "issue(q, table(q));\n")
    issue_g = ("if (tid == 0) for (int g = 0; g < min(STAGES, mine); ++g) "
               "issue(g, table(g));")
    for name, at, put in (
            ("lean G late", "  put(0, table(0));\n  __syncthreads();",
             "  put(0, table(0));\n  __syncthreads();\n  " + issue_g),
            ("lean G wait",
             '    if (gate) asm volatile("griddepcontrol.wait;" ::: '
             '"memory");',
             '    if (gate) {\n      asm volatile("griddepcontrol.wait;" '
             '::: "memory");\n      ' + issue_g + "\n    }")):
        assert lean.count(first_g) == 1 and lean.count(at) == 1, name
        out[name] = ("indexed_lean.cu",
                     lean.replace(first_g, "").replace(at, put))
    return out


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    chunk = [p, p, p, p, p, i, i, i, i, i, i, p]
    for name, args in (("fustpu_indexed_chunk_bf16", [p, p, p, p, i, *chunk]),
                       ("fustpu_indexed_chunk_pair_bf16",
                        [p, p, p, p, p, p, i, *chunk]),
                       ("fustpu_indexed_lean_bf16", [p, p, p, p, i, *chunk]),
                       ("fustpu_indexed_lean_pair_bf16",
                        [p, p, p, p, p, p, i, *chunk]),
                       ("fustpu_indexed_lean_occupancy", [i, i, i, i])):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = i


def run(P: int, nc, turns: int = 2) -> dict:
    """Builds and times every copy, single and pair; returns {(form,
    name): {"ms": [...], "registers", "spills", "blocks_per_sm"}}."""
    dev = torch.device("cuda")
    mesh = from_box(build_box_mesh(tuple(nc), P, perturb=0.1, seed=0))
    disc = Discretization(mesh)
    rng = np.random.default_rng(0)
    c1 = rng.uniform(0.5, 2.0, mesh.num_cells)
    c2 = rng.uniform(-1.5, -0.5, mesh.num_cells)
    xs = [torch.as_tensor(rng.standard_normal(mesh.ndofs), device=dev).to(
        BF16) for _ in range(2)]
    with tempfile.TemporaryDirectory() as tmp:
        libs = copies.build({n: (s, {s: text}, []) for n, (s, text)
                             in variants(P).items()}, Path(tmp))
        libs["lean all-y"] = libs["lean"]
        out = {}
        for pair in (False, True):
            form = "pair" if pair else "single"
            op = disc.stiffness_op(BF16, dev, **(
                {"pair": (c1, c2)} if pair else {"coeff": c1}))
            sched, chunks, uniq, ends, pos, classes = op.plan.card(
                P, BF16, pair, dev)
            lead_ends = torch.as_tensor(op.plan.tables(sched.cpb).lead_ends,
                                        device=dev)
            stage, smem = sched.stage_bytes, sched.smem
            a = xs[:1 + pair]
            extra = (op.C.data_ptr(),) if pair else ()
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            calls, rows = {}, {}
            for name, (lib, res) in libs.items():
                _declare(lib)
                lean = name.startswith("lean")
                kname = "lean_chunk_kernel" if lean else "chunk_kernel"
                r = [x for x in res if kname in x["mangled"] and
                     ("Lb1E" in x["mangled"]) == pair and
                     (lean or "bfloat16" in x["mangled"] or
                      "13__nv_bfloat16" in x["mangled"])]
                bps = sched.blocks_per_sm
                if lean:
                    bps = lib.fustpu_indexed_lean_occupancy(P, int(pair),
                                                            sched.cpb, smem)
                    if bps < 1:
                        print(f"{form:6s} {name:24s} does not fit the "
                              f"schedule's block ({bps})", flush=True)
                        continue
                rows[name] = dict(ms=[], blocks_per_sm=bps,
                                  registers=r[0]["registers"] if r else None,
                                  spills=(r[0]["spill_stores"],
                                          r[0]["spill_loads"]) if r else None)

                def call(lib=lib, lean=lean, bps=bps,
                         ends_=ends if name == "lean all-y" or not lean
                         else lead_ends):
                    y = torch.zeros_like(a[0])
                    stream = torch.cuda.current_stream(dev).cuda_stream
                    if lean:
                        fn = getattr(lib, "fustpu_indexed_lean"
                                     f"{'_pair' if pair else ''}_bf16")
                        err = fn(*(t.data_ptr() for t in a), *extra,
                                 op.G.data_ptr(), cs.host_D(op.D),
                                 y.data_ptr(), P, chunks.data_ptr(),
                                 uniq.data_ptr(), ends_.data_ptr(),
                                 pos.data_ptr(), classes,
                                 len(sched.classes), bps * sms, sched.cpb,
                                 stage, smem, sched.maxu, stream)
                    else:
                        fn = getattr(lib, "fustpu_indexed_chunk"
                                     f"{'_pair' if pair else ''}_bf16")
                        err = fn(*(t.data_ptr() for t in a), *extra,
                                 op.G.data_ptr(), op.D.data_ptr(),
                                 y.data_ptr(), P, chunks.data_ptr(),
                                 uniq.data_ptr(), ends.data_ptr(),
                                 pos.data_ptr(), classes, len(sched.classes),
                                 sched.blocks, sched.cpb, sched.stage_bytes,
                                 sched.smem, sched.maxu, stream)
                    if err != 0:
                        raise RuntimeError(f"{name}: launch failed, {err}")
                    return y

                calls[name] = call
            ref = (ci.indexed_pair_first if pair else ci.indexed_first)(op,
                                                                        *a)
            same = {n: torch.equal(c(), ref) for n, c in calls.items()
                    if n == "first full" or n.startswith("lean")}
            names = list(calls)
            for _ in range(turns):
                for n in names + names[::-1]:
                    rows[n]["ms"].append(copies.ms_per_call(calls[n]))
            print(f"P={P} {form}: the first design's schedule {sched.cpb} "
                  f"cells a chunk, {len(sched.classes)} classes of "
                  f"{len(sched.chunks)} chunks, maxu {sched.maxu}, "
                  f"{sched.smem} B ({smem} B lean), "
                  f"{sched.blocks_per_sm} blocks an SM; bitwise the "
                  f"package's first design: {same}", flush=True)
            for n in names:
                rw = rows[n]
                print(f"   {form:6s} {n:24s} " + " ".join(
                    f"{t:.4f}" for t in rw["ms"]) + f"  least "
                    f"{min(rw['ms']):.4f} ms; {rw['registers']} registers, "
                    f"spills {rw['spills']}, {rw['blocks_per_sm']} blocks an "
                    "SM", flush=True)
                out[form, n] = rw
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--degree", type=int, default=4)
    p.add_argument("--nc", type=int, nargs=3, default=[64, 40, 40])
    p.add_argument("--turns", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chunk_split times CUDA kernels: no card here")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; CUDA events", flush=True)
    return run(args.degree, args.nc, args.turns)


if __name__ == "__main__":
    main()
