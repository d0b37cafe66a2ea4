"""Builds the CUDA sources of ``fustpu_torch/csrc`` into a shared library
with a plain C interface, at first use, and loads it with ctypes.  One
nvcc process per source, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c -o <source>.o fustpu_torch/csrc/<source>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o fustpu_torch/_build/libfustpu_torch_<hash>.so *.o

The library's name carries a hash of the sources (headers included) and
flags, so an edited source is rebuilt and a built one is reused.  A failed
build raises.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]


# The set-up kernels' entry points (csrc/setup.cu, float64) and their
# arguments before the stream: pointers, 64-bit sizes and ints.
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
SETUP_ENTRIES = {
    "fustpu_setup_cell_geometry": [_P, _P, _P, _LL, _I, _I, _I, _P, _P],
    "fustpu_setup_facet_geometry": [_P, _P, _P, _P, _LL, _I, _I, _P],
    "fustpu_setup_box_dofmap": [_P, _LL, _I, _I, _I, _P],
    "fustpu_setup_mass_diagonal_box": [_P, _P, _I, _I, _I, _I, _P],
    "fustpu_setup_mass_diagonal_map": [_P, _P, _I, _P, _P, _LL, _P],
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _hashed() -> list[Path]:
    return sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _hashed():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfustpu_torch_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the sources unless this exact build exists.  Returns the
    library path and the seconds spent compiling (0 when reused)."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(_sources(), objs)]
        jobs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
                for cmd in cmds]
        results = [(cmd, p.communicate(), p.returncode)
                   for cmd, p in zip(cmds, jobs)]
        link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        if all(rc == 0 for _, _, rc in results):
            out = subprocess.run(link, capture_output=True, text=True)
            results.append((link, (out.stdout, out.stderr), out.returncode))
        for cmd, (so, se), rc in results:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}"
                                   f"\n{so}\n{se}")
        os.replace(tmp, lib)       # atomic: concurrent builds agree
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return lib, time.perf_counter() - t0


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C entry
    points' argument types (pointers and the stream as void*, sizes as
    int, so that ctypes never truncates a pointer)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    # the pencil kernel: its schedule after P (chunk table, classes, their
    # count, blocks, cells a chunk, stages, stage bytes, shared bytes), then
    # ncy, ncz and the stream; float32, float64 and bfloat16 (the G-stream
    # kernels #1 / #2, #6 and #11, and the corner walk below)
    sched = [p, p, i, i, i, i, i, i, i, i, p]
    gstream = ("f32", "f64", "bf16")
    for suffix in gstream:
        fn = getattr(lib, f"fustpu_stiffness_{suffix}")
        fn.argtypes = [p, p, p, p, i, *sched]
        fn.restype = i
        fn = getattr(lib, f"fustpu_stiffness_pair_{suffix}")
        fn.argtypes = [p, p, p, p, p, p, i, *sched]
        fn.restype = i
    lib.fustpu_stiffness_occupancy.argtypes = [i, i, i, i, i]
    lib.fustpu_stiffness_occupancy.restype = i
    # the bfloat16 lean walk (stiffness_lean.cu, extruded_lean.cu): the same
    # arguments, D a host array of floats; its occupancy queries take (P,
    # pair, cpb, smem)
    lib.fustpu_stiffness_lean_bf16.argtypes = [p, p, p, p, i, *sched]
    lib.fustpu_stiffness_pair_lean_bf16.argtypes = [p, p, p, p, p, p, i,
                                                    *sched]
    for name in ("fustpu_stiffness_lean_bf16",
                 "fustpu_stiffness_pair_lean_bf16",
                 "fustpu_stiffness_lean_occupancy",
                 "fustpu_extruded_stack_lean_bf16",
                 "fustpu_extruded_stack_pair_lean_bf16",
                 "fustpu_extruded_stack_lean_occupancy"):
        getattr(lib, name).restype = i
    lib.fustpu_stiffness_lean_occupancy.argtypes = [i, i, i, i]
    lib.fustpu_extruded_stack_lean_occupancy.argtypes = [i, i, i, i]
    # the stack kernel: the pencil kernel's schedule with the segments' row
    # ids after the chunk table, nz in place of ncy, ncz
    stack = [p, p, p, i, i, i, i, i, i, i, p]
    for suffix in gstream:
        fn = getattr(lib, f"fustpu_extruded_stack_{suffix}")
        fn.argtypes = [p, p, p, p, i, *stack]
        fn.restype = i
        fn = getattr(lib, f"fustpu_extruded_stack_pair_{suffix}")
        fn.argtypes = [p, p, p, p, p, p, i, *stack]
        fn.restype = i
    lib.fustpu_extruded_stack_occupancy.argtypes = [i, i, i, i, i]
    lib.fustpu_extruded_stack_occupancy.restype = i
    lib.fustpu_extruded_stack_lean_bf16.argtypes = [p, p, p, p, i, *stack]
    lib.fustpu_extruded_stack_pair_lean_bf16.argtypes = [p, p, p, p, p, p, i,
                                                         *stack]
    # the chunked indexed kernel: its chunk table, unique ids, ends and
    # positions, classes, their count, blocks, cells a chunk, stage bytes,
    # shared bytes, the most unique dofs of a chunk, the stream
    chunk = [p, p, p, p, p, i, i, i, i, i, i, p]
    for suffix in gstream:
        fn = getattr(lib, f"fustpu_indexed_chunk_{suffix}")
        fn.argtypes = [p, p, p, p, i, *chunk]
        fn.restype = i
        fn = getattr(lib, f"fustpu_indexed_chunk_pair_{suffix}")
        fn.argtypes = [p, p, p, p, p, p, i, *chunk]
        fn.restype = i
    lib.fustpu_indexed_chunk_occupancy.argtypes = [i, i, i, i, i]
    lib.fustpu_indexed_chunk_occupancy.restype = i
    # the bfloat16 lean chunk kernel (indexed_lean.cu): the same arguments,
    # D a host array of floats and the ends flagged in each dof's first
    # class; its occupancy query takes (P, pair, cpb, smem)
    lib.fustpu_indexed_lean_bf16.argtypes = [p, p, p, p, i, *chunk]
    lib.fustpu_indexed_lean_pair_bf16.argtypes = [p, p, p, p, p, p, i,
                                                  *chunk]
    lib.fustpu_indexed_lean_occupancy.argtypes = [i, i, i, i]
    for name in ("fustpu_indexed_lean_bf16", "fustpu_indexed_lean_pair_bf16",
                 "fustpu_indexed_lean_occupancy"):
        getattr(lib, name).restype = i
    for name in ("fustpu_extruded_f32", "fustpu_extruded_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, p, i, p, i, i, i, p]
        fn.restype = i
    for name in ("fustpu_extruded_pair_f32", "fustpu_extruded_pair_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, p, p, p, i, p, i, i, i, p]
        fn.restype = i
    for name in ("fustpu_indexed_f32", "fustpu_indexed_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, p, i, p, i, p]
        fn.restype = i
    for name in ("fustpu_indexed_pair_f32", "fustpu_indexed_pair_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, p, p, p, i, p, i, p]
        fn.restype = i
    for name in ("fustpu_corner_f32", "fustpu_corner_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, i, i, i, i, p]
        fn.restype = i
    for name in ("fustpu_corner_pair_f32", "fustpu_corner_pair_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
        fn.restype = i
    ll = ctypes.c_longlong
    # the staged engine: float32, float64 and bfloat16 (#7-#10); the
    # gathers' first designs (the single-field one in float32 and float64)
    for suffix in gstream:
        fn = getattr(lib, f"fustpu_engine_gather_{suffix}")
        fn.argtypes = [p, p, p, ll, i, p]
        fn.restype = i
        fn = getattr(lib, f"fustpu_engine_gather2_{suffix}")
        fn.argtypes = [p, p, p, p, p, ll, i, p]
        fn.restype = i
        fn = getattr(lib, f"fustpu_engine_gather2_flat_{suffix}")
        fn.argtypes = [p, p, p, p, p, ll, p]
        fn.restype = i
        # the RK4 update with its coefficient on the card (vector.cu)
        fn = getattr(lib, f"fustpu_axpy_{suffix}")
        fn.argtypes = [p, p, p, p, ll, i, i, p]
        fn.restype = i
    # the bfloat16 contraction and scatter of engine_bf16.cu (D a host
    # array of floats, the chunk, the grid), and their first designs
    for suffix in ("f32", "f64", "cells_bf16"):
        fn = getattr(lib, f"fustpu_engine_contract_{suffix}")
        fn.argtypes = [p, p, p, p, p, p, p, ll, i, i, p]
        fn.restype = i
    for suffix in ("f32", "f64", "dofs_bf16"):
        fn = getattr(lib, f"fustpu_engine_scatter_{suffix}")
        fn.argtypes = [p, p, p, p, ll, p]
        fn.restype = i
    lib.fustpu_engine_contract_bf16.argtypes = [p, p, p, p, p, p, p, ll, i, i,
                                                i, i, p]
    lib.fustpu_engine_contract_bf16.restype = i
    for name in ("fustpu_engine_contract_bf16_occupancy",
                 "fustpu_engine_contract_bf16_smem"):
        getattr(lib, name).argtypes = [i, i]
        getattr(lib, name).restype = i
    lib.fustpu_engine_scatter_bf16.argtypes = [p, p, p, p, ll, ll, i, p]
    lib.fustpu_engine_scatter_bf16.restype = i
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"fustpu_engine_gather_flat_{suffix}")
        fn.argtypes = [p, p, p, ll, p]
        fn.restype = i
    # the walk's schedule: chunks, classes, nclass, blocks, cpb, stages,
    # stage_bytes, smem (the two-slab walk and the anatomy's pencil
    # variants)
    walk = [p, p, i, i, i, i, i, i]
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"fustpu_slab2_classes_{suffix}")
        fn.argtypes = [p, p, p, p, p, i, p, i, i, i, p]
        fn.restype = i
        # then ncy, ncz, drain and the chunks of one pencil
        fn = getattr(lib, f"fustpu_slab2_pencil_{suffix}")
        fn.argtypes = [p, p, p, p, i, *walk, i, i, i, i, p]
        fn.restype = i
        fn = getattr(lib, f"fustpu_anatomy_classes_{suffix}")
        fn.argtypes = [i, p, p, p, p, i, i, i, i, p]
        fn.restype = i
        fn = getattr(lib, f"fustpu_anatomy_classes_pair_{suffix}")
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        fn.restype = i
        # then ncx, ncy, ncz
        fn = getattr(lib, f"fustpu_anatomy_pencil_{suffix}")
        fn.argtypes = [i, p, p, p, p, i, *walk, i, i, i, p]
        fn.restype = i
        fn = getattr(lib, f"fustpu_anatomy_pencil_pair_{suffix}")
        fn.argtypes = [p, p, p, p, p, p, i, *walk, i, i, i, p]
        fn.restype = i
        fn = getattr(lib, f"fustpu_g_layout_{suffix}")
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = i
    lib.fustpu_slab2_pencil_occupancy.argtypes = [i, i, i, i]
    lib.fustpu_slab2_pencil_occupancy.restype = i
    lib.fustpu_anatomy_pencil_occupancy.argtypes = [i, i, i, i, i]
    lib.fustpu_anatomy_pencil_occupancy.restype = i
    lib.fustpu_relayout_copy.argtypes = [p, p, ll, i, p]
    lib.fustpu_relayout_copy.restype = i
    lib.fustpu_relayout_transpose.argtypes = [p, p, i, i, p]
    lib.fustpu_relayout_transpose.restype = i
    lib.fustpu_relayout_copy_flat.argtypes = [p, p, ll, p]
    lib.fustpu_relayout_copy_flat.restype = i
    lib.fustpu_relayout_transpose_padded.argtypes = [p, p, i, i, i, i, p]
    lib.fustpu_relayout_transpose_padded.restype = i
    # the corner walk: the pencil kernel's schedule with the GLL nodes and
    # weights after D, box pencils (ncy, ncz) or stacks (row ids, nz);
    # float32, float64 and bfloat16 (#3 and #6c, hex8 and hex27)
    for suffix in gstream:
        fn = getattr(lib, f"fustpu_corner_pencil_{suffix}")
        fn.argtypes = [p, p, p, p, p, i, *sched]
        fn.restype = i
        fn = getattr(lib, f"fustpu_corner_pencil_pair_{suffix}")
        fn.argtypes = [p, p, p, p, p, p, p, i, *sched]
        fn.restype = i
        for kind in ("extruded_corner", "extruded_corner_hex27"):
            fn = getattr(lib, f"fustpu_{kind}_stack_{suffix}")
            fn.argtypes = [p, p, p, p, p, i, *stack]
            fn.restype = i
            fn = getattr(lib, f"fustpu_{kind}_stack_pair_{suffix}")
            fn.argtypes = [p, p, p, p, p, p, p, i, *stack]
            fn.restype = i
    for name in ("fustpu_corner_pencil_occupancy",
                 "fustpu_extruded_corner_stack_occupancy",
                 "fustpu_extruded_corner_hex27_stack_occupancy"):
        getattr(lib, name).argtypes = [i, i, i, i, i]
        getattr(lib, name).restype = i
    # the bfloat16 lean corner walk (corner_lean.cu, corner_lean_stack.cu,
    # corner_lean_stack27.cu): the same arguments, D and the GLL nodes and
    # weights host arrays of floats; its occupancy queries take (P, pair,
    # cpb, smem)
    for kind, walk in (("corner_pencil", sched),
                       ("extruded_corner_stack", stack),
                       ("extruded_corner_hex27_stack", stack)):
        fn = getattr(lib, f"fustpu_{kind}_lean_bf16")
        fn.argtypes = [p, p, p, p, p, i, *walk]
        fn.restype = i
        fn = getattr(lib, f"fustpu_{kind}_pair_lean_bf16")
        fn.argtypes = [p, p, p, p, p, p, p, i, *walk]
        fn.restype = i
        fn = getattr(lib, f"fustpu_{kind}_lean_occupancy")
        fn.argtypes = [i, i, i, i]
        fn.restype = i
    for kind in ("extruded_corner", "extruded_corner_hex27"):
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"fustpu_{kind}_{suffix}")
            fn.argtypes = [p, p, p, p, p, p, p, i, p, i, i, i, p]
            fn.restype = i
            fn = getattr(lib, f"fustpu_{kind}_pair_{suffix}")
            fn.argtypes = [p, p, p, p, p, p, p, p, p, i, p, i, i, i, p]
            fn.restype = i
    for name, args in SETUP_ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = [*args, p]
        fn.restype = i
    return lib
