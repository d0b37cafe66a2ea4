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
    for name in ("fustpu_stiffness_f32", "fustpu_stiffness_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, i, i, i, i, p]
        fn.restype = i
    for name in ("fustpu_stiffness_pair_f32", "fustpu_stiffness_pair_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        fn.restype = i
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
    for kind in ("extruded_corner", "extruded_corner_hex27"):
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"fustpu_{kind}_{suffix}")
            fn.argtypes = [p, p, p, p, p, p, p, i, p, i, i, i, p]
            fn.restype = i
            fn = getattr(lib, f"fustpu_{kind}_pair_{suffix}")
            fn.argtypes = [p, p, p, p, p, p, p, p, p, i, p, i, i, i, p]
            fn.restype = i
    return lib
