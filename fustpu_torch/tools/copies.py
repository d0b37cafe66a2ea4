"""Copies of the CUDA sources for the split tools (``chunk_split``,
``corner_split``): a source held at one degree, each copy built into a
library of its own in a temporary directory (never the package's build),
and the device time of one call.  Building needs nvcc, timing a card."""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import torch

from fustpu_torch import _build
from fustpu_torch.tools import kernel_resources


def at_degree(text: str, P: int, macros=()) -> str:
    """`text` with each degree macro of `macros` (each defined once in it)
    and every ``Degrees<...>`` list of the lean corner walk holding P
    alone."""
    for m in macros:
        text, k = re.subn(rf"#define {m}\(M\)(?:[^\n\\]|\\\n)*\n",
                          f"#define {m}(M) M({P})\n", text)
        assert k == 1, m
    return re.sub(r"Degrees<[\d, ]*>", f"Degrees<{P}>", text)


def build(copies: dict, tmp: Path) -> dict:
    """Each copy {key: (source file, {file: text}, nvcc flags)} built into
    a library of its own under `tmp` (the package's sources with `text` in
    place of each `file`), all nvcc started together: {key: (library,
    ptxas rows)}."""
    jobs = {}
    for i, (key, (src, texts, flags)) in enumerate(copies.items()):
        d = tmp / f"v{i}"
        shutil.copytree(_build.CSRC, d)
        for f, text in texts.items():
            (d / f).write_text(text)
        lib = d / "v.so"
        # -fno-gnu-unique: each copy keeps its own template statics (the
        # kernels' `allow_smem` flags), which the loader would otherwise
        # unify across the copies loaded into this process
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-Xcompiler",
               "-fno-gnu-unique", "-Xptxas", "-v", "-shared", "-o", str(lib),
               str(d / src)]
        jobs[key] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    out = {}
    for key, (lib, job) in jobs.items():
        text, _ = job.communicate()
        if job.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{text}")
        out[key] = (ctypes.CDLL(str(lib)), kernel_resources.parse(text))
    return out


def ms_per_call(fn, reps: int = 20) -> float:
    """Mean device time of one call of `fn` in ms, CUDA events over `reps`
    calls after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(True), torch.cuda.Event(True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps
