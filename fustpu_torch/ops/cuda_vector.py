"""The RK4 update whose coefficient lies on the card: the hand-written
kernel of ``fustpu_torch/csrc/vector.cu``, its wrapper, its plain version
and its launch counter.

`axpy(alpha, x, y, out)` computes out = y + alpha x with `alpha` a
one-element tensor (a row entry of the captured solve's coefficient table,
``models/timestepping.py``), as PyTorch's ``torch.add(y, x, alpha=a)``
computes it: in float32 for float32 and bfloat16 fields (rounded to
bfloat16 once), in float64 for float64 fields.  `alpha` is float32 for
float32 and bfloat16 fields and float64 for float64 ones.  A CUDA graph
replays the kernel with the coefficient it finds in the table at each
replay, where a Python float would stay the one captured.

Given CPU tensors the wrapper runs the plain version (``torch.add`` with the
coefficient read on the host; bfloat16 in float32, rounded once, as
``ops/vector.axpy`` rounds it).  Given CUDA tensors it launches the kernel
or raises.  Each launch counts in `launches` (bfloat16: `bf16_launches`).
Nothing here runs at import time.
"""

from __future__ import annotations

import torch

from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.ops import launch

THREADS = 256                    # vector.cu kThreads
UNROLL = 4                       # vector.cu kUnroll: packs a thread
_MAX_BLOCKS = 1 << 30
_BYTES = {torch.float32: 4, torch.float64: 8, torch.bfloat16: 2}

launches = {"axpy": 0}
bf16_launches = {"axpy_bf16": 0}


def reset_launches() -> None:
    for counts in (launches, bf16_launches):
        for k in counts:
            counts[k] = 0


def coefficient_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type in which an update of `dtype` fields applies its
    coefficient (PyTorch's: float32 for float32 and bfloat16, float64 for
    float64)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def axpy_plain(alpha: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of `axpy` (reads `alpha` on the host)."""
    a = float(alpha)
    if y.dtype == torch.bfloat16:
        r = torch.add(y.float(), x.float(), alpha=a).to(y.dtype)
    else:
        r = torch.add(y, x, alpha=a)
    return r if out is None else out.copy_(r)


def blocks(n: int, vec: bool, dtype: torch.dtype) -> int:
    """The grid for `n` values: THREADS threads a block, each taking
    UNROLL packs of 16 B of each array (`vec`) or of one value, at least
    one block (whose first threads also take the values past the last
    whole pack)."""
    per = 16 // _BYTES[dtype] if vec else 1
    return max(1, min(_MAX_BLOCKS, -(-(n // per) // (THREADS * UNROLL))))


def axpy(alpha: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
         out: torch.Tensor | None = None) -> torch.Tensor:
    """out = y + alpha x through `fustpu_axpy` (the plain version for a CPU
    tensor); `out` may be y (in place), a new tensor when None."""
    if y.device.type == "cpu":
        return axpy_plain(alpha, x, y, out)
    out = torch.empty_like(y) if out is None else out
    _check(alpha, x, y, out)
    vec = all(t.data_ptr() % 16 == 0 for t in (x, y, out))
    n = y.numel()
    launch.launch(f"fustpu_axpy_{cs.SUFFIX[y.dtype]}", y.get_device(),
                  x.data_ptr(), y.data_ptr(), alpha.data_ptr(),
                  out.data_ptr(), n, int(vec), blocks(n, vec, y.dtype))
    cs.count(launches, bf16_launches, "axpy", y.dtype)
    return out


def _check(alpha: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
           out: torch.Tensor) -> None:
    if y.device.type != "cuda":
        raise ValueError(f"axpy kernel: tensor on {y.device}, expected a "
                         "CUDA device")
    if y.dtype not in cs.SUFFIX:
        raise ValueError(f"axpy kernel: dtype {y.dtype} unsupported")
    want = coefficient_dtype(y.dtype)
    if alpha.device != y.device or alpha.dtype != want or \
            alpha.numel() != 1:
        raise ValueError(f"axpy kernel: alpha is {alpha.dtype} "
                         f"{tuple(alpha.shape)} on {alpha.device}, expected "
                         f"one {want} on {y.device}")
    for what, t in (("x", x), ("out", out)):
        if t.device != y.device or t.dtype != y.dtype:
            raise ValueError(f"axpy kernel: {what} is {t.dtype} on "
                             f"{t.device}, expected {y.dtype} on {y.device}")
        if t.shape != y.shape:
            raise ValueError(f"axpy kernel: {what} has shape "
                             f"{tuple(t.shape)}, expected {tuple(y.shape)}")
    if not all(t.is_contiguous() for t in (x, y, out)):
        raise ValueError("axpy kernel: x, y and out must be contiguous")
