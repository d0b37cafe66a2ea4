"""Vector (BLAS-1) operations with the reference's vocabulary (axpy /
copy / fill / pointwise_divide / square, and the single-device dot and
norm), as torch expressions that return new tensors.  Counterpart of
``fustpu/ops/vector.py``.
"""

from __future__ import annotations

import torch


def _cpu_bf16(y: torch.Tensor) -> bool:
    """Whether `y + alpha * x` must be formed in float32 by hand: PyTorch's
    CPU add of bfloat16 tensors rounds alpha to bfloat16 in its vector
    body but not in its scalar tail, so the same element's result depends
    on where it lies in the tensor (and a node two ranks share would part
    across them); the card computes every element alike, in float32."""
    return y.dtype == torch.bfloat16 and y.device.type == "cpu"


def axpy(alpha: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y + alpha * x (bfloat16: computed in float32, rounded once)."""
    if _cpu_bf16(y):
        return torch.add(y.float(), x.float(), alpha=alpha).to(y.dtype)
    return torch.add(y, x, alpha=alpha)


def axpy_(alpha: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y += alpha * x in place, as `axpy` computes it; returns y."""
    if _cpu_bf16(y):
        return y.copy_(axpy(alpha, x, y))
    return y.add_(x, alpha=alpha)


def copy(a: torch.Tensor) -> torch.Tensor:
    """A new tensor with a's values (the reference's in-place copy)."""
    return a.clone()


def fill(alpha: float, like: torch.Tensor) -> torch.Tensor:
    """Constant tensor shaped like `like`."""
    return torch.full_like(like, alpha)


def pointwise_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b (the diagonal mass solve)."""
    return a / b


def square(a: torch.Tensor) -> torch.Tensor:
    """a * a (Westervelt v^2 term)."""
    return a * a


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Global dot product (single device; conjugates x, as `vdot`)."""
    return torch.vdot(x.reshape(-1), y.reshape(-1))


def norm(x: torch.Tensor) -> torch.Tensor:
    """Global l2 norm (single device)."""
    return torch.sqrt(dot(x, x).real)
