"""Vector (BLAS-1) operations with the reference's vocabulary (axpy /
copy / fill / pointwise_divide / square, and the single-device dot and
norm), as torch expressions that return new tensors.  Counterpart of
``fustpu/ops/vector.py``.
"""

from __future__ import annotations

import torch


def axpy(alpha: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y + alpha * x."""
    return torch.add(y, x, alpha=alpha)


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
