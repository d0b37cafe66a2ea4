"""Vector (BLAS-1) operations with the reference's vocabulary (axpy /
pointwise_divide / square), as torch expressions that return new tensors.
Counterpart of ``fustpu/ops/vector.py``.
"""

from __future__ import annotations

import torch


def axpy(alpha: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y + alpha * x."""
    return torch.add(y, x, alpha=alpha)


def pointwise_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b (the diagonal mass solve)."""
    return a / b


def square(a: torch.Tensor) -> torch.Tensor:
    """a * a (Westervelt v^2 term)."""
    return a * a
