"""Structured stiffness apply on the card: the two hand-written CUDA kernels
of ``fustpu_torch/csrc/stiffness.cu`` and their wrappers.

Counterpart of ``fustpu/ops/pallas_stiffness.py``:

- `stiffness` replaces `_mk_kernel` (`stiffness_apply_pallas`): one field,
  any per-cell coefficient folded into G at build time;
- `stiffness_pair` replaces `_mk_kernel_pair`
  (`stiffness_apply_pallas_pair`): y = A_c1(x1) + A_c2(x2) with a unit G and
  per-cell (c1, c2), the heterogeneous Westervelt stage.

The operator data is kept in the kernel layout (`CellStiffness`): G as
(cells, 6, n^3), so that a cell reads 6 contiguous runs, cells ordered
cx*ncy*ncz + cy*ncz + cz and nodes i*n^2 + j*n + k.

A wrapper given CPU tensors runs the kernel's plain version
(`stiffness_plain` / `stiffness_pair_plain`, the matmul formulation of
``fustpu_torch.ops.spectral_mm`` on the same data).  Given CUDA tensors it
launches the kernel or raises: there is no fallback.  Each wrapper counts
its launches in `launches` (one per apply).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fustpu_torch.ops import spectral_mm as mm

# Applies that went through each kernel (not counting the plain version).
launches = {"stiffness": 0, "stiffness_pair": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class CellStiffness(NamedTuple):
    """Stiffness operator in the kernel layout, as tensors on one device."""

    G: torch.Tensor                  # (cells, 6, n^3), coefficient folded in
    D: torch.Tensor                  # (n, n) D[q, i] = l_i'(x_q)
    nc: tuple                        # cells per axis
    C: torch.Tensor | None = None    # (cells, 2) pair coefficients (c1, c2)

    @property
    def P(self) -> int:
        return self.D.shape[0] - 1


def pack_G(G_cells: np.ndarray, coeff: np.ndarray | None = None
           ) -> np.ndarray:
    """(cells, n^3, 6) host geometry factors -> (cells, 6, n^3) kernel
    layout, with an optional per-cell coefficient folded in."""
    G = np.moveaxis(np.asarray(G_cells), 2, 1)
    if coeff is not None:
        G = G * np.asarray(coeff, np.float64).reshape(-1)[:, None, None]
    return np.ascontiguousarray(G)


# ---------------------------------------------------------------------------
# Plain versions: the matmul formulation on the same operator data
# ---------------------------------------------------------------------------

def _expand_cells(a: torch.Tensor, nc, n: int) -> torch.Tensor:
    """(cells, ...) per-cell values -> (..., ex, ey, ez) by n-fold repeat."""
    a = a.reshape(*nc, -1)
    for ax in range(3):
        a = a.repeat_interleave(n, dim=ax)
    return a.permute(3, 0, 1, 2)


def to_mm(op: CellStiffness):
    """(MMStiffness, c1_e, c2_e) holding the same numbers as `op` in the
    matmul layout, on op's device (c*_e are None without pair
    coefficients)."""
    P, n = op.P, op.P + 1
    ncx, ncy, ncz = op.nc
    G = op.G.reshape(ncx, ncy, ncz, 6, n, n, n).permute(3, 0, 4, 1, 5, 2, 6)
    mm_op = mm.MMStiffness(
        W=tuple(torch.as_tensor(mm.window_matrix(c, P), dtype=op.G.dtype,
                                device=op.G.device) for c in op.nc),
        Dt=tuple(torch.block_diag(*([op.D] * c)) for c in op.nc),
        G=G.reshape(6, ncx * n, ncy * n, ncz * n).contiguous())
    if op.C is None:
        return mm_op, None, None
    ce = _expand_cells(op.C, op.nc, n)
    return mm_op, ce[0].contiguous(), ce[1].contiguous()


def stiffness_plain(op: CellStiffness, x: torch.Tensor) -> torch.Tensor:
    """Plain version of `stiffness`."""
    return mm.stiffness_apply_mm(to_mm(op)[0], x)


def stiffness_pair_plain(op: CellStiffness, x1: torch.Tensor,
                         x2: torch.Tensor) -> torch.Tensor:
    """Plain version of `stiffness_pair`."""
    mm_op, c1_e, c2_e = to_mm(op)
    return mm.stiffness_apply_mm_pair(mm_op, x1, x2, c1_e, c2_e)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(op: CellStiffness, *xs: torch.Tensor, pair: bool) -> None:
    x = xs[0]
    if x.device.type != "cuda":
        raise ValueError(f"stiffness kernel: tensor on {x.device}, "
                         "expected a CUDA device")
    if x.dtype not in _SUFFIX:
        raise ValueError(f"stiffness kernel: dtype {x.dtype} unsupported "
                         "(float32 or float64)")
    if not 2 <= op.P <= 10:
        raise ValueError(f"stiffness kernel: degree {op.P} outside 2..10")
    n = op.P + 1
    ncells = op.nc[0] * op.nc[1] * op.nc[2]
    grid = tuple(c * op.P + 1 for c in op.nc)
    shapes = [(t, grid, "x") for t in xs] + [
        (op.G, (ncells, 6, n ** 3), "G"), (op.D, (n, n), "D")]
    if pair:
        if op.C is None:
            raise ValueError("stiffness_pair needs pair coefficients C")
        shapes.append((op.C, (ncells, 2), "C"))
    for t, shape, name in shapes:
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"stiffness kernel: {name} is {t.dtype} on "
                             f"{t.device}, expected {x.dtype} on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"stiffness kernel: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"stiffness kernel: {name} is not contiguous")


def _launch(name: str, op: CellStiffness, xs, extra) -> torch.Tensor:
    from fustpu_torch import _build

    x = xs[0]
    y = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    fn = getattr(_build.load(), f"fustpu_{name}_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(t.data_ptr() for t in xs), *extra, op.G.data_ptr(),
                 op.D.data_ptr(), y.data_ptr(), op.P, *op.nc, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {err}")
    launches[name] += 1
    return y


def stiffness(op: CellStiffness, x: torch.Tensor) -> torch.Tensor:
    """y_grid = A_stiff(x_grid) through the single-field kernel (the plain
    version for a CPU tensor)."""
    if x.device.type == "cpu":
        return stiffness_plain(op, x)
    _check(op, x, pair=False)
    return _launch("stiffness", op, (x,), ())


def stiffness_pair(op: CellStiffness, x1: torch.Tensor,
                   x2: torch.Tensor) -> torch.Tensor:
    """y_grid = A_c1(x1) + A_c2(x2) through the pair kernel (the plain
    version for CPU tensors)."""
    if x1.device.type == "cpu":
        return stiffness_pair_plain(op, x1, x2)
    _check(op, x1, x2, pair=True)
    return _launch("stiffness_pair", op, (x1, x2), (op.C.data_ptr(),))
