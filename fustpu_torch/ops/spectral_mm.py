"""Matmul formulation of the structured stiffness operator: the plain
PyTorch version of the two CUDA kernels in ``fustpu_torch.ops.cuda_stiffness``.

Gather ("windows"), within-cell contraction and scatter ("fold") are dense
matrices applied per axis:

  W_ax  (e, g):  W[(b,j), y] = [y == b*P + j]     (window / gather; its
                 transpose is the overlap-add fold = direct stiffness sum)
  Dt_ax (e, e):  block-diag copies of the 1D GLL derivative matrix D[q, i]

  expanded field u = Wx Wy Wz x                (cell (a,b,c), node (i,j,k)
                                                at position (a n + i, ...))
  stiffness: y = W^T( Dtx^T f0 + Dty^T f1 + Dtz^T f2 ),  where
             (f0,f1,f2) = coeff * G @ (Dtx u, Dty u, Dtz u)   elementwise.

The host-side constructors (numpy, float64) are vendored from
``fustpu/ops/spectral_mm.py``; `stiffness_apply_mm` and
`stiffness_apply_mm_pair` are their torch counterparts.  The CPU tests and
the kernel-vs-plain comparisons on the card use them; on a CUDA device the
models' main path runs the kernels instead.

On the card the einsums go to cuBLAS.  Wherever this plain path runs on a
CUDA tensor it sets ``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False`` first, so that a float32 apply
is a full-float32 reference (TF32 keeps only about three digits).

The mass operator needs none of this: with GLL collocation the assembled
mass operator is globally diagonal, so `mass_diagonal` precomputes the
vector once per coefficient field and an apply is one elementwise multiply.

bfloat16 (the JAX package's ``--dtype bf16``, `rounds_once`): given
bfloat16 fields and operator data, a plain apply widens them to float32
(exactly), contracts in float32 with TF32 off and rounds the result to
bfloat16 once.  That is what the kernels' bfloat16 forms are held to:
they store in bfloat16 and compute in float32 too, in another order of
sums, and round y where they store it.  It is not the JAX package's own
order of roundings: its TPU kernel keeps bfloat16 accumulators, and its
XLA path rounds at each op.  ``fustpu_torch.ops.extruded`` and
``fustpu_torch.ops.indexed`` take the same form.  The staged engine's plain
versions (``fustpu_torch.ops.engine``) do not: each of its functions
stores where its kernel stores, so a composed bfloat16 engine apply rounds
the element stream y2 and then y.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Host-side matrix construction (numpy, f64)
# ---------------------------------------------------------------------------

def window_matrix(ncells: int, P: int) -> np.ndarray:
    """(ncells*(P+1), ncells*P+1) selection matrix W[(b,j), y] = [y==b*P+j]."""
    n = P + 1
    e, g = ncells * n, ncells * P + 1
    W = np.zeros((e, g))
    rows = np.arange(e)
    cols = (rows // n) * P + (rows % n)
    W[rows, cols] = 1.0
    return W


@functools.lru_cache(maxsize=None)
def window_tensor(ncells: int, P: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """`window_matrix` on `device`, uploaded once (a plain apply that
    rebuilds its matmul layout then uploads nothing, and a CUDA graph can
    capture it)."""
    return torch.as_tensor(window_matrix(ncells, P), dtype=dtype,
                           device=device)


def deriv_block_matrix(ncells: int, D: np.ndarray) -> np.ndarray:
    """(e, e) block-diagonal with `ncells` copies of the (n, n) nodal
    derivative matrix D[q, i]."""
    n = D.shape[0]
    e = ncells * n
    out = np.zeros((e, e))
    for b in range(ncells):
        out[b * n:(b + 1) * n, b * n:(b + 1) * n] = D
    return out


def to_expanded_layout(arr_cells: np.ndarray, nc, n: int) -> np.ndarray:
    """(cells, n^3[, k]) -> (ex, ey, ez[, k]) expanded-grid layout with cell
    (a,b,c) node (i,j,k) at (a*n+i, b*n+j, c*n+k)."""
    trailing = arr_cells.shape[2:]
    a = arr_cells.reshape(*nc, n, n, n, *trailing)
    a = a.transpose(0, 3, 1, 4, 2, 5, *range(6, a.ndim))
    return np.ascontiguousarray(
        a.reshape(nc[0] * n, nc[1] * n, nc[2] * n, *trailing))


def expand_cell_field(coeff: np.ndarray, n: int) -> np.ndarray:
    """(ncx, ncy, ncz) per-cell values -> (ex, ey, ez) by n-fold repeat."""
    return np.repeat(np.repeat(np.repeat(coeff, n, 0), n, 1), n, 2)


def mass_diagonal(nc, P: int, detJ_cells: np.ndarray,
                  coeff: np.ndarray | None = None) -> np.ndarray:
    """The assembled (global) mass diagonal, float64 host: fold of
    detJ * coeff over cells.  Apply = x * diag.

    Strided in-place accumulation: global node (a*P+i, b*P+j, c*P+k) is the
    step-P slice out[i::P, j::P, k::P], so the fold is n^3 strided adds of
    (ncx, ncy, ncz) blocks, with no expanded-layout transpose."""
    n = P + 1
    ncx, ncy, ncz = nc
    dJ = detJ_cells.reshape(ncx, ncy, ncz, n, n, n)
    if coeff is not None:
        dJ = dJ * np.asarray(coeff)[..., None, None, None]
    out = np.zeros((ncx * P + 1, ncy * P + 1, ncz * P + 1))
    for i in range(n):
        oi = out[i::P][:ncx] if i < P else out[P::P]
        for j in range(n):
            oj = oi[:, j::P][:, :ncy] if j < P else oi[:, P::P]
            for k in range(n):
                ok = (oj[:, :, k::P][:, :, :ncz] if k < P
                      else oj[:, :, P::P])
                ok += dJ[:, :, :, i, j, k]
    return out


# ---------------------------------------------------------------------------
# Operator container
# ---------------------------------------------------------------------------

class MMStiffness(NamedTuple):
    """Stiffness operator in the matmul layout, as tensors on one device."""

    W: tuple              # 3 x (e_ax, g_ax)
    Dt: tuple             # 3 x (e_ax, e_ax)
    G: torch.Tensor       # (6, ex, ey, ez) quadrature-scaled metric, with the
                          # material coefficient optionally folded in


def build_stiffness(nc, P: int, D_1d: np.ndarray, G_cells: np.ndarray,
                    dtype: torch.dtype, device,
                    coeff: np.ndarray | None = None) -> MMStiffness:
    """G_cells: (cells, n^3, 6) float64 (precompute.cell_geometry_factors);
    coeff: optional (ncx, ncy, ncz) per-cell coefficient folded into G."""
    n = P + 1
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    Ge = np.moveaxis(to_expanded_layout(G_cells, nc, n), -1, 0)
    if coeff is not None:
        Ge = Ge * expand_cell_field(np.asarray(coeff), n)[None]
    return MMStiffness(
        W=tuple(t(window_matrix(c, P)) for c in nc),
        Dt=tuple(t(deriv_block_matrix(c, D_1d)) for c in nc),
        G=t(np.ascontiguousarray(Ge)))


# ---------------------------------------------------------------------------
# Application (torch)
# ---------------------------------------------------------------------------

_SUBS = (("ay,yjk->ajk", "ya,yjk->ajk"),
         ("by,iyk->ibk", "yb,iyk->ibk"),
         ("cy,ijy->ijc", "yc,ijy->ijc"))
_G_IDX = ((0, 1, 2), (1, 3, 4), (2, 4, 5))


def _widened(a):
    """A bfloat16 tensor as float32 (exact), recursively through tuples
    and NamedTuples of operator data; anything else as it is."""
    if isinstance(a, torch.Tensor):
        return a.float() if a.dtype == torch.bfloat16 else a
    if isinstance(a, tuple):
        parts = [_widened(b) for b in a]
        return type(a)(*parts) if hasattr(a, "_fields") else tuple(parts)
    return a


def _has_bf16(a) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == torch.bfloat16
    return isinstance(a, tuple) and any(_has_bf16(b) for b in a)


def rounds_once(apply):
    """A plain apply's bfloat16 form: on bfloat16 arguments it runs
    `apply` on their float32 widening and rounds the result to bfloat16
    once; any other arguments go to `apply` as they are."""
    @functools.wraps(apply)
    def wrapped(*args, **kwargs):
        if not _has_bf16((*args, *kwargs.values())):
            return apply(*args, **kwargs)
        return apply(*_widened(args), **{
            k: _widened(v) for k, v in kwargs.items()}).to(torch.bfloat16)
    return wrapped


def _full_precision(x: torch.Tensor) -> None:
    """Keep cuBLAS/cuDNN out of TF32 for the plain path on the card."""
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _axis_mm(M: torch.Tensor, x: torch.Tensor, axis: int,
             transpose: bool = False) -> torch.Tensor:
    """Apply matrix M along one axis of a 3D field."""
    return torch.einsum(_SUBS[axis][int(transpose)], M, x)


def expand(op: MMStiffness, x: torch.Tensor) -> torch.Tensor:
    """(gx, gy, gz) -> (ex, ey, ez) element gather (u = Wx Wy Wz x)."""
    _full_precision(x)
    for ax in range(3):
        x = _axis_mm(op.W[ax], x, ax)
    return x


def fold(op: MMStiffness, u: torch.Tensor) -> torch.Tensor:
    """(ex, ey, ez) -> (gx, gy, gz) overlap-add (y = Wx^T Wy^T Wz^T u)."""
    _full_precision(u)
    for ax in range(3):
        u = _axis_mm(op.W[ax], u, ax, transpose=True)
    return u


def _contract(op: MMStiffness, u: torch.Tensor,
              coeff_e: torch.Tensor | None) -> torch.Tensor:
    """The in-cell chain on an expanded field, then the fold."""
    w = [_axis_mm(op.Dt[ax], u, ax) for ax in range(3)]
    G = op.G
    f = []
    for a, b, c in _G_IDX:
        fd = G[a] * w[0] + G[b] * w[1] + G[c] * w[2]
        if coeff_e is not None:
            fd = fd * coeff_e
        f.append(fd)
    r = sum(_axis_mm(op.Dt[ax], f[ax], ax, transpose=True) for ax in range(3))
    return fold(op, r)


@rounds_once
def stiffness_apply_mm(op: MMStiffness, x: torch.Tensor,
                       coeff_e: torch.Tensor | None = None) -> torch.Tensor:
    """y_grid = A_stiff(x_grid).  `coeff_e`: optional (ex, ey, ez) expanded
    per-cell coefficient (omit if folded into G at build time)."""
    return _contract(op, expand(op, x), coeff_e)


@rounds_once
def stiffness_apply_mm_pair(op: MMStiffness, x1: torch.Tensor,
                            x2: torch.Tensor, c1_e: torch.Tensor,
                            c2_e: torch.Tensor) -> torch.Tensor:
    """y = A_c1(x1) + A_c2(x2) in one contraction pass.

    Per-cell coefficients are constant within each cell, so they commute
    with the within-cell derivative contractions once the fields are in the
    expanded layout: combine u = c1_e*E(x1) + c2_e*E(x2) there and run a
    single unit-coefficient middle and fold."""
    u = expand(op, x1) * c1_e + expand(op, x2) * c2_e
    return _contract(op, u, None)
