"""The staged gather / contract / scatter engine on flat DOF vectors: the
plain PyTorch versions of the four engine kernels in
``fustpu_torch.ops.cuda_engine``.

    u2 = x[g]                            gather   (positions p = c n^3 + q)
    y2 = D3^T (c G . D3 u2)              per-cell contraction on (cells, n^3)
    y  = zeros(ndofs); y[g] += y2        scatter-add

with g = dofmap.ravel() the flat position -> dof map.  Counterpart of
``fustpu/ops/pallas_gather.py``'s `gather` (:961), `gather2` (:1014),
`dense_contract` (:1117) and `scatter_add` (:1160), and of their
composition in ``fustpu/ops/operators.py`` (`stiffness_apply_indexed` and
`_pair` with ``engine=``, :290-301, :376-384).  The TPU's window plans
(one-hot matmul gathers, spill lists, lane padding) are not ported: a
gather here is `index_select`, the contraction is the factorised einsum of
``fustpu_torch.ops.indexed`` and the scatter `index_add_`, all in full
precision.  G is in the component-major (6, cells, n^3) layout of the JAX
package.

bfloat16 (the JAX package's ``--dtype bf16``): each function stores where
its kernel stores.  The gathers give bfloat16 u2 (a copy, exact); the
contraction widens its bfloat16 arguments to float32 (exactly), contracts
in float32 with TF32 off and rounds y2 to bfloat16 once; the pair fold
c1 u1 + c2 u2 is float32 (`fold`); the scatter sums the float32 widening
of y2 and rounds y to bfloat16 once.  A composed apply so rounds y2 and
then y, where ``spectral_mm.rounds_once``'s applies round y alone.
"""

from __future__ import annotations

import torch

from fustpu_torch.ops import spectral_mm as mm
from fustpu_torch.ops.indexed import _indexed_contract


def gather(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """out[p] = x[g[p]] for a flat index g (N,)."""
    return x.index_select(0, g)


def gather2(x1: torch.Tensor, x2: torch.Tensor, g: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(x1[g], x2[g])."""
    return gather(x1, g), gather(x2, g)


def fold(u1: torch.Tensor, c1: torch.Tensor, u2: torch.Tensor,
         c2: torch.Tensor) -> torch.Tensor:
    """The pair fold c1 u1 + c2 u2 of two gathered (cells, n^3) fields
    with per-cell c1, c2 (cells,); on bfloat16 arguments in float32."""
    u1, c1, u2, c2 = mm._widened((u1, c1, u2, c2))
    return c1[:, None] * u1 + c2[:, None] * u2


def dense_contract(u2: torch.Tensor, G6: torch.Tensor, D: torch.Tensor,
                   coeff: torch.Tensor | None = None) -> torch.Tensor:
    """y2[c] = sum_q D3q^T (coeff_c G_c . D3q u2[c]) on (cells, n^3) rows;
    G6 (6, cells, n^3); `coeff` (cells,) or None for unit
    coefficients.  A bfloat16 G6: the arguments widened to float32, y2
    rounded to bfloat16 once."""
    mm._full_precision(u2)
    out = G6.dtype
    u2, G6, D, coeff = mm._widened((u2, G6, D, coeff))
    cells, n = u2.shape[0], D.shape[0]
    y = _indexed_contract(u2.reshape(cells, n, n, n), G6, coeff, D)
    return y.reshape(cells, n ** 3).to(out)


def scatter_add(v: torch.Tensor, g: torch.Tensor, ndofs: int
                ) -> torch.Tensor:
    """y[g[p]] += v[p] over zeros(ndofs); bfloat16 v: y the float32 sum of
    its widening, rounded once."""
    acc = torch.float32 if v.dtype == torch.bfloat16 else v.dtype
    y = torch.zeros(ndofs, dtype=acc, device=v.device)
    return y.index_add_(0, g, v.reshape(-1).to(acc)).to(v.dtype)


def stiffness_apply_engine(x: torch.Tensor, G6: torch.Tensor,
                           coeff: torch.Tensor | None, g: torch.Tensor,
                           D: torch.Tensor, ndofs: int) -> torch.Tensor:
    """y = A(x) as gather, contraction and scatter-add."""
    cells = G6.shape[1]
    u2 = gather(x, g).reshape(cells, -1)
    return scatter_add(dense_contract(u2, G6, D, coeff), g, ndofs)


def stiffness_apply_engine_pair(x1: torch.Tensor, c1: torch.Tensor,
                                x2: torch.Tensor, c2: torch.Tensor,
                                G6: torch.Tensor, g: torch.Tensor,
                                D: torch.Tensor, ndofs: int) -> torch.Tensor:
    """A_c1(x1) + A_c2(x2): one two-field gather, the per-cell fold
    c1 u1 + c2 u2 (the coefficients commute with the in-cell
    contractions), one contraction and one scatter-add."""
    cells = G6.shape[1]
    u1, u2 = gather2(x1, x2, g)
    u = fold(u1.reshape(cells, -1), c1, u2.reshape(cells, -1), c2)
    return scatter_add(dense_contract(u, G6, D), g, ndofs)
