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


def dense_contract(u2: torch.Tensor, G6: torch.Tensor, D: torch.Tensor,
                   coeff: torch.Tensor | None = None) -> torch.Tensor:
    """y2[c] = sum_q D3q^T (coeff_c G_c . D3q u2[c]) on (cells, n^3) rows;
    G6 (6, cells, n^3); `coeff` (cells,) or None for unit
    coefficients."""
    mm._full_precision(u2)
    cells, n = u2.shape[0], D.shape[0]
    y = _indexed_contract(u2.reshape(cells, n, n, n), G6, coeff, D)
    return y.reshape(cells, n ** 3)


def scatter_add(v: torch.Tensor, g: torch.Tensor, ndofs: int
                ) -> torch.Tensor:
    """y[g[p]] += v[p] over zeros(ndofs)."""
    y = torch.zeros(ndofs, dtype=v.dtype, device=v.device)
    return y.index_add_(0, g, v.reshape(-1))


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
    u = (c1[:, None] * u1.reshape(cells, -1)
         + c2[:, None] * u2.reshape(cells, -1))
    return scatter_add(dense_contract(u, G6, D), g, ndofs)
