"""Stiffness and mass applies through an explicit dofmap on flat DOF vectors
(any conforming hex mesh): the plain PyTorch version of the indexed CUDA
kernel in ``fustpu_torch.ops.cuda_indexed``.

    u  = x[dofmap]                       (cells, n, n, n) gathered nodes
    w  = (D_i u, D_j u, D_k u)           derivatives along the three axes
    f  = c G . w                         symmetric 6-component metric
    r  = D_i^T f0 + D_j^T f1 + D_k^T f2
    y[dofmap] += r                       scatter-add

The local node order is the dofmap's own: node (i, j, k) of a cell is
column i n^2 + j n + k, and axis i pairs with G component 0.  G is in the
component-major (6, cells, n^3) layout of the JAX package.

Counterpart of the indexed section of ``fustpu/ops/operators.py``
(`mass_apply_indexed` :98, `stiffness_apply_indexed` :271,
`_indexed_contract` :311, `stiffness_apply_indexed_pair` :357), with the
per-cell contractions as factorised einsums instead of its dense
(n^3, n^3) operators (the same operator), in full precision only, and
without the TPU's gather/scatter engine and pull-scatter options.  On the
card the einsums go to cuBLAS with TF32 off.  On bfloat16 data a stiffness
apply computes in float32 and rounds once (``spectral_mm.rounds_once``).
"""

from __future__ import annotations

import torch

from fustpu_torch.ops import spectral_mm as mm
from fustpu_torch.ops.gather_scatter import gather_dofs, scatter_add_dofs


def mass_apply_indexed(x_flat: torch.Tensor, detJ: torch.Tensor,
                       coeff: torch.Tensor, dofmap: torch.Tensor,
                       ndofs: int) -> torch.Tensor:
    """detJ: (entities, nd); coeff: (entities,); dofmap: (entities, nd).
    Cell mass (nd = n^3) and facet mass (nd = n^2) alike."""
    vals = gather_dofs(x_flat, dofmap) * detJ * coeff[:, None]
    return scatter_add_dofs(vals, dofmap, ndofs)


def _indexed_contract(u: torch.Tensor, G: torch.Tensor,
                      coeff: torch.Tensor | None,
                      D: torch.Tensor) -> torch.Tensor:
    """Per-cell stiffness contraction of gathered fields u (cells, n, n, n)
    with G (6, cells, n^3); `coeff` (cells,) scales the metric term, None
    for unit coefficients."""
    cells, n = u.shape[0], D.shape[0]
    g = G.reshape(6, cells, n, n, n)
    wx = torch.einsum("ai,cijk->cajk", D, u)
    wy = torch.einsum("bj,cijk->cibk", D, u)
    wz = torch.einsum("ck,xijk->xijc", D, u)
    f0 = g[0] * wx + g[1] * wy + g[2] * wz
    f1 = g[1] * wx + g[3] * wy + g[4] * wz
    f2 = g[2] * wx + g[4] * wy + g[5] * wz
    if coeff is not None:
        c = coeff.reshape(cells, 1, 1, 1)
        f0, f1, f2 = f0 * c, f1 * c, f2 * c
    y = torch.einsum("ai,cajk->cijk", D, f0)
    y = y + torch.einsum("bj,cibk->cijk", D, f1)
    return y + torch.einsum("ck,xijc->xijk", D, f2)


@mm.rounds_once
def stiffness_apply_indexed(x_flat: torch.Tensor, G: torch.Tensor,
                            coeff: torch.Tensor | None,
                            dofmap: torch.Tensor, D: torch.Tensor,
                            ndofs: int) -> torch.Tensor:
    """y = A(x) through the dofmap (cells, n^3); G (6, cells, n^3);
    `coeff` (cells,) or None (unit coefficients: the uniform-media fold
    passes the folded field)."""
    mm._full_precision(x_flat)
    n = D.shape[0]
    cells = dofmap.shape[0]
    u = gather_dofs(x_flat, dofmap).reshape(cells, n, n, n)
    y = _indexed_contract(u, G, coeff, D)
    return scatter_add_dofs(y.reshape(cells, -1), dofmap, ndofs)


@mm.rounds_once
def stiffness_apply_indexed_pair(x1: torch.Tensor, c1: torch.Tensor,
                                 x2: torch.Tensor, c2: torch.Tensor,
                                 G: torch.Tensor, dofmap: torch.Tensor,
                                 D: torch.Tensor, ndofs: int
                                 ) -> torch.Tensor:
    """A_c1(x1) + A_c2(x2) in one pass: the per-cell coefficients commute
    with the in-cell contractions, so the gathered fields fold to
    c1 u1 + c2 u2 before one contraction chain and one scatter."""
    mm._full_precision(x1)
    n = D.shape[0]
    cells = dofmap.shape[0]
    u = (c1[:, None] * gather_dofs(x1, dofmap)
         + c2[:, None] * gather_dofs(x2, dofmap)).reshape(cells, n, n, n)
    y = _indexed_contract(u, G, None, D)
    return scatter_add_dofs(y.reshape(cells, -1), dofmap, ndofs)
