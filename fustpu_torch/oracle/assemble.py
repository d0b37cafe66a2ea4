"""Dense reference assembler (the test oracle), float64 numpy.

It assembles explicit per-element matrices from full 3D basis tabulations
(no sum factorisation, no collocation shortcuts, no structured layout) and
applies them with ``np.add.at``: a code path independent of the operators
and kernels it checks.  The port's own copy of ``fustpu/oracle/
assemble.py`` (the same arithmetic, so its matrices are that module's bit
for bit), so that the checks on the card reach it without the JAX package.
"""

from __future__ import annotations

import numpy as np

from fustpu_torch.elements import gll
from fustpu_torch.elements.hex import FACETS, tabulate_3d_basis
from fustpu_torch.ops.precompute import _geom_dofs_grads


def element_mass_matrices(mesh) -> np.ndarray:
    """(cells, n^3, n^3) element mass matrices at GLL quadrature."""
    elem = mesh.element
    pts, wts = elem.quad_points, elem.quad_weights
    vals, _ = tabulate_3d_basis(elem, pts)           # (nq, nd)
    gdofs, ggrads = _geom_dofs_grads(mesh, pts)
    J = np.einsum("cvp,qvr->cqpr", gdofs, ggrads, optimize=True)
    detJ = np.abs(np.linalg.det(J)) * wts            # (cells, nq)
    return np.einsum("qa,cq,qb->cab", vals, detJ, vals, optimize=True)


def element_stiffness_matrices(mesh) -> np.ndarray:
    """(cells, n^3, n^3) element stiffness matrices at GLL quadrature."""
    elem = mesh.element
    pts, wts = elem.quad_points, elem.quad_weights
    _, grads = tabulate_3d_basis(elem, pts)          # (nq, nd, 3) ref grads
    gdofs, ggrads = _geom_dofs_grads(mesh, pts)
    J = np.einsum("cvp,qvr->cqpr", gdofs, ggrads, optimize=True)
    detJ = np.abs(np.linalg.det(J)) * wts
    Jinv = np.linalg.inv(J)                          # (c, q, ref, phys)
    # physical gradients of every basis function
    gp = np.einsum("qar,cqrp->cqap", grads, Jinv, optimize=True)
    return np.einsum("cqap,cq,cqbp->cab", gp, detJ, gp, optimize=True)


def element_facet_mass_matrices(mesh,
                                boundary_data: np.ndarray) -> np.ndarray:
    """(nf, n^2, n^2) facet mass matrices (surface measure by the Gram
    determinant sqrt(det(T^T T)), another formula than the operators'
    |t1 x t2|)."""
    elem = mesh.element
    n = elem.n
    wts_f = elem.facet_quad_weights
    nodes = elem.nodes_1d
    # 2D facet basis values at facet quad points (generic tabulation)
    v1, _ = gll.lagrange_tabulate(nodes, nodes)      # (n, n) ~ identity
    vals2 = np.einsum("qa,rb->qrab", v1, v1).reshape(n * n, n * n)
    out = np.empty((boundary_data.shape[0], n * n, n * n))
    for idx, (cell, lf) in enumerate(boundary_data):
        pts = elem.facet_quad_points(lf)
        gdofs, ggrads = _geom_dofs_grads(mesh, pts)
        J = np.einsum("vp,qvr->qpr", gdofs[cell], ggrads)
        axis, _ = FACETS[lf]
        free = [ax for ax in range(3) if ax != axis]
        T = J[:, :, free]                            # (q, 3, 2) tangents
        gram = np.einsum("qpi,qpj->qij", T, T)
        measure = np.sqrt(np.linalg.det(gram)) * wts_f
        out[idx] = np.einsum("qa,q,qb->ab", vals2, measure, vals2,
                             optimize=True)
    return out


def apply_elementwise(mats: np.ndarray, dofmap: np.ndarray,
                      coeff: np.ndarray, x: np.ndarray,
                      ndofs: int) -> np.ndarray:
    """y = sum_e coeff_e P_e^T (M_e (P_e x)), summed by np.add.at."""
    xe = x[dofmap]                                   # (e, nd)
    ye = coeff[:, None] * np.einsum("eab,eb->ea", mats, xe, optimize=True)
    y = np.zeros(ndofs, dtype=x.dtype)
    np.add.at(y, dofmap.ravel(), ye.ravel())
    return y
