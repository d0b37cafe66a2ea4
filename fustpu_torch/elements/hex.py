"""Tensor-product GLL hexahedral element: DOF layout, facets, geometry basis.

Local dof (i, j, k) -> i*n^2 + j*n + k with i <-> xi_0, j <-> xi_1,
k <-> xi_2 on the unit reference cell [0,1]^3.  Quadrature is the collocated
GLL rule: quadrature point q = (i,j,k) coincides with dof (i,j,k), so the
mass matrix is diagonal and detJ is indexed by local dof.  Vendored from
``fustpu/elements/hex.py`` (the trilinear geometry basis only: the port's
meshes are box meshes).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from fustpu_torch.elements import gll

# Facet enumeration: (axis, side).  side 0 => xi_axis = 0, side 1 => xi_axis = 1.
FACETS = [(0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1)]


@dataclasses.dataclass(frozen=True)
class HexElement:
    degree: int

    @property
    def n(self) -> int:
        return self.degree + 1

    @property
    def ndofs(self) -> int:
        return self.n**3

    @property
    def nfacet_dofs(self) -> int:
        return self.n**2

    @functools.cached_property
    def nodes_1d(self) -> np.ndarray:
        return gll.gll_nodes_unit(self.n)

    @functools.cached_property
    def weights_1d(self) -> np.ndarray:
        return gll.gll_points_weights_unit(self.n)[1]

    @functools.cached_property
    def deriv_1d(self) -> np.ndarray:
        """(n, n) nodal derivative matrix D[q, i] = l_i'(x_q)."""
        return gll.derivative_matrix(self.n)

    @functools.cached_property
    def quad_points(self) -> np.ndarray:
        """(n^3, 3) collocated GLL quadrature points, TP-ordered."""
        p = self.nodes_1d
        I, J, K = np.meshgrid(p, p, p, indexing="ij")
        return np.stack([I.ravel(), J.ravel(), K.ravel()], axis=1)

    @functools.cached_property
    def quad_weights(self) -> np.ndarray:
        """(n^3,) TP-ordered quadrature weights."""
        w = self.weights_1d
        return (w[:, None, None] * w[None, :, None] * w[None, None, :]).ravel()

    @functools.cached_property
    def facet_quad_weights(self) -> np.ndarray:
        """(n^2,) 2D GLL weights on a facet (s*n + t ordering)."""
        w = self.weights_1d
        return (w[:, None] * w[None, :]).ravel()

    def facet_dofs(self, facet: int) -> np.ndarray:
        """Local dof indices on a facet, ordered (s, t) = the two free axes
        in increasing-axis order; index s*n + t."""
        n = self.n
        axis, side = FACETS[facet]
        idx = np.arange(n)
        fixed = 0 if side == 0 else n - 1
        grids = [np.array([fixed]) if ax == axis else idx for ax in range(3)]
        A, B, C = np.meshgrid(grids[0], grids[1], grids[2], indexing="ij")
        return (A * n * n + B * n + C).ravel().astype(np.int32)

    @functools.cached_property
    def all_facet_dofs(self) -> np.ndarray:
        """(6, n^2) local dofs for every facet."""
        return np.stack([self.facet_dofs(f) for f in range(6)])

    def facet_quad_points(self, facet: int) -> np.ndarray:
        """(n^2, 3) reference-cell coordinates of facet quadrature points."""
        n = self.n
        p = self.nodes_1d
        axis, side = FACETS[facet]
        fixed = 0.0 if side == 0 else 1.0
        S, T = np.meshgrid(p, p, indexing="ij")
        pts = np.zeros((n * n, 3))
        free = [ax for ax in range(3) if ax != axis]
        pts[:, axis] = fixed
        pts[:, free[0]] = S.ravel()
        pts[:, free[1]] = T.ravel()
        return pts


# ---------------------------------------------------------------------------
# Trilinear (hex8) geometry basis.  Corner (a,b,c) -> 4a + 2b + c, corner at
# reference coordinates (a, b, c).
# ---------------------------------------------------------------------------

def hex8_tabulate(pts: np.ndarray):
    """Values (npts, 8) and gradients (npts, 8, 3) of the trilinear basis."""
    pts = np.asarray(pts, dtype=np.float64)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    l = lambda t, a: t if a else 1.0 - t
    dl = lambda a: 1.0 if a else -1.0
    vals = np.zeros((pts.shape[0], 8))
    grads = np.zeros((pts.shape[0], 8, 3))
    for a in (0, 1):
        for b in (0, 1):
            for c in (0, 1):
                v = 4 * a + 2 * b + c
                vals[:, v] = l(x, a) * l(y, b) * l(z, c)
                grads[:, v, 0] = dl(a) * l(y, b) * l(z, c)
                grads[:, v, 1] = l(x, a) * dl(b) * l(z, c)
                grads[:, v, 2] = l(x, a) * l(y, b) * dl(c)
    return vals, grads
