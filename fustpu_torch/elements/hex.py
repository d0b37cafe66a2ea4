"""Tensor-product GLL hexahedral element: DOF layout, facets, geometry basis.

Local dof (i, j, k) -> i*n^2 + j*n + k with i <-> xi_0, j <-> xi_1,
k <-> xi_2 on the unit reference cell [0,1]^3.  Quadrature is the collocated
GLL rule: quadrature point q = (i,j,k) coincides with dof (i,j,k), so the
mass matrix is diagonal and detJ is indexed by local dof.  Vendored from
``fustpu/elements/hex.py``: the trilinear (hex8) geometry basis, the
triquadratic (hex27) one of curved imported cells, and the full 3D basis
tabulation of the dense oracle (``fustpu_torch.oracle``).
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


def tabulate_3d_basis(element: HexElement, pts: np.ndarray):
    """Values (npts, n^3) and gradients (npts, n^3, 3) of the full
    tensor-product spectral basis at arbitrary reference points (the test
    oracle's; the hot path never tabulates 3D bases)."""
    n = element.n
    nodes = element.nodes_1d
    vx, dx = gll.lagrange_tabulate(nodes, pts[:, 0])
    vy, dy = gll.lagrange_tabulate(nodes, pts[:, 1])
    vz, dz = gll.lagrange_tabulate(nodes, pts[:, 2])
    vals = np.einsum("pi,pj,pk->pijk", vx, vy, vz).reshape(-1, n**3)
    g0 = np.einsum("pi,pj,pk->pijk", dx, vy, vz).reshape(-1, n**3)
    g1 = np.einsum("pi,pj,pk->pijk", vx, dy, vz).reshape(-1, n**3)
    g2 = np.einsum("pi,pj,pk->pijk", vx, vy, dz).reshape(-1, n**3)
    return vals, np.stack([g0, g1, g2], axis=-1)


# ---------------------------------------------------------------------------
# Triquadratic (hex27) geometry basis: isoparametric degree-2 coordinate maps
# (curved cells).  Internal node ordering is tensor-product lexicographic:
# node (i, j, k) with i, j, k in {0, 1, 2} at reference position
# (i/2, j/2, k/2), index 9i + 3j + k.
# ---------------------------------------------------------------------------

_Q3_NODES = np.array([0.0, 0.5, 1.0])


def hex27_tabulate(pts: np.ndarray):
    """Values (npts, 27) and gradients (npts, 27, 3) of the triquadratic
    Lagrange geometry basis, internal TP ordering 9i + 3j + k."""
    pts = np.asarray(pts, np.float64)
    vx, dx = gll.lagrange_tabulate(_Q3_NODES, pts[:, 0])
    vy, dy = gll.lagrange_tabulate(_Q3_NODES, pts[:, 1])
    vz, dz = gll.lagrange_tabulate(_Q3_NODES, pts[:, 2])
    vals = np.einsum("pi,pj,pk->pijk", vx, vy, vz).reshape(-1, 27)
    g0 = np.einsum("pi,pj,pk->pijk", dx, vy, vz).reshape(-1, 27)
    g1 = np.einsum("pi,pj,pk->pijk", vx, dy, vz).reshape(-1, 27)
    g2 = np.einsum("pi,pj,pk->pijk", vx, vy, dz).reshape(-1, 27)
    return vals, np.stack([g0, g1, g2], axis=-1)


# Gmsh 27-node hexahedron node order -> reference (u, v, w), from the Gmsh
# documentation's node numbering (corners, 12 edges, 6 faces, volume
# centre).  Used to permute imported hex27 connectivity into the internal
# TP ordering.
GMSH_HEX27_UVW = np.array([
    (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
    (.5, 0, 0), (0, .5, 0), (0, 0, .5), (1, .5, 0),
    (1, 0, .5), (.5, 1, 0), (1, 1, .5), (0, 1, .5),
    (.5, 0, 1), (0, .5, 1), (1, .5, 1), (.5, 1, 1),
    (.5, .5, 0), (.5, 0, .5), (0, .5, .5), (1, .5, .5),
    (.5, 1, .5), (.5, .5, 1), (.5, .5, .5),
], np.float64)

# internal_index = 9*(2u) + 3*(2v) + (2w); GMSH_HEX27_TO_TP[g] gives the
# internal slot of Gmsh node g
GMSH_HEX27_TO_TP = (9 * np.round(2 * GMSH_HEX27_UVW[:, 0])
                    + 3 * np.round(2 * GMSH_HEX27_UVW[:, 1])
                    + np.round(2 * GMSH_HEX27_UVW[:, 2])).astype(np.int64)
