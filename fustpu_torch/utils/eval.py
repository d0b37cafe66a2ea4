"""Point evaluation of spectral-element fields at arbitrary physical points
(host numpy, the output path).

On a structured box the owning cell is a floor-divide; on perturbed or
mapped (trilinear) geometry the reference coordinates are recovered with a
few Newton iterations of the trilinear map plus a cell walk; evaluation is
tensor-product Lagrange interpolation.  Vendored from
``fustpu/utils/eval.py`` (without the JAX probe).
"""

from __future__ import annotations

import numpy as np

from fustpu_torch.elements import gll
from fustpu_torch.elements.hex import hex8_tabulate


def locate_cells(mesh, points: np.ndarray) -> np.ndarray:
    """(npts, 3) physical points -> (npts,) flat cell indices (clipped into
    the domain).  Assumes the unperturbed lattice for the initial guess;
    Newton in `locate` corrects for perturbed geometry."""
    pts = np.asarray(points, dtype=np.float64)
    lo, hi = np.array(mesh.lo), np.array(mesh.hi)
    nc = np.array(mesh.nc)
    h = (hi - lo) / nc
    idx = np.floor((pts - lo) / h).astype(np.int64)
    idx = np.clip(idx, 0, nc - 1)
    return idx[:, 0] * nc[1] * nc[2] + idx[:, 1] * nc[2] + idx[:, 2]


def _invert_trilinear(corners: np.ndarray, pts: np.ndarray,
                      iters: int = 8) -> np.ndarray:
    """Newton-invert the trilinear map per point.  corners: (npts, 8, 3);
    pts: (npts, 3) -> reference coords (npts, 3)."""
    xi = np.full_like(pts, 0.5)
    for _ in range(iters):
        vals, grads = hex8_tabulate(xi)
        xcur = np.einsum("pv,pvd->pd", vals, corners)
        J = np.einsum("pvd,pvr->pdr", corners, grads)
        r = pts - xcur
        dxi = np.linalg.solve(J, r[..., None])[..., 0]
        xi = xi + dxi
        if np.max(np.abs(dxi)) < 1e-14:
            break
    return xi


def locate(mesh, points: np.ndarray, tol: float = 1e-10):
    """Resolve owning cells and reference coordinates for physical points
    (Newton + cell walk, bounded by the grid diameter).  Returns
    (cells, xi, ok); `ok` is False for points whose reference coordinates
    never converged into [0, 1] (outside the mapped domain)."""
    pts = np.asarray(points, dtype=np.float64)
    nc_arr = np.array(mesh.nc)
    cells = locate_cells(mesh, pts)
    max_hops = int(nc_arr.sum()) + 2           # grid diameter bound
    xi = np.full((pts.shape[0], 3), 0.5)
    for _ in range(max_hops):
        corners = mesh.cell_corners_flat[cells]
        xi = _invert_trilinear(corners, pts)
        out_lo = xi < -tol
        out_hi = xi > 1 + tol
        if not (out_lo.any() or out_hi.any()):
            break
        cz = cells % nc_arr[2]
        cy = (cells // nc_arr[2]) % nc_arr[1]
        cx = cells // (nc_arr[1] * nc_arr[2])
        cidx = np.stack([cx, cy, cz], axis=1)
        moved = np.clip(cidx - out_lo + out_hi, 0, nc_arr - 1)
        if np.array_equal(moved, cidx):        # stuck at the boundary
            break
        cidx = moved
        cells = cidx[:, 0] * nc_arr[1] * nc_arr[2] + cidx[:, 1] * nc_arr[2] \
            + cidx[:, 2]
    ok = np.all((xi >= -tol) & (xi <= 1 + tol), axis=1)
    return cells, np.clip(xi, 0.0, 1.0), ok


def _cell_node_index(mesh, cells: np.ndarray):
    """Per-point grid indices (I, J, K), each (npts, n), of the owning
    cell's nodes."""
    n = mesh.element.n
    P = mesh.degree
    nc = np.array(mesh.nc)
    cz = cells % nc[2]
    cy = (cells // nc[2]) % nc[1]
    cx = cells // (nc[1] * nc[2])
    return (cx[:, None] * P + np.arange(n)[None, :],
            cy[:, None] * P + np.arange(n)[None, :],
            cz[:, None] * P + np.arange(n)[None, :])


def _lagrange_weights(mesh, xi: np.ndarray) -> np.ndarray:
    nodes = mesh.element.nodes_1d
    lx, _ = gll.lagrange_tabulate(nodes, xi[:, 0])
    ly, _ = gll.lagrange_tabulate(nodes, xi[:, 1])
    lz, _ = gll.lagrange_tabulate(nodes, xi[:, 2])
    return np.einsum("pi,pj,pk->pijk", lx, ly, lz, optimize=True)


def evaluate(mesh, field: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Evaluate a node-grid field (gx, gy, gz) at physical points (npts, 3).
    Points that cannot be resolved to a cell evaluate to NaN."""
    pts = np.asarray(points, dtype=np.float64)
    field = np.asarray(field).reshape(mesh.grid_shape)
    cells, xi, ok = locate(mesh, pts)
    I, J, K = _cell_node_index(mesh, cells)
    vals = field[I[:, :, None, None], J[:, None, :, None], K[:, None, None, :]]
    out = np.einsum("pijk,pijk->p", vals, _lagrange_weights(mesh, xi),
                    optimize=True)
    out[~ok] = np.nan
    return out


class PointSampler:
    """Repeated evaluation at a fixed point set: cell location, Newton
    inversion and Lagrange weights are computed once; each `sample` is a
    gather + weighted sum."""

    def __init__(self, mesh, points: np.ndarray):
        self.mesh = mesh
        self.points = np.asarray(points, dtype=np.float64)
        cells, xi, ok = locate(mesh, self.points)
        if not ok.all():
            bad = np.flatnonzero(~ok)
            raise ValueError(
                f"{bad.size} probe point(s) could not be resolved to a "
                f"cell (outside the mapped domain?): indices {bad[:8]}, "
                f"first point {self.points[bad[0]]}")
        self._w = _lagrange_weights(mesh, xi)
        self._I, self._J, self._K = _cell_node_index(mesh, cells)

    def sample(self, field: np.ndarray) -> np.ndarray:
        field = np.asarray(field).reshape(self.mesh.grid_shape)
        vals = field[self._I[:, :, None, None], self._J[:, None, :, None],
                     self._K[:, None, None, :]]
        return np.einsum("pijk,pijk->p", vals, self._w, optimize=True)


def plane_points(mesh, axis: int, coord: float, n0: int, n1: int
                 ) -> np.ndarray:
    lo, hi = np.array(mesh.lo), np.array(mesh.hi)
    free = [a for a in range(3) if a != axis]
    s0 = np.linspace(lo[free[0]], hi[free[0]], n0)
    s1 = np.linspace(lo[free[1]], hi[free[1]], n1)
    A, B = np.meshgrid(s0, s1, indexing="ij")
    pts = np.zeros((n0 * n1, 3))
    pts[:, axis] = coord
    pts[:, free[0]] = A.ravel()
    pts[:, free[1]] = B.ravel()
    return pts
