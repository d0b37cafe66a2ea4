"""Setup-time geometry precomputation (host, numpy float64).

detJ[c, q]  = w_q * |det J(c, q)|
G[c, q, :]  = w_q * |det J| * upper-tri( J^{-T} J^{-1} )   (xx,xy,xz,yy,yz,zz)
detJ_f[f,q] = w_q * |t_s x t_t|   on boundary facets

Quadrature points are the collocated GLL lattice, so q is also the local dof
index.  Vendored from ``fustpu/ops/precompute.py``: the numpy path for
trilinear cells and for isoparametric hex27 maps (curved imported cells;
the mesh then carries ``geom_nodes``).  No native library.
"""

from __future__ import annotations

import numpy as np

from fustpu_torch.elements.hex import FACETS, hex8_tabulate, hex27_tabulate

_CHUNK = 16384  # cells per chunk to bound peak memory of (c, q, 3, 3) temps


def _geom_dofs_grads(mesh, pts: np.ndarray):
    """(geometry dofs (cells, ng, 3), reference gradients (nq, ng, 3)) for
    the mesh's coordinate map: trilinear hex8 by default, the
    isoparametric triquadratic hex27 map when the mesh carries
    geom_nodes."""
    gn = getattr(mesh, "geom_nodes", None)
    if gn is not None:
        return gn, hex27_tabulate(pts)[1]
    return mesh.cell_corners_flat, hex8_tabulate(pts)[1]


def _jacobians(corners: np.ndarray, grads: np.ndarray) -> np.ndarray:
    """J[c, q, phys, ref] of a cell map.

    corners: (cells, ng, 3) geometry dofs (8 trilinear, 27 hex27);
    grads: (nq, ng, 3) reference gradients.
    """
    return np.einsum("cvp,qvr->cqpr", corners, grads, optimize=True)


def congruence_groups(corners: np.ndarray, max_frac: float = 0.25,
                      tol_rel: float = 1e-13):
    """Group cells congruent up to translation (J, detJ and G depend only
    on corner displacements).  Structured and graded boxes have a handful
    of distinct cell shapes, so the geometry precompute collapses to the
    unique set plus a broadcast.

    Returns (inv (cells,), rep (nuniq,)) with corners[rep][inv] congruent
    to corners, or None when the mesh has too many distinct shapes for
    dedup to pay (> max_frac of cells, e.g. perturbed or mapped meshes).
    Signatures are tolerance-rounded (tol_rel of the largest coordinate)
    and matched via two independent 64-bit hashes."""
    c = np.asarray(corners, np.float64)
    nc = c.shape[0]
    d = (c - c[:, :1, :]).reshape(nc, 24)
    # displacements are differences of O(domain) coordinates, so their
    # float64 jitter is eps * |x|, not eps * |d|
    scale = float(np.abs(c).max()) or 1.0
    rint = np.round(d * (1.0 / (tol_rel * scale))).astype(np.int64)
    rng = np.random.default_rng(0x5EED)
    rv = rng.integers(1, 2**62, size=(24, 2), dtype=np.int64)
    with np.errstate(over="ignore"):
        keys = rint @ rv                       # wraps mod 2^64
    order = np.lexsort((keys[:, 1], keys[:, 0]))
    k = keys[order]
    new = np.ones(nc, bool)
    new[1:] = (k[1:] != k[:-1]).any(axis=1)
    gid_sorted = np.cumsum(new) - 1
    nuniq = int(gid_sorted[-1]) + 1
    if nuniq > max_frac * nc:
        return None
    inv = np.empty(nc, np.int64)
    inv[order] = gid_sorted
    rep = np.empty(nuniq, np.int64)
    rep[gid_sorted[::-1]] = order[::-1]        # first index per group
    return inv, rep


class _CornerSubset:
    """The unique-shape subset of a mesh, as the precompute sees it."""

    def __init__(self, corners, element):
        self.cell_corners_flat = corners
        self.element = element


def cell_geometry_factors(mesh, dedup: bool = True):
    """Returns (detJ, G) with detJ (cells, nq) and G (cells, nq, 6);
    congruent cells (translation copies) are computed once and
    broadcast."""
    elem = mesh.element
    if getattr(mesh, "geom_nodes", None) is not None:
        return _cell_geometry_curved(mesh)
    corners = mesh.cell_corners_flat                 # (cells, 8, 3)
    if dedup and corners.shape[0] > 4096:
        grp = congruence_groups(corners)
        if grp is not None:
            inv, rep = grp
            dJ_u, G_u = cell_geometry_factors(
                _CornerSubset(corners[rep], elem), dedup=False)
            return dJ_u[inv], G_u[inv]
    _, grads = hex8_tabulate(elem.quad_points)       # (nq, 8, 3)
    wts = elem.quad_weights                          # (nq,)
    nc, nq = corners.shape[0], wts.size
    detJ = np.empty((nc, nq))
    G = np.empty((nc, nq, 6))
    for s in range(0, nc, _CHUNK):
        e = min(s + _CHUNK, nc)
        J = _jacobians(corners[s:e], grads)          # (c, q, 3, 3)
        det = np.linalg.det(J)
        detJ[s:e] = np.abs(det) * wts
        Jinv = np.linalg.inv(J)                      # J^{-1}[c,q,ref,phys]
        # K[r, s] = sum_p (dxi_r/dx_p)(dxi_s/dx_p): the metric that maps
        # reference gradients so that grad_x u . grad_x v = grad_xi u K grad_xi v.
        K = np.einsum("cqrp,cqsp->cqrs", Jinv, Jinv, optimize=True)
        G[s:e, :, 0] = K[..., 0, 0] * detJ[s:e]
        G[s:e, :, 1] = K[..., 0, 1] * detJ[s:e]
        G[s:e, :, 2] = K[..., 0, 2] * detJ[s:e]
        G[s:e, :, 3] = K[..., 1, 1] * detJ[s:e]
        G[s:e, :, 4] = K[..., 1, 2] * detJ[s:e]
        G[s:e, :, 5] = K[..., 2, 2] * detJ[s:e]
        del J, det, Jinv, K
    return detJ, G


def _det3(J: np.ndarray) -> np.ndarray:
    """Explicit batched 3x3 determinant (elementwise arithmetic, faster than
    np.linalg.det on large (N, 3, 3) batches)."""
    return (J[..., 0, 0] * (J[..., 1, 1] * J[..., 2, 2]
                            - J[..., 1, 2] * J[..., 2, 1])
            - J[..., 0, 1] * (J[..., 1, 0] * J[..., 2, 2]
                              - J[..., 1, 2] * J[..., 2, 0])
            + J[..., 0, 2] * (J[..., 1, 0] * J[..., 2, 1]
                              - J[..., 1, 1] * J[..., 2, 0]))


def cell_detJ(mesh, dedup: bool = True) -> np.ndarray:
    """detJ only (cells, nq), for mass-type setup where the 6-component
    metric G (6x the memory, plus a batched inverse) is not needed: the
    trilinear map, or the hex27 map when the mesh carries geom_nodes."""
    elem = mesh.element
    gdofs, grads = _geom_dofs_grads(mesh, elem.quad_points)
    wts = elem.quad_weights
    nc = gdofs.shape[0]
    curved = getattr(mesh, "geom_nodes", None) is not None
    if dedup and not curved and nc > 4096:
        grp = congruence_groups(gdofs)
        if grp is not None:
            inv, rep = grp
            return cell_detJ(_CornerSubset(gdofs[rep], elem),
                             dedup=False)[inv]
    detJ = np.empty((nc, wts.size))
    for s in range(0, nc, _CHUNK):
        e = min(s + _CHUNK, nc)
        J = _jacobians(gdofs[s:e], grads)
        detJ[s:e] = np.abs(_det3(J)) * wts
    return detJ


def _cell_geometry_curved(mesh):
    """(detJ, G) for isoparametric (hex27) cells: chunked batched numpy,
    the trilinear path's math with the quadratic map's Jacobians."""
    elem = mesh.element
    gdofs, grads = _geom_dofs_grads(mesh, elem.quad_points)
    wts = elem.quad_weights
    nc, nq = gdofs.shape[0], wts.size
    detJ = np.empty((nc, nq))
    G = np.empty((nc, nq, 6))
    for s in range(0, nc, _CHUNK):
        e = min(s + _CHUNK, nc)
        J = np.einsum("cvp,qvr->cqpr", gdofs[s:e], grads, optimize=True)
        detJ[s:e] = np.abs(_det3(J)) * wts
        Jinv = np.linalg.inv(J)
        K = np.einsum("cqrp,cqsp->cqrs", Jinv, Jinv, optimize=True)
        for m, (r_, s_) in enumerate(
                [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]):
            G[s:e, :, m] = K[..., r_, s_] * detJ[s:e]
        del J, Jinv, K
    return detJ, G


def facet_geometry_factors(mesh, boundary_data: np.ndarray) -> np.ndarray:
    """detJ_f (nf, n^2): surface measure * weights at facet GLL points for
    (cell, local_facet) pairs."""
    elem = mesh.element
    wts_f = elem.facet_quad_weights                  # (n^2,)
    nf = boundary_data.shape[0]
    detJ_f = np.empty((nf, wts_f.size))
    # tabulate the geometry gradients at the facet quadrature points of each
    # reference facet once, then process facets grouped by local facet id
    for lf in range(6):
        sel = np.nonzero(boundary_data[:, 1] == lf)[0]
        if sel.size == 0:
            continue
        gdofs, grads = _geom_dofs_grads(mesh, elem.facet_quad_points(lf))
        axis, _ = FACETS[lf]
        free = [ax for ax in range(3) if ax != axis]
        J = _jacobians(gdofs[boundary_data[sel, 0]], grads)
        t1 = J[..., free[0]]                         # (f, q, 3)
        t2 = J[..., free[1]]
        nrm = np.linalg.norm(np.cross(t1, t2), axis=-1)
        detJ_f[sel] = nrm * wts_f
    return detJ_f
