"""Setup-time geometry precomputation (host, numpy float64).

detJ[c, q]  = w_q * |det J(c, q)|
G[c, q, :]  = w_q * |det J| * upper-tri( J^{-T} J^{-1} )   (xx,xy,xz,yy,yz,zz)
detJ_f[f,q] = w_q * |t_s x t_t|   on boundary facets

Quadrature points are the collocated GLL lattice, so q is also the local dof
index.  Vendored from ``fustpu/ops/precompute.py``: trilinear cells and
isoparametric hex27 maps (curved imported cells; the mesh then carries
``geom_nodes``), in vectorised numpy with the arithmetic of the JAX
package's native geometry (``native/fustpu_native.cpp``: cofactor
determinant and inverse).  These are the plain versions of the set-up
kernels (``ops/cuda_setup.py``), which a model built on the card runs
instead.
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
    """Returns (detJ, G) with detJ (cells, nq) and G (cells, nq, 6), for
    the trilinear map or the hex27 map when the mesh carries geom_nodes;
    congruent trilinear cells (translation copies) are computed once and
    broadcast."""
    elem = mesh.element
    gdofs, grads = _geom_dofs_grads(mesh, elem.quad_points)
    curved = getattr(mesh, "geom_nodes", None) is not None
    if dedup and not curved and gdofs.shape[0] > 4096:
        grp = congruence_groups(gdofs)
        if grp is not None:
            inv, rep = grp
            dJ_u, G_u = cell_geometry_factors(
                _CornerSubset(gdofs[rep], elem), dedup=False)
            return dJ_u[inv], G_u[inv]
    return geometry_of(gdofs, grads, elem.quad_weights)


def geometry_of(gdofs: np.ndarray, grads: np.ndarray, wts: np.ndarray):
    """(detJ (cells, nq), G (cells, nq, 6)) of cells with geometry dofs
    `gdofs` (cells, ng, 3), the reference gradients `grads` (nq, ng, 3)
    and the weights `wts` (nq,): the plain version of the set-up kernel
    ``cuda_setup.cell_geometry``."""
    nc, nq = gdofs.shape[0], wts.size
    detJ = np.empty((nc, nq))
    G = np.empty((nc, nq, 6))
    for s in range(0, nc, _CHUNK):
        e = min(s + _CHUNK, nc)
        detJ[s:e], G[s:e] = _metric(_jacobians(gdofs[s:e], grads), wts)
    return detJ, G


def _metric(J: np.ndarray, wts: np.ndarray):
    """(detJ, G) from the Jacobians J[c, q, phys, ref], elementwise, in the
    JAX package's native geometry's arithmetic: det by cofactors,
    J^{-1} = adj(J) / det, K = J^{-1} J^{-T} (K[r, s] = sum_p
    (dxi_r/dx_p)(dxi_s/dx_p), the metric that maps reference gradients so
    that grad_x u . grad_x v = grad_xi u K grad_xi v), G = w |det| K.
    A batched LAPACK inverse of the same Jacobians takes ~5x longer."""
    a = lambda p, r: J[..., p, r]
    det = _det3(J)
    sd = np.abs(det) * wts
    idet = 1.0 / det
    Ji = [[(a(1, 1) * a(2, 2) - a(1, 2) * a(2, 1)) * idet,
           (a(0, 2) * a(2, 1) - a(0, 1) * a(2, 2)) * idet,
           (a(0, 1) * a(1, 2) - a(0, 2) * a(1, 1)) * idet],
          [(a(1, 2) * a(2, 0) - a(1, 0) * a(2, 2)) * idet,
           (a(0, 0) * a(2, 2) - a(0, 2) * a(2, 0)) * idet,
           (a(0, 2) * a(1, 0) - a(0, 0) * a(1, 2)) * idet],
          [(a(1, 0) * a(2, 1) - a(1, 1) * a(2, 0)) * idet,
           (a(0, 1) * a(2, 0) - a(0, 0) * a(2, 1)) * idet,
           (a(0, 0) * a(1, 1) - a(0, 1) * a(1, 0)) * idet]]
    G = np.empty(J.shape[:2] + (6,))
    for m, (r, t) in enumerate([(0, 0), (0, 1), (0, 2), (1, 1), (1, 2),
                                (2, 2)]):
        G[..., m] = (Ji[r][0] * Ji[t][0] + Ji[r][1] * Ji[t][1]
                     + Ji[r][2] * Ji[t][2]) * sd
    return sd, G


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
    nc = gdofs.shape[0]
    curved = getattr(mesh, "geom_nodes", None) is not None
    if dedup and not curved and nc > 4096:
        grp = congruence_groups(gdofs)
        if grp is not None:
            inv, rep = grp
            return cell_detJ(_CornerSubset(gdofs[rep], elem),
                             dedup=False)[inv]
    return detJ_of(gdofs, grads, elem.quad_weights)


def detJ_of(gdofs: np.ndarray, grads: np.ndarray,
            wts: np.ndarray) -> np.ndarray:
    """detJ (cells, nq) alone, as `geometry_of` takes its arguments: the
    plain version of ``cuda_setup.cell_geometry(..., with_G=False)``."""
    detJ = np.empty((gdofs.shape[0], wts.size))
    for s in range(0, gdofs.shape[0], _CHUNK):
        e = min(s + _CHUNK, gdofs.shape[0])
        J = _jacobians(gdofs[s:e], grads)
        detJ[s:e] = np.abs(_det3(J)) * wts
    return detJ


def facet_geometry_factors(mesh, boundary_data: np.ndarray) -> np.ndarray:
    """detJ_f (nf, n^2): surface measure * weights at facet GLL points for
    (cell, local_facet) pairs."""
    gdofs, fgrads = facet_grads(mesh)
    return facet_geometry_of(gdofs, fgrads, mesh.element.facet_quad_weights,
                             boundary_data)


def facet_grads(mesh):
    """(geometry dofs (cells, ng, 3), reference gradients (6, n^2, ng, 3)
    at the quadrature points of each local facet)."""
    elem = mesh.element
    grads = [_geom_dofs_grads(mesh, elem.facet_quad_points(lf))
             for lf in range(6)]
    return grads[0][0], np.stack([g for _, g in grads])


def facet_geometry_of(gdofs: np.ndarray, fgrads: np.ndarray,
                      wts_f: np.ndarray,
                      boundary_data: np.ndarray) -> np.ndarray:
    """detJ_f (nf, n^2) of the (cell, local facet) pairs `boundary_data`
    from `facet_grads`' arrays: the plain version of the set-up kernel
    ``cuda_setup.facet_geometry``."""
    boundary_data = np.asarray(boundary_data).reshape(-1, 2)
    nf = boundary_data.shape[0]
    detJ_f = np.empty((nf, wts_f.size))
    # the facets grouped by local facet id, each group with the gradients
    # at its reference facet's points
    for lf in range(6):
        sel = np.nonzero(boundary_data[:, 1] == lf)[0]
        if sel.size == 0:
            continue
        axis, _ = FACETS[lf]
        free = [ax for ax in range(3) if ax != axis]
        J = _jacobians(gdofs[boundary_data[sel, 0]], fgrads[lf])
        t1 = J[..., free[0]]                         # (f, q, 3)
        t2 = J[..., free[1]]
        nrm = np.linalg.norm(np.cross(t1, t2), axis=-1)
        detJ_f[sel] = nrm * wts_f
    return detJ_f


def h_cfl(corners: np.ndarray) -> float:
    """sqrt(3) x the smallest corner-pair distance over the cells `corners`
    (cells, 8, 3), in chunks of _CHUNK cells: the all-pairs differences of
    every cell at once held ~3.8 KB a cell of host memory (~8 GB at the
    2,082,304-cell capacity box)."""
    off = ~np.eye(8, dtype=bool)
    best = np.inf
    for s in range(0, corners.shape[0], _CHUNK):
        c = corners[s:s + _CHUNK]
        d = np.linalg.norm(c[:, :, None, :] - c[:, None, :, :], axis=-1)
        best = min(best, float(d[:, off].min()))
    return float(np.sqrt(3.0) * best)


def to_structured_layout(arr_cells: np.ndarray, mesh) -> np.ndarray:
    """(cells, n^3, ...) -> the expanded (ncx, n, ncy, n, ncz, n, ...)
    layout of the windowed structured operators
    (``fustpu_torch.ops.operators``) on a box mesh."""
    n = mesh.element.n
    ncx, ncy, ncz = mesh.nc
    trailing = arr_cells.shape[2:]
    a = arr_cells.reshape(ncx, ncy, ncz, n, n, n, *trailing)
    return np.ascontiguousarray(a.transpose(0, 3, 1, 4, 2, 5,
                                            *range(6, 6 + len(trailing))))
