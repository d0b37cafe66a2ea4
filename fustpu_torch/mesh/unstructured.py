"""Unstructured conforming hexahedral meshes (explicit connectivity), as the
Gmsh import pipeline (``fustpu_torch.mesh.msh_io``) produces them.

DOF numbering: every cell tabulates its (n,n,n) GLL node coordinates via the
trilinear (or triquadratic) map; nodes are de-duplicated by tolerance
clustering of the physical coordinates (three nested sorts, tol ~1e-9 of
the bbox diagonal).  Two neighbouring cells restrict their maps to the same
function on a shared face, so shared nodes coincide up to roundoff and
always merge; distinct nodes of a valid conforming mesh are separated by
many orders more than the tolerance and never do.  The numbering is
orientation-free: cells may list their corners in any right-handed hex
order.

Cell order: `locality_order` picks the cell order of an imported
non-prismatic mesh (and with it the first-touch dof numbering) by the
window cost of ``fustpu_torch.mesh._window_cost``, as the JAX package
does, so that both packages number such a mesh identically.

Vendored from ``fustpu/mesh/unstructured.py`` (the port never imports the
JAX package).  `UPointSampler.torch_probe` is the counterpart of
``jax_probe``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from fustpu_torch.elements import gll
from fustpu_torch.elements.hex import FACETS, HexElement, hex8_tabulate

# reference facet -> the 4 corner ids (our 4a+2b+c convention) of that face
_FACET_CORNERS = []
for _axis, _side in FACETS:
    ids = []
    for a in (0, 1):
        for b in (0, 1):
            for c in (0, 1):
                abc = (a, b, c)
                if abc[_axis] == _side:
                    ids.append(4 * a + 2 * b + c)
    _FACET_CORNERS.append(tuple(ids))


def face_keys(cells: np.ndarray) -> np.ndarray:
    """(ncells, 6, 4) sorted corner-vertex ids of every cell face: the
    canonical face identity used for exterior-facet extraction and for
    matching tagged surface quads (fustpu_torch.mesh.msh_io)."""
    corners = np.asarray(_FACET_CORNERS)          # (6, 4)
    return np.sort(np.asarray(cells)[:, corners], axis=-1)


@dataclasses.dataclass(frozen=True)
class UnstructuredHexMesh:
    """Conforming hex mesh: vertices (nv, 3), cells (ncells, 8) corner
    indices in the 4a+2b+c convention, and facet tags
    {tag: (nf, 2) (cell, local_facet) arrays}."""

    degree: int
    vertices: np.ndarray                     # (nv, 3) float64
    cells: np.ndarray                        # (ncells, 8) int
    facet_tag_map: dict                      # tag -> (nf, 2) int32
    # optional isoparametric degree-2 coordinate map: (ncells, 27, 3)
    # triquadratic geometry nodes in internal TP order (9i+3j+k;
    # fustpu_torch.elements.hex.hex27_tabulate).  None = trilinear (hex8).
    geom_nodes: np.ndarray = None

    # ----- sizes ---------------------------------------------------------
    @property
    def element(self) -> HexElement:
        return HexElement(self.degree)

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def grid_shape(self) -> tuple[int]:
        """Flat DOF vector: an unstructured mesh has no node grid."""
        return (self.ndofs,)

    @property
    def ndofs(self) -> int:
        return self._numbering[1]

    @functools.cached_property
    def lo(self) -> tuple:
        """Bounding-box corner (plane/snapshot helpers)."""
        return tuple(self.vertices.min(axis=0))

    @functools.cached_property
    def hi(self) -> tuple:
        return tuple(self.vertices.max(axis=0))

    # ----- geometry ------------------------------------------------------
    @functools.cached_property
    def cell_corners_flat(self) -> np.ndarray:
        """(ncells, 8, 3) trilinear geometry dofs (precompute interface)."""
        return self.vertices[self.cells]

    def hmin(self) -> float:
        c = self.cell_corners_flat
        d = np.linalg.norm(c[:, :, None, :] - c[:, None, :, :], axis=-1)
        return float(d.max(axis=(1, 2)).min())

    def h_cfl(self) -> float:
        """sqrt(3) x smallest corner-pair distance (== diameter on a cube;
        binds on the thin direction of anisotropic cells, see
        BoxMesh.h_cfl)."""
        c = self.cell_corners_flat
        d = np.linalg.norm(c[:, :, None, :] - c[:, None, :, :], axis=-1)
        d[:, np.arange(8), np.arange(8)] = np.inf
        return float(np.sqrt(3.0) * d.min())

    @property
    def geom_degree(self) -> int:
        return 1 if self.geom_nodes is None else 2

    @functools.cached_property
    def _cell_nodes_phys(self) -> np.ndarray:
        """(ncells, n^3, 3) physical coordinates of every cell's GLL nodes
        (trilinear or triquadratic map of the reference lattice)."""
        elem = self.element
        # the collocated quadrature lattice is the (n,n,n) GLL node set
        if self.geom_nodes is not None:
            from fustpu_torch.elements.hex import hex27_tabulate

            vals, _ = hex27_tabulate(elem.quad_points)   # (n^3, 27)
            return np.einsum("qv,cvd->cqd", vals, self.geom_nodes,
                             optimize=True)
        vals, _ = hex8_tabulate(elem.quad_points)        # (n^3, 8)
        return np.einsum("qv,cvd->cqd", vals, self.cell_corners_flat,
                         optimize=True)

    @functools.cached_property
    def _cluster(self) -> tuple[np.ndarray, int]:
        """(cluster ids (ncells*n^3,) int64, nclusters) by merging
        coincident per-cell node coordinates; cell-order-equivariant (ids
        are coordinate-lexicographic).

        Tolerance clustering via three nested sorts (no quantisation grid,
        hence no bin-boundary straddle that could split a shared node):
        group where consecutive sorted x differ by <= tol, then subgroup
        by y within x-groups, then by z.  O(N log N)."""
        pts = self._cell_nodes_phys.reshape(-1, 3)
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        tol = (float(np.linalg.norm(hi - lo)) or 1.0) * 1e-9
        N = pts.shape[0]

        order = np.argsort(pts[:, 0], kind="stable")
        grp = np.empty(N, np.int64)
        brk = np.empty(N, bool)
        brk[0] = True
        np.greater(np.diff(pts[order, 0]), tol, out=brk[1:])
        np.cumsum(brk, out=grp)
        for axis in (1, 2):
            coord = pts[order, axis]
            o2 = np.lexsort((coord, grp))
            order = order[o2]
            gs, cs = grp[o2], coord[o2]
            brk[0] = True
            brk[1:] = (gs[1:] != gs[:-1]) | (np.diff(cs) > tol)
            np.cumsum(brk, out=grp)
        inverse = np.empty(N, np.int64)
        inverse[order] = grp - 1
        return inverse, int(grp[-1])

    @functools.cached_property
    def _numbering(self) -> tuple[np.ndarray, int]:
        """(dofmap (ncells, n^3) int32, ndofs): the `_cluster` ids
        relabelled by first touch in cell-major order, so consecutive
        cells' dofs get consecutive ids.  Deterministic."""
        inverse, ndofs = self._cluster
        dofmap = _first_touch(inverse, ndofs)
        return dofmap.reshape(self.num_cells, -1).astype(np.int32), ndofs

    @functools.cached_property
    def dofmap(self) -> np.ndarray:
        return self._numbering[0]

    @functools.cached_property
    def node_coords(self) -> np.ndarray:
        """(ndofs, 3) physical coordinates of the global DOFs."""
        out = np.zeros((self.ndofs, 3))
        out[self.dofmap.reshape(-1)] = self._cell_nodes_phys.reshape(-1, 3)
        return out

    # ----- facets --------------------------------------------------------
    def boundary_facets(self, tag=None) -> np.ndarray:
        """(nf, 2) (cell, local_facet) pairs: tagged set if `tag` given,
        else every exterior facet (faces owned by exactly one cell)."""
        if tag is not None:
            return np.asarray(self.facet_tag_map[tag], np.int32)
        return self._exterior_facets

    @functools.cached_property
    def _exterior_facets(self) -> np.ndarray:
        """Faces owned by exactly one cell, vectorised."""
        keys = face_keys(self.cells).reshape(-1, 4)
        order = np.lexsort(keys.T[::-1])
        sk = keys[order]
        new = np.ones(sk.shape[0], bool)
        new[1:] = np.any(sk[1:] != sk[:-1], axis=1)
        grp = np.cumsum(new) - 1
        counts = np.bincount(grp)
        ext_rows = order[counts[grp] == 1]
        cells, lf = ext_rows // 6, ext_rows % 6
        pairs = np.stack([cells, lf], axis=1).astype(np.int32)
        return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]

    def facet_dofmap(self, boundary_data: np.ndarray) -> np.ndarray:
        """(nf, n^2) global dofs of (cell, local_facet) pairs."""
        bd = np.asarray(boundary_data)
        local = self.element.all_facet_dofs[bd[:, 1]]     # (nf, n^2)
        return np.take_along_axis(self.dofmap[bd[:, 0]], local,
                                  axis=1).astype(np.int32)

    def facet_centroids(self, boundary_data: np.ndarray) -> np.ndarray:
        """(nf, 3) corner-mean centroid of each facet (for predicates)."""
        bd = np.asarray(boundary_data)
        corners = np.asarray(_FACET_CORNERS)[bd[:, 1]]    # (nf, 4)
        ids = np.take_along_axis(self.cells[bd[:, 0]], corners, axis=1)
        return self.vertices[ids].mean(axis=1)

    # ----- point location / evaluation ------------------------------------
    def locate(self, points: np.ndarray, tol: float = 1e-10):
        """(cells, xi, ok) for physical points: bbox candidate filter +
        trilinear Newton per candidate.  Host-side output path."""
        from fustpu_torch.utils.eval import _invert_trilinear

        pts = np.asarray(points, np.float64)
        corners = self.cell_corners_flat
        clo = corners.min(axis=1)                    # (ncells, 3)
        chi = corners.max(axis=1)
        pad = 1e-12 + 1e-9 * np.linalg.norm(chi - clo, axis=1,
                                            keepdims=True)
        cells = np.zeros(pts.shape[0], np.int64)
        xi = np.full((pts.shape[0], 3), 0.5)
        ok = np.zeros(pts.shape[0], bool)
        for p in range(pts.shape[0]):
            cand = np.nonzero(
                np.all((pts[p] >= clo - pad) & (pts[p] <= chi + pad),
                       axis=1))[0]
            for ci in cand:
                x = _invert_trilinear(corners[ci][None], pts[p][None])[0]
                if np.all((x >= -tol) & (x <= 1 + tol)):
                    cells[p], xi[p], ok[p] = ci, np.clip(x, 0, 1), True
                    break
        return cells, xi, ok

    def evaluate(self, field: np.ndarray, points: np.ndarray) -> np.ndarray:
        """Evaluate a flat DOF field at physical points; NaN outside."""
        field = np.asarray(field).reshape(-1)
        cells, xi, ok = self.locate(points)
        nodes = self.element.nodes_1d
        lx, _ = gll.lagrange_tabulate(nodes, xi[:, 0])
        ly, _ = gll.lagrange_tabulate(nodes, xi[:, 1])
        lz, _ = gll.lagrange_tabulate(nodes, xi[:, 2])
        vals = field[self.dofmap[cells]].reshape(
            cells.size, *(self.element.n,) * 3)
        out = np.einsum("pijk,pi,pj,pk->p", vals, lx, ly, lz,
                        optimize=True)
        out[~ok] = np.nan
        return out


def _first_touch(inverse: np.ndarray, ndofs: int) -> np.ndarray:
    """Relabel cluster ids by first occurrence order."""
    uniq, firstpos = np.unique(inverse, return_index=True)
    rank = np.empty(ndofs, np.int64)
    rank[uniq[np.argsort(firstpos)]] = np.arange(ndofs)
    return rank[inverse]


def reorder_cells(mesh: UnstructuredHexMesh,
                  perm: np.ndarray) -> UnstructuredHexMesh:
    """The same mesh with cells listed in `perm` order; facet tags and the
    quadratic coordinate map follow, and the first-touch dof numbering
    re-derives in the new order (a pure relabelling)."""
    perm = np.asarray(perm, np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    tags = {}
    for t, bd in mesh.facet_tag_map.items():
        bd = np.asarray(bd)
        tags[t] = np.column_stack(
            [inv[bd[:, 0]], bd[:, 1]]).astype(np.int32)
    out = dataclasses.replace(
        mesh, cells=mesh.cells[perm], facet_tag_map=tags,
        geom_nodes=(None if mesh.geom_nodes is None
                    else mesh.geom_nodes[perm]))
    if "_cluster" in mesh.__dict__:
        # the clustering is cell-order-equivariant: reuse it permuted
        inverse, ndofs = mesh._cluster
        out.__dict__["_cluster"] = (
            inverse.reshape(mesh.num_cells, -1)[perm].reshape(-1), ndofs)
    return out


def _rcm_order(mesh: UnstructuredHexMesh) -> np.ndarray | None:
    """Reverse Cuthill-McKee over the cell face-adjacency graph (one more
    `locality_order` candidate, for curved domains that no axis sweep
    bounds); None without scipy or without shared faces."""
    try:
        from scipy import sparse
        from scipy.sparse.csgraph import reverse_cuthill_mckee
    except ImportError:  # pragma: no cover - scipy is installed
        return None

    nc = mesh.num_cells
    fk = face_keys(mesh.cells).reshape(nc * 6, 4)
    order = np.lexsort(fk.T[::-1])
    sk = fk[order]
    same = np.all(sk[1:] == sk[:-1], axis=1)
    i = order[:-1][same] // 6
    j = order[1:][same] // 6
    if i.size == 0:
        return None
    A = sparse.coo_matrix(
        (np.ones(i.size * 2),
         (np.concatenate([i, j]), np.concatenate([j, i]))),
        shape=(nc, nc)).tocsr()
    return np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True),
                      np.int64)


def locality_order(mesh: UnstructuredHexMesh) -> UnstructuredHexMesh:
    """Reorder cells along the candidate order (the file order, a sweep
    along each axis, reverse Cuthill-McKee) of least window cost
    (``_window_cost.window_cost`` of the first-touch dofmap: window rows
    times windows, then spills); the file order is kept unless a candidate
    strictly improves on it."""
    from fustpu_torch.mesh._window_cost import window_cost

    inverse, ndofs = mesh._cluster
    inv2 = inverse.reshape(mesh.num_cells, -1)
    cent = mesh.vertices[mesh.cells].mean(axis=1)
    cands = [None]
    for ax in range(3):
        keys = tuple(cent[:, a] for a in range(3) if a != ax) \
            + (cent[:, ax],)
        cands.append(np.lexsort(keys))
    rcm = _rcm_order(mesh)
    if rcm is not None:
        cands.append(rcm)
    best, best_cost = None, None
    for perm in cands:
        flat = (inv2 if perm is None else inv2[perm]).reshape(-1)
        wr, nwin, spills = window_cost(_first_touch(flat, ndofs), ndofs)
        cost = (wr * nwin, spills)
        if best_cost is None or cost < best_cost:
            best, best_cost = perm, cost
    return mesh if best is None else reorder_cells(mesh, best)


class UPointSampler:
    """Repeated evaluation at a fixed point set on an unstructured mesh:
    location and Lagrange weights computed once; `torch_probe` returns a
    function for per-step hydrophone traces on the device.  Refuses
    unresolvable points loudly."""

    def __init__(self, mesh: UnstructuredHexMesh, points: np.ndarray):
        self.mesh = mesh
        self.points = np.asarray(points, np.float64)
        cells, xi, ok = mesh.locate(self.points)
        if not ok.all():
            bad = np.flatnonzero(~ok)
            raise ValueError(
                f"{bad.size} probe point(s) outside the mesh: "
                f"indices {bad[:8]}, first point {self.points[bad[0]]}")
        nodes = mesh.element.nodes_1d
        lx, _ = gll.lagrange_tabulate(nodes, xi[:, 0])
        ly, _ = gll.lagrange_tabulate(nodes, xi[:, 1])
        lz, _ = gll.lagrange_tabulate(nodes, xi[:, 2])
        n = mesh.element.n
        self._w = np.einsum("pi,pj,pk->pijk", lx, ly, lz,
                            optimize=True).reshape(cells.size, n**3)
        self._dofs = mesh.dofmap[cells]                 # (npts, n^3)

    def sample(self, field: np.ndarray) -> np.ndarray:
        f = np.asarray(field).reshape(-1)
        return np.einsum("pq,pq->p", f[self._dofs], self._w, optimize=True)

    def torch_probe(self, device):
        """f(u) -> (npts,) values at the points, for fields on `device`
        (the weights take the field's dtype)."""
        dofs = torch.as_tensor(self._dofs.astype(np.int64), device=device)
        w = torch.as_tensor(self._w, device=device)

        def probe(field: torch.Tensor) -> torch.Tensor:
            f = field.reshape(-1)
            return (f[dofs] * w.to(f.dtype)).sum(dim=1)

        return probe


def from_box(mesh, shuffle_seed: int | None = None) -> UnstructuredHexMesh:
    """Re-express a BoxMesh as an unstructured mesh (cross-validation:
    the unstructured paths on this mesh must reproduce the structured path
    up to summation order).  `shuffle_seed` permutes cell order and
    rotates corner orderings to exercise orientation independence."""
    nvx, nvy, nvz, _ = mesh.vertex_coords.shape
    verts = mesh.vertex_coords.reshape(-1, 3)
    ncx, ncy, ncz = mesh.nc
    vid = np.arange(nvx * nvy * nvz).reshape(nvx, nvy, nvz)
    cells = np.empty((mesh.num_cells, 8), np.int64)
    k = 0
    for i in range(ncx):
        for j in range(ncy):
            for l in range(ncz):
                for a in (0, 1):
                    for b in (0, 1):
                        for c in (0, 1):
                            cells[k, 4 * a + 2 * b + c] = vid[i + a, j + b,
                                                              l + c]
                k += 1
    if shuffle_seed is not None:
        rng = np.random.default_rng(shuffle_seed)
        cells = cells[rng.permutation(mesh.num_cells)]
        # rotate each cell 90 deg about z a random number of times
        # (a,b,c) -> (b, 1-a, c): corner id permutation
        rot = np.array([2, 3, 6, 7, 0, 1, 4, 5])  # one 90deg rotation
        for ci in range(cells.shape[0]):
            for _ in range(rng.integers(0, 4)):
                cells[ci] = cells[ci][rot]
    return UnstructuredHexMesh(degree=mesh.degree, vertices=verts,
                               cells=cells, facet_tag_map={})
