"""Topologically-extruded unstructured hex meshes (2D-unstructured x
structured-z): the fast path for imported meshes.

Imported focused-ultrasound meshes are mostly prisms: every practical
piston, column or bowl-fitted mesh extrudes a 2D unstructured quad mesh
through layers.  For prismatic topology the dofmap factorizes:

    dof(stack, (i, j), z) = row2d[stack, i*n+j] * gz + z,   gz = nz*P + 1

so the gather and scatter are row operations, and the stiffness kernel
(``fustpu_torch/csrc/extruded.cu``) reads and writes the field through the
per-stack row ids itself.  Geometry stays fully general (curved layer
surfaces, graded layer heights, arbitrary 2D footprints, curved hex27
cells): the 6-component G captures it; only the topology must be an
extrusion.

`as_extruded` detects the structure in any UnstructuredHexMesh
(orientation-free: cells may list corners in any rotation) and
canonicalizes cells so the local c-bit is the ascending extrusion axis.
Vendored from ``fustpu/mesh/extruded.py``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from fustpu_torch.mesh.unstructured import (_FACET_CORNERS,
                                            UnstructuredHexMesh, face_keys)


def cluster_points(pts: np.ndarray, tol: float):
    """Tolerance-cluster rows of (N, d) coordinates via nested stable
    sorts (the UnstructuredHexMesh._cluster machinery).  Returns
    (ids (N,) int64 in coordinate-lexicographic order, count)."""
    pts = np.asarray(pts, np.float64)
    N = pts.shape[0]
    order = np.argsort(pts[:, 0], kind="stable")
    grp = np.empty(N, np.int64)
    brk = np.empty(N, bool)
    brk[0] = True
    np.greater(np.diff(pts[order, 0]), tol, out=brk[1:])
    np.cumsum(brk, out=grp)
    for axis in range(1, pts.shape[1]):
        coord = pts[order, axis]
        o2 = np.lexsort((coord, grp))
        order = order[o2]
        gs, cs = grp[o2], coord[o2]
        brk[0] = True
        brk[1:] = (gs[1:] != gs[:-1]) | (np.diff(cs) > tol)
        np.cumsum(brk, out=grp)
    ids = np.empty(N, np.int64)
    ids[order] = grp - 1
    return ids, int(grp[-1])


@dataclasses.dataclass(frozen=True)
class ExtrudedHexMesh(UnstructuredHexMesh):
    """UnstructuredHexMesh whose cells are canonicalized prisms.

    Extra structure: cells grouped into stacks (one cell per layer), a
    shared per-stack 2D row map, and the factorized DOF numbering
    dof = row2d * gz + zidx.  All UnstructuredHexMesh API (facets, point
    location, dofmap) keeps working."""

    stack_cells: np.ndarray = None   # (nstacks, nz) cell id per layer
    rows2d: np.ndarray = None        # (nstacks, n^2) 2D row ids, (i,j) order
    n2d: int = 0                     # number of 2D rows
    nz: int = 0                      # layers
    axis: int = 2                    # physical extrusion axis (0/1/2)

    @property
    def nstacks(self) -> int:
        return self.stack_cells.shape[0]

    @property
    def gz(self) -> int:
        return self.nz * self.degree + 1

    @functools.cached_property
    def _numbering(self):
        """Factorized dofmap: dof = row2d*gz + kz*P + k, local (i, j, k)
        TP-ordered (c-bit of the canonical cells is ascending z)."""
        n = self.degree + 1
        P = self.degree
        gz = self.gz
        rows = self.rows2d.astype(np.int64)           # (ns, n^2)
        dofmap = np.empty((self.num_cells, n**3), np.int32)
        kloc = np.arange(n)
        for kz in range(self.nz):
            blk = rows[:, :, None] * gz + (kz * P + kloc)   # (ns, n^2, n)
            dofmap[self.stack_cells[:, kz]] = blk.reshape(rows.shape[0], -1)
        return dofmap, self.n2d * gz


_AXIS_PAIRS = {  # corner-id pairs differing only in the given bit
    0: [(0, 4), (1, 5), (2, 6), (3, 7)],
    1: [(0, 2), (1, 3), (4, 6), (5, 7)],
    2: [(0, 1), (2, 3), (4, 5), (6, 7)],
}


def as_extruded(mesh: UnstructuredHexMesh,
                tol_rel: float = 1e-9) -> ExtrudedHexMesh | None:
    """Detect prismatic topology along any coordinate axis; returns the
    canonicalized ExtrudedHexMesh or None if the mesh is no extrusion.
    Orientation free: each cell's vertical axis is found independently;
    cells are rebuilt from (column, rank) so a whole stack shares one
    footprint orientation.  Layers may be curved (the axis coordinate
    varies within a layer, e.g. a bowl-cap-fitted face) and graded; only
    the transverse coordinates must be constant along each vertex
    column."""
    for axis in (2, 0, 1):
        ex = _as_extruded_axis(mesh, axis, tol_rel)
        if ex is not None:
            return ex
    return None


def _as_extruded_axis(mesh: UnstructuredHexMesh, axis: int,
                      tol_rel: float) -> ExtrudedHexMesh | None:
    verts = np.asarray(mesh.vertices, np.float64)
    cells = np.asarray(mesh.cells)
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    tol = (float(np.linalg.norm(hi - lo)) or 1.0) * tol_rel
    tr = [d for d in range(3) if d != axis]           # transverse axes

    # cluster only vertices referenced by cells (imported files may carry
    # orphan nodes from point/line elements; they must not break the
    # column structure)
    used = np.zeros(len(verts), bool)
    used[cells.reshape(-1)] = True
    uidx = np.nonzero(used)[0]
    col_of_used, ncols = cluster_points(verts[uidx][:, tr], tol)
    col_id = np.full(len(verts), -1, np.int64)
    col_id[uidx] = col_of_used
    counts = np.bincount(col_of_used, minlength=ncols)
    if counts.min() != counts.max() or counts[0] < 2:
        return None
    nvz = int(counts[0])
    nz = nvz - 1
    # rank of each used vertex within its column (by the axis coordinate)
    order = uidx[np.lexsort((verts[uidx, axis], col_of_used))]
    rank = np.full(len(verts), -1, np.int64)
    rank[order] = np.arange(len(uidx)) - np.repeat(
        np.arange(ncols) * nvz, nvz)
    # (column, rank) -> vertex id
    vtab = np.empty((ncols, nvz), np.int64)
    vtab[col_id[order], rank[order]] = order

    colc = col_id[cells]                              # (nc, 8)
    rankc = rank[cells]
    nc = cells.shape[0]
    layer = np.full(nc, -1, np.int64)
    foot_cols = np.empty((nc, 2, 2), np.int64)        # footprint by (a, b)
    found = np.zeros(nc, bool)
    for beta in (2, 0, 1):                            # c-bit most common
        pairs = _AXIS_PAIRS[beta]
        lo_ids = np.array([p[0] for p in pairs])
        hi_ids = np.array([p[1] for p in pairs])
        same_col = (colc[:, lo_ids] == colc[:, hi_ids]).all(axis=1)
        dr = rankc[:, hi_ids] - rankc[:, lo_ids]
        up = (dr == 1).all(axis=1)
        down = (dr == -1).all(axis=1)
        base_rank = np.where(down[:, None], rankc[:, hi_ids],
                             rankc[:, lo_ids])
        flat = (base_rank == base_rank[:, :1]).all(axis=1)
        ok = same_col & (up | down) & flat & ~found
        if not ok.any():
            continue
        found |= ok
        sel = np.nonzero(ok)[0]
        low = np.where(down[sel, None], hi_ids[None, :], lo_ids[None, :])
        lowc = np.take_along_axis(colc[sel], low, axis=1)   # (k, 4)
        layer[sel] = np.where(down[sel], rankc[sel, hi_ids[0]],
                              rankc[sel, lo_ids[0]])
        # the 4 low corners in pair order: for beta the pair list runs
        # over the other two bits in (higher-bit, lower-bit) order
        foot_cols[sel] = lowc.reshape(-1, 2, 2)
    if not found.all():
        return None

    # stacks: cells sharing a footprint (as a set), one per layer
    foot_sorted = np.sort(foot_cols.reshape(nc, 4), axis=1)
    stack_of, nstacks = _group_rows(foot_sorted)
    if nstacks * nz != nc:
        return None
    scount = np.bincount(stack_of, minlength=nstacks)
    if scount.min() != scount.max():
        return None
    stack_cells = np.empty((nstacks, nz), np.int64)
    seen = np.zeros((nstacks, nz), bool)
    if layer.min() < 0 or layer.max() >= nz:
        return None
    stack_cells[stack_of, layer] = np.arange(nc)
    seen[stack_of, layer] = True
    if not seen.all():
        return None

    # rebuild every cell from (column, rank): the whole stack inherits
    # the layer-0 cell's footprint orientation, making the c-bit the
    # ascending axis everywhere
    foot = foot_cols[stack_cells[:, 0]]               # (ns, 2, 2)
    cells_canon = np.empty((nc, 8), np.int64)
    for a in (0, 1):
        for b in (0, 1):
            col4 = foot[:, a, b]                      # (ns,)
            for c in (0, 1):
                vv = vtab[col4[:, None], layer[stack_cells] + c]
                cells_canon[stack_cells, 4 * a + 2 * b + c] = vv

    # re-match facet tags against the canonical corner orderings
    tag_map = {}
    for tag, pairs in mesh.facet_tag_map.items():
        pairs = np.asarray(pairs)
        if pairs.size == 0:
            tag_map[tag] = pairs.reshape(0, 2).astype(np.int32)
            continue
        want = np.sort(np.take_along_axis(
            cells[pairs[:, 0]],
            np.asarray(_FACET_CORNERS)[pairs[:, 1]], axis=1), axis=1)
        fk = face_keys(cells_canon[pairs[:, 0]])      # (nf, 6, 4)
        hitf, hitl = np.nonzero((fk == want[:, None, :]).all(axis=2))
        if np.unique(hitf).size < pairs.shape[0]:
            # every facet row needs at least one hit (a row with none must
            # not be masked by another row matching twice)
            return None                               # inconsistent tags
        lf_new = np.empty(pairs.shape[0], np.int64)
        lf_new[hitf] = hitl                           # last hit wins
        tag_map[tag] = np.stack(
            [pairs[:, 0], lf_new], axis=1).astype(np.int32)

    # curved (hex27) cells: re-express each 27-node lattice in the
    # canonical corner orientation so the quadratic map follows the
    # corner relabeling
    geom_canon = None
    if mesh.geom_nodes is not None:
        geom_canon = _permute_geom_nodes(cells, cells_canon,
                                         mesh.geom_nodes)
        if geom_canon is None:
            return None

    rows2d, n2d = _rows2d(verts, cells_canon, stack_cells, mesh.degree,
                          tr)
    return ExtrudedHexMesh(degree=mesh.degree, vertices=verts,
                           cells=cells_canon, facet_tag_map=tag_map,
                           geom_nodes=geom_canon,
                           stack_cells=stack_cells, rows2d=rows2d,
                           n2d=n2d, nz=nz, axis=axis)


def _permute_geom_nodes(cells_old, cells_new, gn):
    """Per-cell triquadratic lattices (27 nodes, TP order 9i+3j+k)
    re-expressed under the old->new corner relabeling.  For a
    non-degenerate conforming hex the relabeling is a signed axis
    permutation of the reference cube, which extends uniquely to the
    quadratic lattice; returns None if any cell's relabeling is not one
    (duplicate corner ids)."""
    nc = cells_old.shape[0]
    eq = cells_new[:, :, None] == cells_old[:, None, :]    # (nc, 8, 8)
    if not (eq.sum(axis=2) == 1).all():
        return None
    old_pos = eq.argmax(axis=2)                            # (nc, 8)
    p0 = old_pos[:, 0]
    # new lattice coordinates of the 27 TP positions
    newc = np.stack(np.meshgrid(np.arange(3), np.arange(3), np.arange(3),
                                indexing="ij")).reshape(3, 27)
    weights = np.array([9, 3, 1])
    # corner-bit -> axis lookup, vectorised over cells
    lut = np.full(5, -1, np.int64)
    lut[[4, 2, 1]] = [0, 1, 2]
    old_flat = np.zeros((nc, 27), np.int64)
    for e, corner in enumerate((4, 2, 1)):                 # new axes a,b,c
        diff = old_pos[:, corner] ^ p0
        if diff.max() > 4 or (lut[diff] < 0).any():
            return None
        ax = lut[diff]                                     # (nc,)
        flip = (p0 & diff) != 0
        oc = np.where(flip[:, None], 2 - newc[e][None, :],
                      newc[e][None, :])                    # (nc, 27)
        old_flat += weights[ax][:, None] * oc
    return gn[np.arange(nc)[:, None], old_flat]


def _rows2d(verts, cells_canon, stack_cells, degree, tr=(0, 1)):
    """(nstacks, n^2) 2D row ids by tolerance-dedup of the per-stack
    bilinear GLL footprint nodes (conforming quads share their edge
    restrictions exactly), plus the 2D row count."""
    from fustpu_torch.elements import gll

    n = degree + 1
    base = cells_canon[stack_cells[:, 0]].reshape(-1, 2, 2, 2)
    foot = verts[base[:, :, :, 0]][..., list(tr)]     # (ns, 2, 2, 2)
    t = gll.gll_nodes_unit(n)
    L = np.stack([1.0 - t, t])                        # (2, n)
    xy = np.einsum("sabd,ai,bj->sijd", foot, L, L,
                   optimize=True).reshape(-1, 2)
    lo, hi = xy.min(axis=0), xy.max(axis=0)
    tol = (float(np.linalg.norm(hi - lo)) or 1.0) * 1e-9
    ids, count = cluster_points(xy, tol)
    ns = stack_cells.shape[0]
    return ids.reshape(ns, n * n).astype(np.int32), count


def _group_rows(rows: np.ndarray):
    """Group identical integer rows; returns (group_id (N,), ngroups)."""
    order = np.lexsort(rows.T[::-1])
    sr = rows[order]
    new = np.ones(rows.shape[0], bool)
    new[1:] = np.any(sr[1:] != sr[:-1], axis=1)
    grp = np.cumsum(new) - 1
    out = np.empty(rows.shape[0], np.int64)
    out[order] = grp
    return out, int(grp[-1]) + 1
