"""Structured hexahedral box meshes with tensor-product spectral DOF layout.

Because the mesh is structured and the DOF layout is tensor-product by
construction, the global DOF vector is logically a 3D node grid of shape
(ncx*P+1, ncy*P+1, ncz*P+1); cell (a, b, c) owns the nodes
(a*P+i, b*P+j, c*P+k), i, j, k = 0..P, so no dofmap is needed on the hot
path.  Geometry is trilinear (hex8) per cell and may be perturbed or mapped
(a body-fitted bowl).  Vendored from ``fustpu/mesh/box.py``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from fustpu_torch.elements.hex import FACETS, HexElement
from fustpu_torch.ops import precompute


@dataclasses.dataclass(frozen=True)
class BoxMesh:
    """Structured box of ncx x ncy x ncz trilinear hex cells, degree-P GLL
    spectral DOFs."""

    degree: int
    nc: tuple[int, int, int]                 # cells per axis
    lo: tuple[float, float, float]
    hi: tuple[float, float, float]
    vertex_coords: np.ndarray                # (nvx, nvy, nvz, 3) float64

    # ----- sizes -------------------------------------------------------
    @property
    def element(self) -> HexElement:
        return HexElement(self.degree)

    @property
    def num_cells(self) -> int:
        ncx, ncy, ncz = self.nc
        return ncx * ncy * ncz

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        """Global spectral node grid (gx, gy, gz)."""
        P = self.degree
        return tuple(c * P + 1 for c in self.nc)

    @property
    def ndofs(self) -> int:
        gx, gy, gz = self.grid_shape
        return gx * gy * gz

    # ----- geometry ----------------------------------------------------
    @functools.cached_property
    def cell_corners(self) -> np.ndarray:
        """(ncx, ncy, ncz, 8, 3) trilinear geometry dofs per cell, corner
        (a, b, c) -> 4a + 2b + c."""
        v = self.vertex_coords
        corners = np.empty(self.nc + (8, 3), dtype=np.float64)
        for a in (0, 1):
            for b in (0, 1):
                for c in (0, 1):
                    corners[..., 4 * a + 2 * b + c, :] = v[
                        a: v.shape[0] - 1 + a,
                        b: v.shape[1] - 1 + b,
                        c: v.shape[2] - 1 + c,
                        :,
                    ]
        return corners

    @functools.cached_property
    def cell_corners_flat(self) -> np.ndarray:
        """(num_cells, 8, 3), cell index cx*ncy*ncz + cy*ncz + cz."""
        return self.cell_corners.reshape(self.num_cells, 8, 3)

    @functools.cached_property
    def cell_metric(self) -> np.ndarray:
        """(num_cells, n^3, 6) float64 metric factors
        (``ops.precompute.cell_geometry_factors``), computed on first use
        and shared by every model built on this mesh."""
        return precompute.cell_geometry_factors(self)[1]

    def h_cfl(self) -> float:
        """CFL length scale: sqrt(3) x the smallest corner-pair distance
        over all cells.  On a cube this is the diameter, but on anisotropic
        cells it binds on the thin direction, where the diameter would
        overestimate the stable dt by the aspect ratio."""
        return precompute.h_cfl(self.cell_corners_flat)

    # ----- DOF indexing -------------------------------------------------
    @functools.cached_property
    def dofmap(self) -> np.ndarray:
        """(num_cells, n^3) int32 global dof indices (used for host
        assembly; the stiffness path never needs it)."""
        P = self.degree
        n = P + 1
        ncx, ncy, ncz = self.nc
        gx, gy, gz = self.grid_shape
        cx = np.arange(ncx)[:, None] * P + np.arange(n)[None, :]   # (ncx, n)
        cy = np.arange(ncy)[:, None] * P + np.arange(n)[None, :]
        cz = np.arange(ncz)[:, None] * P + np.arange(n)[None, :]
        dm = (
            cx[:, None, None, :, None, None] * (gy * gz)
            + cy[None, :, None, None, :, None] * gz
            + cz[None, None, :, None, None, :]
        )
        return dm.reshape(self.num_cells, n**3).astype(np.int32)

    @functools.cached_property
    def node_coords(self) -> np.ndarray:
        """(gx, gy, gz, 3) physical coordinates of every spectral node
        (trilinear map of the GLL lattice; neighbouring cells agree on
        shared nodes)."""
        elem = self.element
        n = elem.n
        P = self.degree
        pts = elem.nodes_1d                       # (n,)
        l1 = np.stack([1.0 - pts, pts], axis=1)   # (n, 2)
        corners = self.cell_corners.reshape(self.nc + (2, 2, 2, 3))
        cellnodes = np.einsum(
            "xyzabcd,ia,jb,kc->xyzijkd", corners, l1, l1, l1, optimize=True
        )
        gx, gy, gz = self.grid_shape
        out = np.zeros((gx, gy, gz, 3))
        ncx, ncy, ncz = self.nc
        # set (not add): duplicated boundary nodes agree
        view = cellnodes.transpose(0, 3, 1, 4, 2, 5, 6)  # (ncx,n,ncy,n,ncz,n,3)
        for i in range(n):
            for j in range(n):
                for k in range(n):
                    out[i::P, j::P, k::P][:ncx, :ncy, :ncz] = view[:, i, :, j, :, k]
        return out

    # ----- boundary facets ----------------------------------------------
    def boundary_facets(self, plane: str, predicate=None) -> np.ndarray:
        """(nf, 2) int32 array of (cell, local_facet) pairs on one of the six
        box boundary planes 'x-','x+','y-','y+','z-','z+'.  `predicate`,
        if given, maps facet-centroid coordinates (nf, 3) -> bool mask to
        select a sub-patch (e.g. a bowl-cap source aperture)."""
        names = ["x-", "x+", "y-", "y+", "z-", "z+"]
        facet = names.index(plane)
        axis, side = FACETS[facet]
        ncx, ncy, ncz = self.nc
        sizes = [ncx, ncy, ncz]
        fixed = 0 if side == 0 else sizes[axis] - 1
        free = [ax for ax in range(3) if ax != axis]
        A, B = np.meshgrid(np.arange(sizes[free[0]]),
                           np.arange(sizes[free[1]]), indexing="ij")
        cidx = np.zeros((A.size, 3), dtype=np.int64)
        cidx[:, axis] = fixed
        cidx[:, free[0]] = A.ravel()
        cidx[:, free[1]] = B.ravel()
        cells = cidx[:, 0] * ncy * ncz + cidx[:, 1] * ncz + cidx[:, 2]
        pairs = np.stack([cells, np.full_like(cells, facet)], axis=1)
        if predicate is not None:
            centroids = self.cell_corners_flat[cells][
                :, [c for c in range(8)
                    if ((c >> (2 - axis)) & 1) == side], :].mean(axis=1)
            pairs = pairs[predicate(centroids)]
        return pairs.astype(np.int32)

    def all_boundary_facets(self) -> np.ndarray:
        """All exterior facets."""
        return np.concatenate(
            [self.boundary_facets(p) for p in
             ["x-", "x+", "y-", "y+", "z-", "z+"]], axis=0)

    def dofmap_rows(self, cells: np.ndarray) -> np.ndarray:
        """(len(cells), n^3) int32: the rows of `dofmap` of the given cells
        (`dofmap_rows`), without the whole dofmap."""
        return dofmap_rows(self.nc, self.degree, cells)

    def facet_dofmap(self, boundary_data: np.ndarray) -> np.ndarray:
        """(nf, n^2) int32 global dofs of each (cell, local_facet) pair:
        the facet cells' dofmap rows only (`dofmap_rows`)."""
        elem = self.element
        bd = np.asarray(boundary_data).reshape(-1, 2)
        return self.dofmap_rows(bd[:, 0])[
            np.arange(bd.shape[0])[:, None],
            elem.all_facet_dofs[bd[:, 1]]].astype(np.int32)


def dofmap_rows(nc, P: int, cells) -> np.ndarray:
    """(len(cells), n^3) int32 dofmap rows of the given cells of a box of
    `nc` cells at degree P, by the box dofmap formula (cx P + i) gy gz +
    (cy P + j) gz + (cz P + k): the plain version of the set-up kernel
    ``ops.cuda_setup.box_dofmap``."""
    n = P + 1
    _, ncy, ncz = nc
    gy, gz = ncy * P + 1, ncz * P + 1
    c = np.asarray(cells, np.int64).reshape(-1)
    loc = np.arange(n)
    cx = (c // (ncy * ncz))[:, None] * P + loc
    cy = ((c // ncz) % ncy)[:, None] * P + loc
    cz = (c % ncz)[:, None] * P + loc
    rows = (cx[:, :, None, None] * (gy * gz)
            + cy[:, None, :, None] * gz + cz[:, None, None, :])
    return rows.reshape(c.size, n ** 3).astype(np.int32)


def build_box_mesh(
    nc: tuple[int, int, int],
    degree: int,
    lo: tuple[float, float, float] = (0.0, 0.0, 0.0),
    hi: tuple[float, float, float] = (1.0, 1.0, 1.0),
    perturb: float = 0.0,
    seed: int = 0,
) -> BoxMesh:
    """Build a structured box mesh; `perturb` randomly displaces interior
    vertices by up to `perturb * h` to exercise non-affine geometry."""
    ncx, ncy, ncz = nc
    xs = np.linspace(lo[0], hi[0], ncx + 1)
    ys = np.linspace(lo[1], hi[1], ncy + 1)
    zs = np.linspace(lo[2], hi[2], ncz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    coords = np.stack([X, Y, Z], axis=-1)
    if perturb > 0.0:
        rng = np.random.default_rng(seed)
        h = np.array([(hi[d] - lo[d]) / nc[d] for d in range(3)])
        disp = rng.uniform(-perturb, perturb, coords.shape) * h
        # keep the boundary planes fixed
        disp[0, :, :] = 0.0
        disp[-1, :, :] = 0.0
        disp[:, 0, :] = 0.0
        disp[:, -1, :] = 0.0
        disp[:, :, 0] = 0.0
        disp[:, :, -1] = 0.0
        coords = coords + disp
    return BoxMesh(degree=degree, nc=tuple(nc), lo=tuple(lo), hi=tuple(hi),
                   vertex_coords=coords)


def build_mapped_mesh(
    nc: tuple[int, int, int],
    degree: int,
    mapping,
    lo: tuple[float, float, float] = (0.0, 0.0, 0.0),
    hi: tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> BoxMesh:
    """Box-topology mesh with vertices moved by `mapping(points (N,3)) ->
    (N,3)`: body-fitted curved or graded geometry with per-cell trilinear
    cells.  `lo`/`hi` describe the parameter box; the physical extent is
    the mapping's image (point location corrects the lattice guess with a
    Newton cell walk)."""
    base = build_box_mesh(nc, degree, lo=lo, hi=hi)
    pts = base.vertex_coords.reshape(-1, 3)
    mapped = np.asarray(mapping(pts), dtype=np.float64).reshape(
        base.vertex_coords.shape)
    return BoxMesh(degree=degree, nc=tuple(nc), lo=tuple(lo), hi=tuple(hi),
                   vertex_coords=mapped)
