"""Parametric unstructured-mesh generators.

`cylinder_mesh` builds a conforming all-hex cylinder via the classic
butterfly / O-grid pattern (square core + 4 blended sectors out to the
piston radius, polar annulus out to the wall) extruded along z, the
geometry class of the piston benchmark meshes (Benchmark 1 Source 2 of
the inter-code focused-ultrasound benchmark): a circular piston source
disk (tag 1) in the z=0 wall of a cylindrical water column, absorbing
wall and far cap (tag 2), rigid (natural) baffle on the remaining z=0
annulus.  Written through fustpu_torch.mesh.msh_io these meshes exercise
the full import pipeline.  Vendored from ``fustpu/mesh/shapes.py``.

`hex27_lattice` carries a mesh's geometry as hex27 (curved cells), here
with `curved_prism_map`, a prismatic curvature that keeps the vertex
columns of an extrusion: the curved test prism of the corner kernels.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fustpu_torch.elements.hex import hex8_tabulate


def _butterfly_2d(a: float, m: int, mr: int):
    """2D butterfly disk of radius `a`: square core of m x m cells
    (half-width a/2) + 4 sectors of mr radial cells blending the core
    edge onto the circle.  Returns (points dict key->idx, pts list,
    quads list, boundary ring vertex keys in angle order)."""
    s = 0.5 * a
    pts: list = []
    index: dict = {}

    def pid(x, y):
        key = (round(float(x), 12), round(float(y), 12))
        if key not in index:
            index[key] = len(pts)
            pts.append((key[0], key[1]))
        return index[key]

    quads = []
    # core
    cs = np.linspace(-s, s, m + 1)
    for i in range(m):
        for j in range(m):
            quads.append((pid(cs[i], cs[j]), pid(cs[i + 1], cs[j]),
                          pid(cs[i + 1], cs[j + 1]), pid(cs[i], cs[j + 1])))
    # sectors: east, north, west, south by rotation.  Rim points (rho=1)
    # use the same canonical polar expression as the annulus ring
    # (_rim_point) so shared vertices are byte-identical: a second float
    # path straddling the dedup precision would split the rim vertex and
    # make the mesh non-conforming.
    for sector in range(4):
        rot = sector * np.pi / 2.0
        cr, sr = np.cos(rot), np.sin(rot)
        for l in range(mr):
            for j in range(m):
                corner = []
                for dl, dj in ((0, 0), (1, 0), (1, 1), (0, 1)):
                    if l + dl == mr:                     # on the rim
                        k_rim = (sector * m + j + dj) % (4 * m)
                        corner.append(pid(*_rim_point(a, k_rim, 4 * m)))
                        continue
                    t = -1.0 + 2.0 * (j + dj) / m
                    rho = (l + dl) / mr
                    ex, ey = s, s * t                    # core edge point
                    th = t * np.pi / 4.0
                    ax, ay = a * np.cos(th), a * np.sin(th)
                    x = (1 - rho) * ex + rho * ax
                    y = (1 - rho) * ey + rho * ay
                    corner.append(pid(cr * x - sr * y, sr * x + cr * y))
                # rotation by 90 deg preserves CCW orientation
                quads.append(tuple(corner))
    return index, pts, quads, pid


def _rim_point(r: float, k: int, ntheta: int) -> tuple:
    """The canonical expression for ring points (single angle -> cos/sin):
    every construction site computes ring coordinates through this one
    function so coincident vertices are byte-identical."""
    th = -np.pi / 4.0 + 2.0 * np.pi * (k % ntheta) / ntheta
    return float(r * np.cos(th)), float(r * np.sin(th))


def _merge_close_points(pts: np.ndarray, quads: list, tol: float):
    """Safety net behind the exact-key dedup of _butterfly_2d: cluster
    points closer than `tol` (nested stable sorts, as in
    UnstructuredHexMesh._cluster) and remap quad indices.  Guards
    against any remaining last-ulp duplicate splitting the mesh."""
    pts = np.asarray(pts, np.float64)
    N = pts.shape[0]
    order = np.argsort(pts[:, 0], kind="stable")
    grp = np.empty(N, np.int64)
    brk = np.empty(N, bool)
    brk[0] = True
    brk[1:] = np.diff(pts[order, 0]) > tol
    np.cumsum(brk, out=grp)
    coord = pts[order, 1]
    o2 = np.lexsort((coord, grp))
    order = order[o2]
    gs, cs = grp[o2], coord[o2]
    brk[0] = True
    brk[1:] = (gs[1:] != gs[:-1]) | (np.diff(cs) > tol)
    np.cumsum(brk, out=grp)
    remap = np.empty(N, np.int64)
    remap[order] = grp - 1
    uniq = np.empty((int(grp[-1]), 2))
    uniq[remap] = pts
    return uniq, [tuple(int(remap[p]) for p in q) for q in quads]


def cylinder_mesh(radius: float, length: float, piston_radius: float,
                  m: int = 4, mr: int = 2, nr_ann: int = 2, nz: int = 12):
    """All-hex cylinder (axis = z, base at z=0).  Returns
    (vertices (nv,3), cells (nc,8), tagged_quads) for msh_io.write_msh /
    UnstructuredHexMesh: tag 1 = piston disk (z=0, r <= piston_radius),
    tag 2 = absorbing outer wall + far cap; the z=0 annulus is untagged
    (rigid baffle, natural BC)."""
    a, R = float(piston_radius), float(radius)
    if not 0 < a < R:
        raise ValueError("need 0 < piston_radius < radius")
    index, pts2, quads, pid = _butterfly_2d(a, m, mr)
    n_disk = len(quads)
    # annulus a -> R on 4m equally spaced angles matching the butterfly rim
    # (ring points go through _rim_point, the same expression the sector
    # rim used, so the shared a-radius ring dedups exactly)
    ntheta = 4 * m
    radii = np.linspace(a, R, nr_ann + 1)
    for i in range(nr_ann):
        for k in range(ntheta):
            corner = []
            for di, dk in ((0, 0), (1, 0), (1, 1), (0, 1)):
                corner.append(pid(*_rim_point(radii[i + di], k + dk, ntheta)))
            quads.append(tuple(corner))
    # tolerance-merge as a safety net (exact-key dedup can split last-ulp
    # duplicates)
    pts2, quads = _merge_close_points(pts2, quads, tol=1e-9 * R)

    zs = np.linspace(0.0, float(length), nz + 1)
    nv2 = pts2.shape[0]
    verts = np.empty((nv2 * (nz + 1), 3))
    for k, z in enumerate(zs):
        verts[k * nv2:(k + 1) * nv2, :2] = pts2
        verts[k * nv2:(k + 1) * nv2, 2] = z

    cells = np.empty((len(quads) * nz, 8), np.int64)
    ci = 0
    for k in range(nz):
        lo, hi = k * nv2, (k + 1) * nv2
        for (p0, p1, p2, p3) in quads:
            # corner id 4a+2b+c: (a,b) over the quad, c over z
            cells[ci] = (lo + p0, hi + p0, lo + p3, hi + p3,
                         lo + p1, hi + p1, lo + p2, hi + p2)
            ci += 1

    tagged = []
    # piston disk: z=0 faces of disk-region quads
    for (p0, p1, p2, p3) in quads[:n_disk]:
        tagged.append((1, (p0, p1, p2, p3)))
    # far cap: z=L faces of every quad
    off = nz * nv2
    for (p0, p1, p2, p3) in quads:
        tagged.append((2, (off + p0, off + p1, off + p2, off + p3)))
    # outer wall: radial faces of the outermost annulus ring
    wall0 = n_disk + (nr_ann - 1) * ntheta
    for k in range(nz):
        lo, hi = k * nv2, (k + 1) * nv2
        for (p0, p1, p2, p3) in quads[wall0:wall0 + ntheta]:
            # outer edge of the annulus quad is (p1, p2) (di=1 corners)
            tagged.append((2, (lo + p1, lo + p2, hi + p2, hi + p1)))
    return verts, cells, tagged


def hex27_lattice(mesh, phi=None):
    """`mesh` (an unstructured mesh dataclass) with its geometry carried as
    hex27: the 27-node lattice of each cell's trilinear map, moved with the
    vertices by `phi` when given (phi must keep the vertex columns of an
    extrusion for the result to stay prismatic)."""
    lat3 = np.array([[i / 2, j / 2, k / 2] for i in range(3)
                     for j in range(3) for k in range(3)])
    vals, _ = hex8_tabulate(lat3)                  # (27, 8)
    gl = np.einsum("qv,cvd->cqd", vals, mesh.vertices[mesh.cells])
    if phi is None:
        return dataclasses.replace(mesh, geom_nodes=gl)
    return dataclasses.replace(mesh, vertices=phi(mesh.vertices),
                               geom_nodes=phi(gl))


def curved_prism_map(x):
    """A prismatic curvature: the transverse shift depends on (x, y) only
    (vertex columns survive); layers curved and graded in z."""
    x = np.asarray(x, np.float64)
    out = x.copy()
    out[..., 0] = x[..., 0] + 0.04 * np.sin(1.3 * x[..., 1])
    out[..., 1] = x[..., 1] + 0.05 * np.sin(1.1 * x[..., 0] + 0.4)
    out[..., 2] = x[..., 2] * (1.0 + 0.1 * x[..., 2]) \
        + 0.06 * np.sin(1.7 * x[..., 0] + 0.5 * x[..., 1])
    return out


def oneil_on_axis(z, piston_radius: float, frequency: float,
                  sound_speed: float, p0: float) -> np.ndarray:
    """O'Neil / Rayleigh closed-form on-axis pressure AMPLITUDE of a
    baffled circular plane piston driven CW with plane-wave pressure
    amplitude p0 (= rho c v0): |p(z)| = 2 p0 |sin(k/2 (sqrt(z^2+a^2)-z))|,
    the analytic anchor of Benchmark 1 Source 2."""
    z = np.asarray(z, np.float64)
    k = 2.0 * np.pi * frequency / sound_speed
    a = piston_radius
    return 2.0 * p0 * np.abs(np.sin(0.5 * k * (np.sqrt(z * z + a * a) - z)))
