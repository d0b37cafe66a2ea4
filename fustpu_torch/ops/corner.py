"""The corner-streamed geometry of the capacity mode: per-cell Jacobian
monomial coefficients ("channels") instead of a (cells, 6, n^3) metric
stream, and the plain torch expansion of the channels into that metric.

A cell's geometry map X(xi) on the unit reference cube is trilinear (hex8)
or triquadratic (hex27), so each entry J[p][q] = dX_p / dxi_q of its
Jacobian is a polynomial in the reference coordinates (x, y, z) with few
coefficients: 36 per cell for hex8, 162 for hex27, plus one channel for
the material coefficient.  The metric at a GLL node follows in closed form,

    G = w_i w_j w_k c adj(J) adj(J)^T / |det J|,

which the corner kernels (``fustpu_torch/csrc/corner.cuh``) evaluate in
registers and `expand_G` evaluates here as the plain version's first half.

Two channel layouts, both vendored from the JAX package:

- `jacobian_coefficients` (``fustpu/ops/pallas_stiffness.py``), the
  structured kernel's: [4p+m] = J[p][0] in {1, y, z, yz}, [12+4p+m] =
  J[p][1] in {1, x, z, xz}, [24+4p+m] = J[p][2] in {1, x, y, xy}, [36] =
  coefficient;
- `corner_stream` (``fustpu/ops/pallas_extruded.py``), the extruded
  kernel's: the `_monomial_table` order at geometry degree 1 or 2, in stack
  order.

Host arrays are float64 numpy; nothing here builds the (cells, n^3, 6)
host metric.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fustpu_torch.elements import gll

# Cells per chunk of `expand_G`: bounds its (cells, 9, n^3) temporaries.
_CHUNK = 32768


def jacobian_coefficients(corners: np.ndarray,
                          coeff: np.ndarray | None = None) -> np.ndarray:
    """(cells, 8, 3) trilinear corner coordinates -> (cells, 37) float64:
    channels [4p+m] = J[p][0] in monomials {1, y, z, yz}, [12+4p+m] =
    J[p][1] in {1, x, z, xz}, [24+4p+m] = J[p][2] in {1, x, y, xy},
    [36] = per-cell material coefficient (default 1).  Corner id 4a+2b+c
    at reference position (a, b, c) (fustpu_torch.elements.hex)."""
    cells = corners.shape[0]
    Cg = np.asarray(corners, np.float64).reshape(cells, 2, 2, 2, 3)

    def bil(av):
        # (cells, p, 2, 2) nodal values -> (cells, p, 4) monomial coeffs
        a00, a01 = av[..., 0, 0], av[..., 0, 1]
        a10, a11 = av[..., 1, 0], av[..., 1, 1]
        return np.stack([a00, a10 - a00, a01 - a00,
                         a11 - a10 - a01 + a00], -1)

    T = np.empty((cells, 37))
    T[:, 0:12] = bil((Cg[:, 1] - Cg[:, 0]).transpose(0, 3, 1, 2)
                     ).reshape(cells, 12)
    T[:, 12:24] = bil((Cg[:, :, 1] - Cg[:, :, 0]).transpose(0, 3, 1, 2)
                      ).reshape(cells, 12)
    T[:, 24:36] = bil((Cg[:, :, :, 1] - Cg[:, :, :, 0]).transpose(0, 3, 1, 2)
                      ).reshape(cells, 12)
    T[:, 36] = 1.0 if coeff is None else np.asarray(coeff,
                                                    np.float64).reshape(-1)
    return T


@functools.lru_cache(maxsize=None)
def _monomial_table(g: int):
    """Static evaluation table for the in-kernel Jacobian reconstruction
    at geometry order `g` (1 = trilinear hex8, 2 = triquadratic hex27).
    Returns (nch, table) with table[q][p] = [(channel, mx, my, mz), ...]:
    J[p][q] = sum over entries of xi_x^mx * xi_y^my * xi_z^mz * T[ch].
    Channel nch (one past the last Jacobian channel) is reserved for the
    per-cell coefficient."""
    idx = 0
    table = [[None] * 3 for _ in range(3)]
    for q in range(3):                     # derivative direction
        degs = [g, g, g]
        degs[q] = g - 1
        for p in range(3):                 # physical component
            entries = []
            for mx in range(degs[0] + 1):
                for my in range(degs[1] + 1):
                    for mz in range(degs[2] + 1):
                        entries.append((idx, mx, my, mz))
                        idx += 1
            table[q][p] = tuple(entries)
    return idx, tuple(tuple(col) for col in table)


@functools.lru_cache(maxsize=None)
def _box_table():
    """The `_monomial_table(1)` form of the `jacobian_coefficients` layout:
    in column q the two free axes a < b give m = ma + 2 mb."""
    table = [[None] * 3 for _ in range(3)]
    for q in range(3):
        a, b = [ax for ax in range(3) if ax != q]
        for p in range(3):
            entries = []
            for m in range(4):
                e = [0, 0, 0]
                e[a], e[b] = m & 1, m >> 1
                entries.append((12 * q + 4 * p + m, *e))
            table[q][p] = tuple(entries)
    return 36, tuple(tuple(col) for col in table)


def channel_table(geom_deg: int, box: bool):
    """(nch, table) of either layout (`box`: jacobian_coefficients')."""
    if box:
        if geom_deg != 1:
            raise ValueError("the structured corner layout is trilinear")
        return _box_table()
    return _monomial_table(geom_deg)


# quadratic Lagrange on nodes {0, 1/2, 1} -> monomial {1, t, t^2}
_L2_TO_MONO = np.array([[1.0, -3.0, 2.0],
                        [0.0, 4.0, -4.0],
                        [0.0, -1.0, 2.0]])


def _map_monomials(mesh) -> np.ndarray:
    """(cells, 3, gx+1, gy+1, gz+1) monomial coefficients of the cell
    geometry map x(xi) on the unit reference cell, at the mesh's
    geometry order (trilinear from the canonical corners, triquadratic
    from the hex27 lattice)."""
    if mesh.geom_nodes is None:
        Cg = mesh.cell_corners_flat.reshape(-1, 2, 2, 2, 3)
        nc = Cg.shape[0]
        C = np.zeros((nc, 3, 2, 2, 2))
        a000 = Cg[:, 0, 0, 0]
        a100 = Cg[:, 1, 0, 0] - a000
        a010 = Cg[:, 0, 1, 0] - a000
        a001 = Cg[:, 0, 0, 1] - a000
        a110 = Cg[:, 1, 1, 0] - Cg[:, 1, 0, 0] - Cg[:, 0, 1, 0] + a000
        a101 = Cg[:, 1, 0, 1] - Cg[:, 1, 0, 0] - Cg[:, 0, 0, 1] + a000
        a011 = Cg[:, 0, 1, 1] - Cg[:, 0, 1, 0] - Cg[:, 0, 0, 1] + a000
        a111 = (Cg[:, 1, 1, 1] - Cg[:, 1, 1, 0] - Cg[:, 1, 0, 1]
                - Cg[:, 0, 1, 1] + Cg[:, 1, 0, 0] + Cg[:, 0, 1, 0]
                + Cg[:, 0, 0, 1] - a000)
        for (i, j, k), v in (((0, 0, 0), a000), ((1, 0, 0), a100),
                             ((0, 1, 0), a010), ((0, 0, 1), a001),
                             ((1, 1, 0), a110), ((1, 0, 1), a101),
                             ((0, 1, 1), a011), ((1, 1, 1), a111)):
            C[:, :, i, j, k] = v
        return C
    gn = np.asarray(mesh.geom_nodes, np.float64)      # (cells, 27, 3)
    g3 = gn.reshape(-1, 3, 3, 3, 3)                   # (c, i, j, k, p)
    M = _L2_TO_MONO
    return np.einsum("cijkp,ia,jb,kd->cpabd", g3, M, M, M,
                     optimize=True)


def corner_stream(mesh, coeff: np.ndarray | None = None) -> np.ndarray:
    """(ns, nz, nch+1) float64 Jacobian monomial coefficients in stack
    order — the _monomial_table(g) channel layout with an optional
    per-cell coefficient folded into the last channel.  Trilinear hex8
    meshes carry 37 channels; curved hex27 prisms carry 163."""
    g = geom_degree(mesh)
    nch, table = _monomial_table(g)
    ns, nz = mesh.nstacks, mesh.nz
    order = mesh.stack_cells.reshape(-1)
    C = _map_monomials(mesh)[order]       # (cells, 3, gx+1, gy+1, gz+1)
    nc = C.shape[0]
    T = np.empty((nc, nch + 1))
    for q in range(3):
        ax = 2 + q                        # monomial axis of direction q
        # derivative along q: coefficient (m+1) * C[..., m+1, ...]
        Dq = np.moveaxis(np.moveaxis(C, ax, -1)[..., 1:]
                         * np.arange(1, g + 1), -1, ax)
        for p in range(3):
            for ch, mx, my, mz in table[q][p]:
                T[:, ch] = Dq[:, p, mx, my, mz]
    T[:, nch] = (1.0 if coeff is None
                 else np.asarray(coeff, np.float64).reshape(-1)[order])
    return T.reshape(ns, nz, nch + 1)


def geom_degree(mesh) -> int:
    """1 for trilinear (hex8) cells, 2 for a mesh carrying hex27
    geom_nodes."""
    return 1 if getattr(mesh, "geom_nodes", None) is None else 2


def quadrature(n: int) -> np.ndarray:
    """(2, n): the unit GLL nodes, then their weights (the corner kernels'
    Q)."""
    return np.stack(gll.gll_points_weights_unit(n))


# ---------------------------------------------------------------------------
# The plain expansion: channels -> (cells, 6, n^3) metric
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _evaluation(n: int, geom_deg: int, box: bool) -> np.ndarray:
    """(nch, 9, n^3): E[ch, 3p+q, node] = x_i^mx y_j^my z_k^mz for the
    monomial of J[p][q] that channel ch holds (0 elsewhere); node
    i n^2 + j n + k at the unit GLL nodes, x <-> i, y <-> j, z <-> k."""
    nch, table = channel_table(geom_deg, box)
    x = gll.gll_nodes_unit(n)
    E = np.zeros((nch, 9, n, n, n))
    for q in range(3):
        for p in range(3):
            for ch, mx, my, mz in table[q][p]:
                E[ch, 3 * p + q] = (x[:, None, None] ** mx
                                    * x[None, :, None] ** my
                                    * x[None, None, :] ** mz)
    return E.reshape(nch, 9, n ** 3)


@functools.lru_cache(maxsize=None)
def _expansion(n: int, geom_deg: int, box: bool, dtype: torch.dtype,
               device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(`_evaluation` on `device`, the (n^3,) products of the GLL weights),
    uploaded once: the plain apply then uploads nothing, and a CUDA graph
    can capture it."""
    E = torch.as_tensor(_evaluation(n, geom_deg, box), dtype=dtype,
                        device=device)
    w = torch.as_tensor(gll.gll_points_weights_unit(n)[1], dtype=dtype,
                        device=device)
    return E, (w[:, None, None] * w[None, :, None]
               * w[None, None, :]).reshape(-1)


def expand_G(T: torch.Tensor, n: int, geom_deg: int,
             box: bool) -> torch.Tensor:
    """(cells, nch+1) channels -> (cells, 6, n^3) metric, coefficient
    folded in, components (xx, xy, xz, yy, yz, zz) in the order of
    `cuda_stiffness.pack_G`, on T's device and in T's dtype."""
    nch = T.shape[1] - 1
    E, wq = _expansion(n, geom_deg, box, T.dtype, T.device)
    if E.shape[0] != nch:
        raise ValueError(f"{T.shape[1]} channels, expected {E.shape[0] + 1}")
    out = torch.empty((T.shape[0], 6, n ** 3), dtype=T.dtype, device=T.device)
    for s in range(0, T.shape[0], _CHUNK):
        Tc = T[s:s + _CHUNK]
        J = torch.einsum("cm,mkn->ckn", Tc[:, :nch], E)     # (c, 9, n^3)
        J00, J01, J02, J10, J11, J12, J20, J21, J22 = J.unbind(1)
        # adjugate: J^{-1}[r][p] = a_rp / det
        a00 = J11 * J22 - J12 * J21
        a01 = J02 * J21 - J01 * J22
        a02 = J01 * J12 - J02 * J11
        a10 = J12 * J20 - J10 * J22
        a11 = J00 * J22 - J02 * J20
        a12 = J02 * J10 - J00 * J12
        a20 = J10 * J21 - J11 * J20
        a21 = J01 * J20 - J00 * J21
        a22 = J00 * J11 - J01 * J10
        det = J00 * a00 + J01 * a10 + J02 * a20
        scale = wq * Tc[:, nch:] / det.abs()
        a = ((a00, a01, a02), (a10, a11, a12), (a20, a21, a22))
        for m, (r, t) in enumerate(((0, 0), (0, 1), (0, 2), (1, 1), (1, 2),
                                    (2, 2))):
            out[s:s + _CHUNK, m] = scale * (a[r][0] * a[t][0]
                                            + a[r][1] * a[t][1]
                                            + a[r][2] * a[t][2])
    return out
