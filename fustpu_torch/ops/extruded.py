"""Factorized stiffness apply on prismatic-topology meshes
(``fustpu_torch.mesh.extruded``): the plain PyTorch version of the extruded
CUDA kernels in ``fustpu_torch.ops.cuda_extruded``.

The dofmap factorizes as dof = row2d * gz + zidx, so the gather and scatter
are row operations on the (n2d, gz) view of the field (`index_select` /
`index_add_`), and the within-cell contractions are einsums over the
(stacks, n, n, ez) gathered layout:

    g  = x2[rows]                        rows of every stack footprint node
    u  = Wz g                            z window: (gz) -> (ez = nz n)
    w  = (D u, D u, Dz u)                derivatives along i, j and z
    f  = G . w                           symmetric 6-component metric
    r  = D^T f0 + D^T f1 + Dz^T f2
    y2[rows] += Wz^T r                   z fold, then row scatter-add

Counterpart of the extruded section of ``fustpu/ops/operators.py``, in
full precision only (the JAX package's bf16x3 and mixed modes work around
the TPU's matrix unit).  On the card the einsums go to cuBLAS with TF32
off, as in ``fustpu_torch.ops.spectral_mm``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fustpu_torch.ops import spectral_mm as mm


class PlainExtruded(NamedTuple):
    """Extruded stiffness operator in the einsum layout, on one device."""

    rows: torch.Tensor    # (ns * n^2,) int64 flattened 2D row indices
    G6: torch.Tensor      # (6, ns, n, n, ez) metric, z-expanded per stack
    Wz: torch.Tensor      # (ez, gz) 0/1 z window
    Dz: torch.Tensor      # (ez, ez) block-diagonal 1D derivative along z
    D: torch.Tensor       # (n, n) 1D derivative for the footprint axes


def build_extruded_stiffness(mesh, G_cells: np.ndarray, D_1d: np.ndarray,
                             dtype: torch.dtype, device) -> PlainExtruded:
    """mesh: ExtrudedHexMesh; G_cells: (cells, n^3, 6) float64 host."""
    n = mesh.degree + 1
    ns, nz = mesh.nstacks, mesh.nz
    Gs = np.asarray(G_cells)[mesh.stack_cells]        # (ns, nz, n^3, 6)
    Gs = Gs.reshape(ns, nz, n, n, n, 6)
    G6 = np.ascontiguousarray(Gs.transpose(5, 0, 2, 3, 1, 4)
                              ).reshape(6, ns, n, n, nz * n)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return PlainExtruded(
        rows=torch.as_tensor(mesh.rows2d.reshape(-1).astype(np.int64),
                             device=device),
        G6=t(G6), Wz=t(mm.window_matrix(nz, mesh.degree)),
        Dz=t(mm.deriv_block_matrix(nz, D_1d)), D=t(D_1d))


def expand_coeff_extruded(mesh, coeff, dtype: torch.dtype,
                          device) -> torch.Tensor:
    """(cells,) per-cell coefficient -> (ns, 1, 1, ez) broadcastable over
    the extruded quadrature layout."""
    n = mesh.degree + 1
    c = np.asarray(coeff, np.float64).reshape(-1)[mesh.stack_cells]
    return torch.as_tensor(np.repeat(c, n, axis=1)[:, None, None, :],
                           dtype=dtype, device=device)


def _gather(op: PlainExtruded, x: torch.Tensor) -> torch.Tensor:
    """Flat field -> (ns, n, n, ez): row gather, then the z window."""
    mm._full_precision(x)
    gz = op.Wz.shape[1]
    _, ns, n, _, ez = op.G6.shape
    g = x.reshape(-1, gz).index_select(0, op.rows)    # (ns n^2, gz)
    return torch.einsum("ez,qz->qe", op.Wz, g).reshape(ns, n, n, ez)


def _contract(op: PlainExtruded, u: torch.Tensor, ndofs: int,
              coeff_e: torch.Tensor | None) -> torch.Tensor:
    """The in-cell chain on the gathered layout, the z fold and the row
    scatter-add into a fresh flat field."""
    gz = op.Wz.shape[1]
    wx = torch.einsum("ai,qije->qaje", op.D, u)
    wy = torch.einsum("bj,qije->qibe", op.D, u)
    wz = torch.einsum("fe,qije->qijf", op.Dz, u)
    G = op.G6
    f0 = G[0] * wx + G[1] * wy + G[2] * wz
    f1 = G[1] * wx + G[3] * wy + G[4] * wz
    f2 = G[2] * wx + G[4] * wy + G[5] * wz
    if coeff_e is not None:
        f0, f1, f2 = f0 * coeff_e, f1 * coeff_e, f2 * coeff_e
    r = torch.einsum("ai,qaje->qije", op.D, f0)
    r = r + torch.einsum("bj,qibe->qije", op.D, f1)
    r = r + torch.einsum("fe,qijf->qije", op.Dz, f2)
    vals = torch.einsum("ez,qije->qijz", op.Wz, r).reshape(-1, gz)
    y2 = torch.zeros((ndofs // gz, gz), dtype=u.dtype, device=u.device)
    y2.index_add_(0, op.rows, vals)
    return y2.reshape(-1)


def stiffness_apply_extruded(x_flat: torch.Tensor, op: PlainExtruded,
                             ndofs: int,
                             coeff_e: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """y_flat = A_stiff(x_flat) on the factorized (n2d, gz) DOF layout.
    `coeff_e`: optional (ns, 1, 1, ez) per-cell coefficient
    (expand_coeff_extruded); omit it when folded into G."""
    return _contract(op, _gather(op, x_flat), ndofs, coeff_e)


def stiffness_apply_extruded_pair(x1: torch.Tensor, x2: torch.Tensor,
                                  op: PlainExtruded, ndofs: int,
                                  c1_e: torch.Tensor, c2_e: torch.Tensor
                                  ) -> torch.Tensor:
    """y = A_c1(x1) + A_c2(x2) in one pass: per-cell coefficients commute
    with the within-cell contractions once the fields are gathered, so the
    two fields combine right after the z window."""
    u = _gather(op, x1) * c1_e + _gather(op, x2) * c2_e
    return _contract(op, u, ndofs, None)
