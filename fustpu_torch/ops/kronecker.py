"""Kronecker-product application [A0 (x) A1 (x) A2] and the GLL degree
transfer of box fields.  Counterpart of ``fustpu/ops/kronecker.py``.

`interpolate_box_field` re-expresses a field of one box mesh on the same
cells at another spectral degree, through the sum-factorised per-cell
apply `kron_apply`: a run checkpointed at P=4 resumes at P=6.  The
transfer is exact for per-axis polynomials up to the lower degree.  A
resumed run must take the target model's own CFL dt (`model.cfl_dt`):
dt scales as 1/P^2.

On a CUDA tensor the transfer runs on the card, in the tensor's dtype
(TF32 off); arrays take the host path in float64 and come back as arrays.
Shared faces are taken from one cell only (each cell writes its own nodes
below its far faces, the last cell along an axis those too), so the
result does not depend on the order of overlapping writes.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from fustpu_torch.elements import gll


@contextlib.contextmanager
def _no_tf32():
    """float32 matmuls in full float32 precision within the scope."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def kron_apply(A0, A1, A2, x):
    """y = [A0 (x) A1 (x) A2] x over the trailing three axes of x (leading
    axes are batch), as three small contractions instead of one
    (m0 m1 m2, n0 n1 n2) matrix.  Tensors (the A on x's device and in its
    dtype) or arrays (computed in float64 on the host)."""
    host = not isinstance(x, torch.Tensor)
    x = torch.as_tensor(np.asarray(x, np.float64) if host else x)
    A0, A1, A2 = (torch.as_tensor(a, dtype=x.dtype, device=x.device)
                  for a in (A0, A1, A2))
    with _no_tf32():
        y = torch.einsum("ai,...ijk->...ajk", A0, x)
        y = torch.einsum("bj,...ajk->...abk", A1, y)
        y = torch.einsum("ck,...abk->...abc", A2, y)
    return y.numpy() if host else y


def degree_transfer_matrix(p_from: int, p_to: int) -> np.ndarray:
    """(p_to+1, p_from+1) Lagrange evaluation matrix from the degree-p_from
    GLL nodes to the degree-p_to GLL nodes on [0, 1]."""
    src = gll.gll_nodes_unit(p_from + 1)
    dst = gll.gll_nodes_unit(p_to + 1)
    vals, _ = gll.lagrange_tabulate(src, dst)
    return vals


def _merge_axis(t: torch.Tensor, d: int) -> torch.Tensor:
    """(..., cells, n, ...) at dims d, d+1 -> the node axis (...,
    cells (n-1) + 1, ...): every cell's nodes but its last, then the last
    cell's last node."""
    nc, n = t.shape[d], t.shape[d + 1]
    body = t.narrow(d + 1, 0, n - 1).flatten(d, d + 1)
    last = t.narrow(d, nc - 1, 1).narrow(d + 1, n - 1, 1).flatten(d, d + 1)
    return torch.cat([body, last], dim=d)


def interpolate_box_field(field, mesh_from, mesh_to):
    """A node field of box mesh `mesh_from` (mapped geometry too: the
    transfer is in per-cell reference coordinates) as the field of
    `mesh_to`, the same cells at another degree.  Raises if the cell
    grids or the cell corners differ.  A tensor stays on its device and
    in its dtype; an array is transferred in float64 on the host."""
    if tuple(mesh_from.nc) != tuple(mesh_to.nc):
        raise ValueError(f"cell grids differ: {mesh_from.nc} "
                         f"vs {mesh_to.nc}")
    # the same geometry too: a transfer between meshes whose cells sit at
    # different points would silently corrupt a restart
    a = np.asarray(mesh_from.cell_corners_flat)
    b = np.asarray(mesh_to.cell_corners_flat)
    if a.shape != b.shape or not np.allclose(a, b, atol=1e-12):
        raise ValueError("meshes differ in geometry (cell corners), not "
                         "just degree: degree transfer needs the same "
                         "cell grid")
    host = not isinstance(field, torch.Tensor)
    f = torch.as_tensor(np.asarray(field, np.float64) if host else field)
    f = f.reshape(mesh_from.grid_shape)
    p1, p2 = mesh_from.degree, mesh_to.degree
    if p1 == p2:
        out = f.clone()
    else:
        L = degree_transfer_matrix(p1, p2)
        n1 = p1 + 1
        # per-cell (n1, n1, n1) blocks: (ncx, ncy, ncz, n1, n1, n1) views
        blocks = f.unfold(0, n1, p1).unfold(1, n1, p1).unfold(2, n1, p1)
        nb = kron_apply(L, L, L, blocks)          # (ncx, ncy, ncz, n2^3)
        out = nb.permute(0, 3, 1, 4, 2, 5)        # (ncx, n2, ncy, n2, ...)
        for d in range(3):
            out = _merge_axis(out, d)
    return out.numpy() if host else out
