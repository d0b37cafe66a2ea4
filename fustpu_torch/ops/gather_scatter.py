"""Gather and scatter-add between global DOFs and element batches: through
an explicit dofmap on flat DOF vectors (the plain building blocks of the
non-prismatic, indexed path), and windowed on a box's node grid (the
plain structured operators of ``fustpu_torch.ops.operators``).

Counterpart of ``fustpu/ops/gather_scatter.py`` (`gather_dofs` :93,
`scatter_add_dofs` :98; `windows3d`, `fold3d`, `windows2d`, `fold2d`
:54-90).  Its pull-based transpose (`PullScatter`, `build_pull_scatter`,
`pull_scatter_dofs`) is not ported: it replaces XLA's serialising TPU
scatter with gathers, and the card has a native `index_add_`.
"""

from __future__ import annotations

import torch


def gather_dofs(x_flat: torch.Tensor, dofmap: torch.Tensor) -> torch.Tensor:
    """x[dofmap]: (ndofs,) -> (entities, local_dofs)."""
    return x_flat.index_select(0, dofmap.reshape(-1)).reshape(dofmap.shape)


def scatter_add_dofs(vals: torch.Tensor, dofmap: torch.Tensor,
                     ndofs: int) -> torch.Tensor:
    """Scatter-add of (entities, local_dofs) values into a fresh (ndofs,)
    vector."""
    y = torch.zeros(ndofs, dtype=vals.dtype, device=vals.device)
    return y.index_add_(0, dofmap.reshape(-1), vals.reshape(-1))


# ---------------------------------------------------------------------------
# Structured gather / scatter on a box's node grid (the windowed layout)
#
# Counterpart of the structured section of ``fustpu/ops/gather_scatter.py``
# (:25-90).  With tensor-product numbering global node c*P + i belongs to
# cell c, so neighbouring cells share one plane per axis: the gather is a
# window of each axis ((g,) -> (nc, n)), the scatter-add its adjoint, an
# overlap-add of the shared planes.  Plain torch, with no index arrays;
# the same sums in the same order as the JAX package's, so the results
# are bitwise its own.
# ---------------------------------------------------------------------------

def _win_front(x: torch.Tensor, P: int) -> torch.Tensor:
    """(g, ...) -> (nc, n, ...) overlapping windows, g = nc*P + 1."""
    g = x.shape[0]
    nc = (g - 1) // P
    rest = x.shape[1:]
    a = x[:g - 1].reshape(nc, P, *rest)
    b = x[P::P].unsqueeze(1)                 # node (c+1)*P of each cell
    return torch.cat([a, b], dim=1)


def _fold_front(A: torch.Tensor, P: int) -> torch.Tensor:
    """(nc, n, ...) -> (g, ...) overlap-add (adjoint of `_win_front`)."""
    nc = A.shape[0]
    rest = A.shape[2:]
    y = A.new_zeros((nc * P + 1, *rest))
    y[:nc * P] = A[:, :P].reshape(nc * P, *rest)
    y[P::P] += A[:, P]                       # each cell's last plane
    return y


def windows3d(x: torch.Tensor, P: int) -> torch.Tensor:
    """(gx, gy, gz) node grid -> (ncx, n, ncy, n, ncz, n) element batch."""
    x = _win_front(x, P)                     # (ncx, n, gy, gz)
    x = _win_front(x.movedim(2, 0), P)       # (ncy, n, ncx, n, gz)
    x = _win_front(x.movedim(4, 0), P)       # (ncz, n, ncy, n, ncx, n)
    return x.permute(4, 5, 2, 3, 0, 1)       # (ncx, n, ncy, n, ncz, n)


def fold3d(A: torch.Tensor, P: int) -> torch.Tensor:
    """(ncx, n, ncy, n, ncz, n) element batch -> (gx, gy, gz) scatter-add."""
    A = _fold_front(A.permute(4, 5, 2, 3, 0, 1), P)   # (gz, ncy, n, ncx, n)
    A = _fold_front(A.movedim(0, 4), P)               # (gy, ncx, n, gz)
    return _fold_front(A.movedim(0, 2), P)            # (gx, gy, gz)


def windows2d(x: torch.Tensor, P: int) -> torch.Tensor:
    """(gs, gt) plane -> (ncs, n, nct, n) facet batch (boundary planes)."""
    x = _win_front(x, P)                     # (ncs, n, gt)
    x = _win_front(x.movedim(2, 0), P)       # (nct, n, ncs, n)
    return x.permute(2, 3, 0, 1)


def fold2d(A: torch.Tensor, P: int) -> torch.Tensor:
    """(ncs, n, nct, n) facet batch -> (gs, gt) scatter-add."""
    A = _fold_front(A.permute(2, 3, 0, 1), P)         # (gt, ncs, n)
    return _fold_front(A.movedim(0, 2), P)            # (gs, gt)
