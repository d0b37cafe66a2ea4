"""Indexed gather and scatter-add through an explicit dofmap, on flat DOF
vectors: the plain building blocks of the non-prismatic (indexed) path.

Counterpart of the indexed section of ``fustpu/ops/gather_scatter.py``
(`gather_dofs` :93, `scatter_add_dofs` :98).  Its pull-based transpose
(`PullScatter`, `build_pull_scatter`, `pull_scatter_dofs`) is not ported:
it replaces XLA's serialising TPU scatter with gathers, and the card has a
native `index_add_`.
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
