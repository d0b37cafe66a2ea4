"""Matrix-free structured operators on the windowed element batch: mass,
sum-factorised stiffness and facet mass of a box mesh.

Counterpart of the structured section of ``fustpu/ops/operators.py``
(`mass_apply` :48, `stiffness_apply` :59, `plane_facet_mass_apply` :81).
x lives on the (gx, gy, gz) node grid; detJ and G live in the expanded
(ncx, n, ncy, n, ncz, n[, 6]) layout
(``fustpu_torch.ops.precompute.to_structured_layout``).  An apply windows
x into that layout (``ops.gather_scatter.windows3d``), works on every cell
at once and overlap-adds the result back (`fold3d`): the element-batch
form of the reference's CUDA kernels (one block a cell, shared-memory
contractions, atomic scatter), and of their formulation.

These are plain torch versions, in full precision (TF32 off on the card,
``spectral_mm._full_precision``).  No model's step calls them: the models
run the z-pencil kernel (``ops.cuda_stiffness``), whose plain version is
``ops.spectral_mm``; `exp_kernel_speed` times this formulation beside them.
"""

from __future__ import annotations

import torch

from fustpu_torch.ops.gather_scatter import fold2d, fold3d, windows2d, windows3d
from fustpu_torch.ops.spectral_mm import _full_precision


def _bc(coeff: torch.Tensor) -> torch.Tensor:
    """(ncx, ncy, ncz) cell coefficients -> broadcastable to the expanded
    (ncx, n, ncy, n, ncz, n) layout."""
    return coeff[:, None, :, None, :, None]


def mass_apply(x: torch.Tensor, detJ: torch.Tensor, coeff: torch.Tensor,
               P: int) -> torch.Tensor:
    """y_grid = A_mass(x_grid): gather, x * detJ * coeff, overlap-add (the
    per-cell mass is diagonal under GLL collocation)."""
    u = windows3d(x, P)
    return fold3d(u * detJ * _bc(coeff), P)


def stiffness_apply(x: torch.Tensor, G: torch.Tensor, coeff: torch.Tensor,
                    D: torch.Tensor, P: int) -> torch.Tensor:
    """y_grid = A_stiff(x_grid), sum-factorised: forward contractions with
    D[q, i], the symmetric 6-component metric G, reverse contractions with
    D transposed, then the overlap-add."""
    _full_precision(x)
    u = windows3d(x, P)                                  # (a,i,b,j,c,k)
    wx = torch.einsum("qi,aibjck->aqbjck", D, u)
    wy = torch.einsum("qj,aibjck->aibqck", D, u)
    wz = torch.einsum("qk,aibjck->aibjcq", D, u)
    c = _bc(coeff)
    f0 = c * (G[..., 0] * wx + G[..., 1] * wy + G[..., 2] * wz)
    f1 = c * (G[..., 1] * wx + G[..., 3] * wy + G[..., 4] * wz)
    f2 = c * (G[..., 2] * wx + G[..., 4] * wy + G[..., 5] * wz)
    y = torch.einsum("qi,aqbjck->aibjck", D, f0)
    y = y + torch.einsum("qj,aibqck->aibjck", D, f1)
    y = y + torch.einsum("qk,aibjcq->aibjck", D, f2)
    return fold3d(y, P)


def plane_facet_mass_apply(x_plane: torch.Tensor, detJ_f: torch.Tensor,
                           coeff: torch.Tensor, P: int) -> torch.Tensor:
    """Facet mass over a whole boundary plane of a box: x_plane (gs, gt)
    the node grid's restriction to the plane, detJ_f (ncs, n, nct, n) the
    expanded facet factors, coeff (ncs, nct).  Returns the plane's (gs, gt)
    contribution (to be added into y at the plane)."""
    u = windows2d(x_plane, P)
    return fold2d(u * detJ_f * coeff[:, None, :, None], P)
