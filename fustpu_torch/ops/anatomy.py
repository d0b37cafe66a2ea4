"""Anatomy of the structured stiffness kernel: variants of kernel #1 that
keep one part of its work, the hand-written CUDA kernels of
``fustpu_torch/csrc/anatomy.cu`` (template flags of ``stiffness.cuh``),
their wrappers and their plain versions.

Counterpart of ``make_variant`` in ``demos/exp_kernel_anatomy.py`` (whose
`vpu`, `mxu` and `ywin` variants keep one TPU unit's work).  `variant(op,
x, name)` for the names of `VARIANTS`:

- ``full``: the production kernel (``cuda_stiffness.stiffness``);
- ``contract`` (`mxu`): the sum factorisation with the constant metric
  (0, 0, 0, 1, 0, 1) and no G read;
- ``gstream`` (`vpu`): the x and G loads, the pointwise metric and the
  scatter, the 1-D contractions replaced by the identity:
  y_node += (G00 + 2 G01 + 2 G02 + G11 + 2 G12 + G22) u_node per cell;
- ``ywin``: the operator, with x staged in shared memory by a cooperative
  copy.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  Each variant counts its applies in
`launches` (``full`` counts in ``cuda_stiffness.launches``).  Only the
experiment demo ``fustpu_torch.demos.exp_kernel_anatomy`` runs them.
"""

from __future__ import annotations

import torch

from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.ops import spectral_mm as mm

VARIANTS = ("full", "gstream", "contract", "ywin")
# the kernel's variant flag (anatomy.cu); full is the production kernel
_FLAG = {"contract": 1, "gstream": 2, "ywin": 3}

# Applies that went through each variant's kernel.
launches = {f"anatomy_{name}": 0 for name in _FLAG}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def unit_yz(op: cs.CellStiffness) -> cs.CellStiffness:
    """`op` with the constant metric (0, 0, 0, 1, 0, 1) in place of G: the
    operator that ``contract`` computes."""
    G = torch.zeros_like(op.G)
    G[:, 3] = 1.0
    G[:, 5] = 1.0
    return op._replace(G=G)


def gstream_plain(op: cs.CellStiffness, x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``gstream``, in the matmul layout: the windowed
    expansion of x, times the combined metric, folded back."""
    mm_op = cs.to_mm(op)[0]
    w = torch.tensor([1.0, 2.0, 2.0, 1.0, 2.0, 1.0], dtype=x.dtype,
                     device=x.device)
    g = torch.einsum("m...,m->...", mm_op.G, w)
    return mm.fold(mm_op, g * mm.expand(mm_op, x))


def variant_plain(op: cs.CellStiffness, x: torch.Tensor,
                  name: str) -> torch.Tensor:
    """Plain version of `variant`."""
    if name in ("full", "ywin"):
        return cs.stiffness_plain(op, x)
    if name == "contract":
        return cs.stiffness_plain(unit_yz(op), x)
    if name == "gstream":
        return gstream_plain(op, x)
    raise ValueError(f"variant {name!r}: expected one of {VARIANTS}")


def variant(op: cs.CellStiffness, x: torch.Tensor, name: str
            ) -> torch.Tensor:
    """The variant `name` of the structured kernel on `op` and x (the plain
    version for a CPU tensor)."""
    if name not in VARIANTS:
        raise ValueError(f"variant {name!r}: expected one of {VARIANTS}")
    if x.device.type == "cpu":
        return variant_plain(op, x, name)
    if name == "full":
        return cs.stiffness(op, x)
    from fustpu_torch import _build

    cs._check(op, x, pair=False)
    y = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    fn = getattr(_build.load(), f"fustpu_anatomy_{cs._SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_FLAG[name], x.data_ptr(), op.G.data_ptr(), op.D.data_ptr(),
                 y.data_ptr(), op.P, *op.nc, stream)
    if err != 0:
        raise RuntimeError(f"anatomy {name} kernel launch failed: error "
                           f"{err}")
    launches[f"anatomy_{name}"] += 1
    return y
