"""Anatomy of the parity-class structured stiffness kernel: that kernel (#1,
and its pair form #2) and variants of it that keep one part of its work,
the hand-written CUDA kernels of ``fustpu_torch/csrc/anatomy.cu``
(template flags of ``stiffness.cuh``), their wrappers and their plain
versions.

Counterpart of ``make_variant`` in ``demos/exp_kernel_anatomy.py`` (whose
`vpu`, `mxu` and `ywin` variants keep one TPU unit's work).  `variant(op,
x, name)` for the names of `VARIANTS`:

- ``full``: the parity-class kernel #1 itself, the design that the main
  path ran before the z-pencil kernel (``cuda_stiffness.stiffness``)
  replaced it;
  `full_pair` is its pair form, #2;
- ``contract`` (`mxu`): the sum factorisation with the constant metric
  (0, 0, 0, 1, 0, 1) and no G read;
- ``gstream`` (`vpu`): the x and G loads, the pointwise metric and the
  scatter, the 1-D contractions replaced by the identity:
  y_node += (G00 + 2 G01 + 2 G02 + G11 + 2 G12 + G22) u_node per cell;
- ``ywin``: the operator, with x staged in shared memory by a cooperative
  copy.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  Each variant counts its applies in
`launches`.  Only the experiment demos
``fustpu_torch.demos.exp_kernel_anatomy`` and ``exp_pencil`` (the parity-class
design against the pencil kernel) run them.
"""

from __future__ import annotations

import torch

from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.ops import spectral_mm as mm

VARIANTS = ("full", "gstream", "contract", "ywin")
# the kernel's variant flag (anatomy.cu)
_FLAG = {"full": 0, "contract": 1, "gstream": 2, "ywin": 3}

# Applies that went through each variant's kernel.
launches = {**{f"anatomy_{name}": 0 for name in _FLAG},
            "anatomy_full_pair": 0}


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


def full_pair(op: cs.CellStiffness, x1: torch.Tensor, x2: torch.Tensor
              ) -> torch.Tensor:
    """The parity-class pair kernel #2 on `op` (the plain version for CPU
    tensors)."""
    if x1.device.type == "cpu":
        return cs.stiffness_pair_plain(op, x1, x2)
    from fustpu_torch import _build

    cs._check(op, x1, x2, pair=True)
    y = torch.zeros(x1.shape, dtype=x1.dtype, device=x1.device)
    fn = getattr(_build.load(), f"fustpu_anatomy_pair_{cs._SUFFIX[x1.dtype]}")
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        err = fn(x1.data_ptr(), x2.data_ptr(), op.C.data_ptr(),
                 op.G.data_ptr(), op.D.data_ptr(), y.data_ptr(), op.P,
                 *op.nc, stream)
    if err != 0:
        raise RuntimeError(f"anatomy full_pair kernel launch failed: error "
                           f"{err}")
    launches["anatomy_full_pair"] += 1
    return y
