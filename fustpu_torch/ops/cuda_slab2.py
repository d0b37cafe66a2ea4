"""Two-slab structured stiffness apply on the card: the hand-written CUDA
kernel of ``fustpu_torch/csrc/slab2.cu`` and its two wrappers.

Counterpart of the experimental TPU kernels of
``fustpu/ops/pallas_stiffness.py``:

- `slab2` replaces `_mk_kernel_slab2` (`_apply_slab2`): adjacent slab
  pairs (2q, 2q + 1);
- `slab2w` replaces `_mk_kernel_slab2w` (`_apply_slab2w`): far slab pairs
  (i, ncx2 + i), two sweeps meeting at an overlap-added seam.

Both are one kernel, one pair of cells a block, driven by the operator's
pair table (``fustpu_torch.ops.slab2``).  Neither is on a model's path:
the experiment demo ``fustpu_torch.demos.exp_slab2w`` times them against
the production kernel.

A wrapper given CPU tensors runs the plain version (`slab2.slab2_plain` /
`slab2.slab2w_plain`).  Given CUDA tensors it launches the kernel or
raises: there is no fallback.  Each wrapper counts its applies in
`launches` (one per apply, whatever the class count).
"""

from __future__ import annotations

import ctypes

import torch

from fustpu_torch.ops import slab2 as s2

# Applies that went through each kernel (not counting the plain version).
launches = {"slab2": 0, "slab2w": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(op: s2.Slab2Stiffness, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"slab2 kernel: tensor on {x.device}, expected a "
                         "CUDA device")
    if x.dtype not in _SUFFIX:
        raise ValueError(f"slab2 kernel: dtype {x.dtype} unsupported "
                         "(float32 or float64)")
    if not 2 <= op.P <= 10:
        raise ValueError(f"slab2 kernel: degree {op.P} outside 2..10")
    n = op.P + 1
    ncells = op.nc[0] * op.nc[1] * op.nc[2]
    grid = tuple(c * op.P + 1 for c in op.nc)
    blocks = len(op.slabs) * op.nc[1] * op.nc[2]
    for t, shape, dtype, name in [
            (x, grid, x.dtype, "x"), (op.G, (ncells, 6, n ** 3), x.dtype, "G"),
            (op.D, (n, n), x.dtype, "D"),
            (op.pairs, (blocks, 2), torch.int32, "pairs")]:
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"slab2 kernel: {name} is {t.dtype} on "
                             f"{t.device}, expected {dtype} on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"slab2 kernel: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"slab2 kernel: {name} is not contiguous")
    if op.bounds[-1] != blocks:
        raise ValueError(f"slab2 kernel: the scatter classes cover "
                         f"{op.bounds[-1]} of {blocks} blocks")


def _launch(name: str, op: s2.Slab2Stiffness, x: torch.Tensor
            ) -> torch.Tensor:
    from fustpu_torch import _build

    _check(op, x)
    y = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    fn = getattr(_build.load(), f"fustpu_slab2_{_SUFFIX[x.dtype]}")
    bounds = (ctypes.c_longlong * len(op.bounds))(*op.bounds)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), op.G.data_ptr(), op.D.data_ptr(),
                 op.pairs.data_ptr(), ctypes.addressof(bounds),
                 len(op.bounds) - 1, y.data_ptr(), op.P, op.nc[1],
                 op.nc[2], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {err}")
    launches[name] += 1
    return y


def slab2(op: s2.Slab2Stiffness, x: torch.Tensor) -> torch.Tensor:
    """y_grid = A_stiff(x_grid) with adjacent slab pairs (the plain version
    for a CPU tensor)."""
    if x.device.type == "cpu":
        return s2.slab2_plain(op, x)
    if op.far:
        raise ValueError("slab2: a far-paired operator (use slab2w)")
    return _launch("slab2", op, x)


def slab2w(op: s2.Slab2Stiffness, x: torch.Tensor) -> torch.Tensor:
    """y_grid = A_stiff(x_grid) with far slab pairs (the plain version for
    a CPU tensor)."""
    if x.device.type == "cpu":
        return s2.slab2w_plain(op, x)
    if not op.far:
        raise ValueError("slab2w: an adjacent-paired operator (use slab2)")
    return _launch("slab2w", op, x)
