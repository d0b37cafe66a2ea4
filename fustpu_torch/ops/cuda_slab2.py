"""Two-slab structured stiffness apply on the card: the hand-written CUDA
kernels of ``fustpu_torch/csrc/slab2.cu``, their schedule and wrappers.

Counterpart of the experimental TPU kernels of
``fustpu/ops/pallas_stiffness.py``:

- `slab2` replaces `_mk_kernel_slab2` (`_apply_slab2`): adjacent slab
  pairs (2q, 2q + 1);
- `slab2w` replaces `_mk_kernel_slab2w` (`_apply_slab2w`): far slab pairs
  (i, ncx2 + i), two sweeps meeting at an overlap-added seam.

Both run the z-pencil walk of #1 (``csrc/stiffness_pencil.cuh``: the TMA
G ring, the persistent grid, staged x and the chunk's y buffer) with a
slab pair as its work item, the pair's two pencils walked one after the
other, on `slab2_schedule`'s table.  The first CUDA design (one pair of cells a block, 8-12 class launches of
scattered blocks, the operator's pair table) stays as `slab2_classes` /
`slab2w_classes`.  None is on a model's path: the experiment demo
``fustpu_torch.demos.exp_slab2w`` times them against #1's pencil kernel.

A wrapper given CPU tensors runs the plain version (`slab2.slab2_plain` /
`slab2.slab2w_plain`).  Given CUDA tensors it launches its kernel or
raises: there is no fallback.  Each wrapper counts its applies in
`launches` (one per apply, whatever the class count).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.ops import slab2 as s2

# Applies that went through each kernel (not counting the plain version):
# the walk (slab2, slab2w) and the class-launch design.
launches = {"slab2": 0, "slab2w": 0, "slab2_classes": 0,
            "slab2w_classes": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


# ---------------------------------------------------------------------------
# The walk's schedule
# ---------------------------------------------------------------------------

class Slab2Schedule(NamedTuple):
    """How the walk runs one apply of a two-slab operator shape."""

    cpb: int                 # cells a pencil a chunk
    stages: int              # stages of the G ring
    stage_bytes: int         # bytes a stage
    smem: int                # dynamic shared bytes a block
    blocks_per_sm: int       # resident blocks of that shape on an SM
    blocks: int              # persistent grid: blocks_per_sm x SMs
    classes: np.ndarray      # (nclass, 3) int64: first row, work items,
                             # chunks an item
    chunks: np.ndarray       # (rows, 5) int64, as `PencilSchedule`'s
    colours: int             # slab-pair colours
    sub: int                 # chunks of one pencil
    drain: bool              # a pair's pencils share nodes


def _items(slabs: np.ndarray, colours: np.ndarray, colour: int, pb: int,
           ncy: int, ghost: bool) -> list:
    """Work items (a, a', b) of one class, in (pair, b) order: the pairs of
    `colour` with (`ghost`) or without a ghost, b = pb, pb + 2, ..."""
    return [(int(slabs[q, 0]), int(slabs[q, 1]), b)
            for q in np.flatnonzero(colours == colour)
            if (slabs[q, 1] < 0) == ghost
            for b in range(pb, ncy, 2)]


def slab2_schedule(nc, P: int, itemsize: int, sms: int, far: bool,
                   occupancy=cs.model_occupancy) -> Slab2Schedule:
    """The walk's launch of one apply on a card of `sms` SMs, for nc cells
    of degree P in a dtype of `itemsize` bytes, far or adjacent pairing;
    `occupancy(P, itemsize, pair, cpb, smem)` gives the blocks an SM holds
    (the card's answer is 0 beyond the kernel's launch bounds).

    - work items: a slab pair's pencils (a, b) and (a', b), each pencil's
      chunks in turn (the ghost contributes none);
    - classes: (the pair's colour, ``slab2.slab_colours``, b % 2) in that
      order, a class's ghost pairs a class entry of their own after its
      full pairs; no two work items of a class share a node;
    - cells a chunk: `cuda_stiffness.pencil_schedule`'s cost model and
      layout (``pencil_smem``), the chunks that the busiest block of each
      class walks times the cells that share its SM, the larger cpb on a
      tie; a chunk holds at most ncz cells, a block at most MAX_THREADS
      threads;
    - each chunk's bulk-copy span as `cuda_stiffness.bulk_spans` makes
      it; drain where a pair's two pencils are adjacent slabs and a pencil
      has at most two chunks (its last chunk and the next pencil's first
      then share nodes)."""
    n = P + 1
    ncx, ncy, ncz = (int(c) for c in nc)
    slabs = s2.slab_pairs(ncx, far)
    colours = s2.slab_colours(slabs)
    entries = [items for colour in range(int(colours.max()) + 1)
               for pb in (0, 1) for ghost in (False, True)
               if (items := _items(slabs, colours, colour, pb, ncy, ghost))]

    def steps(c: int, blocks: int) -> int:
        m = -(-ncz // c)
        return sum(-(-len(items) // blocks) * m * (1 if items[0][1] < 0
                                                   else 2)
                   for items in entries)

    best = None
    for c in range(1, max(1, cs.MAX_THREADS // (n * n)) + 1):
        if c > ncz:
            break
        stage, smem = cs.pencil_smem(P, itemsize, c)
        if smem + cs._static_smem(P, itemsize) > cs.SMEM_BLOCK:
            break
        bps = int(occupancy(P, itemsize, False, c, smem))
        if bps < 1:
            continue
        key = (steps(c, bps * sms) * c * bps, -c)
        if best is None or key < best[0]:
            best = (key, c, stage, smem, bps)
    if best is None:
        raise ValueError(f"slab2 walk: no block of degree {P} fits an SM")
    _, cpb, stage, smem, bps = best
    c0 = np.arange(0, ncz, cpb)
    cn = np.minimum(cpb, ncz - c0)
    m = c0.size
    gz = ncz * P + 1
    sx = (ncy * P + 1) * gz
    classes, cell0, rows = [], [], 0
    for items in entries:
        per = m if items[0][1] < 0 else 2 * m
        classes.append((rows, len(items), per))
        for a, a2, b in items:
            for s in [a] if a2 < 0 else [a, a2]:
                cell0.append((s * ncy + b) * ncz + c0)
        rows += len(items) * per
    cell0 = np.concatenate(cell0).astype(np.int64)
    ncell = np.tile(cn, rows // m).astype(np.int64)
    cb = 6 * n ** 3 * itemsize
    off, nbytes = cs.bulk_spans(cell0, ncell, cb, ncx * ncy * ncz * cb)
    a, b, c = cell0 // (ncy * ncz), (cell0 // ncz) % ncy, cell0 % ncz
    adjacent = any(a2 >= 0 and abs(a2 - a1) == 1 for a1, a2 in slabs)
    return Slab2Schedule(
        cpb=cpb, stages=cs.STAGES, stage_bytes=stage, smem=smem,
        blocks_per_sm=bps, blocks=bps * sms,
        classes=np.asarray(classes, np.int64).reshape(-1, 3),
        chunks=np.stack([cell0, ncell, off, nbytes,
                         a * P * sx + b * P * gz + c * P], axis=1),
        colours=int(colours.max()) + 1, sub=m,
        drain=adjacent and m <= 2)


@functools.cache
def _card_schedule(nc: tuple, P: int, dtype: torch.dtype, far: bool,
                   device: torch.device) -> tuple:
    """The walk's schedule on `device` (its SMs, its kernel's occupancy
    answers), its chunk table there and its classes as a C array, built
    once per shape."""
    from fustpu_torch import _build

    query = _build.load().fustpu_slab2_pencil_occupancy

    def occupancy(P, itemsize, pair, cpb, smem):
        got = query(P, int(itemsize == 8), cpb, smem)
        if got < 0:
            raise RuntimeError(f"slab2 walk occupancy query failed: error "
                               f"{-got}")
        return got

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    itemsize = torch.empty((), dtype=dtype).element_size()
    with torch.cuda.device(device):
        sched = slab2_schedule(nc, P, itemsize, sms, far, occupancy)
    classes = sched.classes.reshape(-1)
    return (sched, torch.as_tensor(sched.chunks, device=device),
            (ctypes.c_longlong * classes.size)(*classes.tolist()))


def card_schedule(op: s2.Slab2Stiffness, x: torch.Tensor) -> Slab2Schedule:
    """The schedule that an apply of `op` on x's card runs."""
    return _card_schedule(tuple(op.nc), op.P, x.dtype, op.far, x.device)[0]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(op: s2.Slab2Stiffness, x: torch.Tensor, classes: bool) -> None:
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
    shapes = [(x, grid, x.dtype, "x"),
              (op.G, (ncells, 6, n ** 3), x.dtype, "G"),
              (op.D, (n, n), x.dtype, "D")]
    if classes:
        shapes.append((op.pairs, (blocks, 2), torch.int32, "pairs"))
    for t, shape, dtype, name in shapes:
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"slab2 kernel: {name} is {t.dtype} on "
                             f"{t.device}, expected {dtype} on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"slab2 kernel: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"slab2 kernel: {name} is not contiguous")
    if classes and op.bounds[-1] != blocks:
        raise ValueError(f"slab2 kernel: the scatter classes cover "
                         f"{op.bounds[-1]} of {blocks} blocks")
    if not classes:
        if op.G.data_ptr() % 16:
            raise ValueError("slab2 kernel: G's data is not 16 B-aligned "
                             "(the bulk copies need it)")
        if x.numel() >= 2 ** 31:
            raise ValueError(f"slab2 kernel: {x.numel()} grid nodes, the "
                             "kernel indexes fewer than 2^31")


def _launch_walk(name: str, op: s2.Slab2Stiffness, x: torch.Tensor
                 ) -> torch.Tensor:
    from fustpu_torch import _build

    _check(op, x, classes=False)
    sched, chunks, classes = _card_schedule(tuple(op.nc), op.P, x.dtype,
                                            op.far, x.device)
    y = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    fn = getattr(_build.load(), f"fustpu_slab2_pencil_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), op.G.data_ptr(), op.D.data_ptr(),
                 y.data_ptr(), op.P, chunks.data_ptr(), classes,
                 len(sched.classes), sched.blocks, sched.cpb, sched.stages,
                 sched.stage_bytes, sched.smem, op.nc[1], op.nc[2],
                 int(sched.drain), sched.sub, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {err}")
    launches[name] += 1
    return y


def _launch_classes(name: str, op: s2.Slab2Stiffness, x: torch.Tensor
                    ) -> torch.Tensor:
    from fustpu_torch import _build

    _check(op, x, classes=True)
    y = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    fn = getattr(_build.load(), f"fustpu_slab2_classes_{_SUFFIX[x.dtype]}")
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


def _pairing(op: s2.Slab2Stiffness, far: bool, name: str) -> None:
    if op.far != far:
        kind, other = ("a far", "slab2w") if op.far else ("an adjacent",
                                                          "slab2")
        raise ValueError(f"{name}: {kind}-paired operator (use {other})")


def slab2(op: s2.Slab2Stiffness, x: torch.Tensor) -> torch.Tensor:
    """y_grid = A_stiff(x_grid) with adjacent slab pairs on the walk (the
    plain version for a CPU tensor)."""
    if x.device.type == "cpu":
        return s2.slab2_plain(op, x)
    _pairing(op, False, "slab2")
    return _launch_walk("slab2", op, x)


def slab2w(op: s2.Slab2Stiffness, x: torch.Tensor) -> torch.Tensor:
    """y_grid = A_stiff(x_grid) with far slab pairs on the walk (the plain
    version for a CPU tensor)."""
    if x.device.type == "cpu":
        return s2.slab2w_plain(op, x)
    _pairing(op, True, "slab2w")
    return _launch_walk("slab2w", op, x)


def slab2_classes(op: s2.Slab2Stiffness, x: torch.Tensor) -> torch.Tensor:
    """`slab2` on the class-launch design (the plain version for a CPU
    tensor)."""
    if x.device.type == "cpu":
        return s2.slab2_plain(op, x)
    _pairing(op, False, "slab2_classes")
    return _launch_classes("slab2_classes", op, x)


def slab2w_classes(op: s2.Slab2Stiffness, x: torch.Tensor) -> torch.Tensor:
    """`slab2w` on the class-launch design (the plain version for a CPU
    tensor)."""
    if x.device.type == "cpu":
        return s2.slab2w_plain(op, x)
    _pairing(op, True, "slab2w_classes")
    return _launch_classes("slab2w_classes", op, x)
