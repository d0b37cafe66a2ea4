"""Structured stiffness apply on the card: the hand-written CUDA z-pencil
kernel of ``fustpu_torch/csrc/stiffness.cu`` (``stiffness_pencil.cuh``),
its launch schedule and its wrappers.

Counterpart of ``fustpu/ops/pallas_stiffness.py``:

- `stiffness` replaces `_mk_kernel` (`stiffness_apply_pallas`): one field,
  any per-cell coefficient folded into G at build time;
- `stiffness_pair` replaces `_mk_kernel_pair`
  (`stiffness_apply_pallas_pair`): y = A_c1(x1) + A_c2(x2) with a unit G and
  per-cell (c1, c2), the heterogeneous Westervelt stage.

The operator data is kept in the kernel layout (`CellStiffness`): G as
(cells, 6, n^3), so that a cell reads 6 contiguous runs, cells ordered
cx*ncy*ncz + cy*ncz + cz and nodes i*n^2 + j*n + k.

The kernel is bound by its bytes (G is ~80% of them).  A block owns a
z-pencil (the ncz cells at one (cx, cy), one contiguous run of G) and walks
it in chunks of consecutive cells: one bulk copy (TMA) per chunk brings its
G into a ring of shared stages while an earlier chunk contracts, each
thread loads its share of the next chunk's x and of the y that earlier
classes left into registers before the body and writes them to shared
memory after it, the cells of a chunk add into its y there in two turns
(even, odd), and one coalesced pass writes it out.  Pencils of one colour
class, (cx % 2, cy % 2), share no node, so four launches of a persistent
grid make one apply, deterministic without atomics.  `pencil_schedule`
decides it on the host: the classes, their pencils, the cells a chunk, the
stages, the shared bytes and each chunk's 16 B-aligned bulk-copy span; the
kernel takes it as arguments.  No tensor cores: the 5 x 5 contractions are
bound by bytes, and TF32 would break the float32 gate of 1e-6.  The
parity-class design of the same kernels (eight parity classes of scattered
cells, which the pencil kernel replaced) is
``fustpu_torch.ops.anatomy``'s ``full`` and `full_pair` of its
``classes`` design.

Each kernel comes in float32, float64 and bfloat16.  In bfloat16 (the JAX
package's ``--dtype bf16``) x, y, G, D and C are stored in bfloat16 and
the kernel computes in float32, rounding y to bfloat16 where it stores it
(``stiffness_pencil.cuh``); the plain version computes the same in float32
and rounds once (``fustpu_torch.ops.spectral_mm``).

A wrapper given CPU tensors runs the kernel's plain version
(`stiffness_plain` / `stiffness_pair_plain`, the matmul formulation of
``fustpu_torch.ops.spectral_mm`` on the same data).  Given CUDA tensors it
launches the kernel or raises: there is no fallback.  Each wrapper counts
its launches in `launches` (one per apply), the bfloat16 forms' in
`bf16_launches`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from fustpu_torch.ops import spectral_mm as mm

# Applies that went through each kernel (not counting the plain version),
# and through its bfloat16 form.
launches = {"stiffness": 0, "stiffness_pair": 0}
bf16_launches = {"stiffness_bf16": 0, "stiffness_pair_bf16": 0}


def reset_launches() -> None:
    for counts in (launches, bf16_launches):
        for k in counts:
            counts[k] = 0


def count(launches: dict, bf16_launches: dict, name: str,
          dtype: torch.dtype) -> None:
    """One launch of kernel `name` in `dtype`: its bfloat16 form counts
    as `name`_bf16 in `bf16_launches`."""
    if dtype == torch.bfloat16:
        bf16_launches[f"{name}_bf16"] += 1
    else:
        launches[name] += 1


class CellStiffness(NamedTuple):
    """Stiffness operator in the kernel layout, as tensors on one device."""

    G: torch.Tensor                  # (cells, 6, n^3), coefficient folded in
    D: torch.Tensor                  # (n, n) D[q, i] = l_i'(x_q)
    nc: tuple                        # cells per axis
    C: torch.Tensor | None = None    # (cells, 2) pair coefficients (c1, c2)

    @property
    def P(self) -> int:
        return self.D.shape[0] - 1


def pack_G(G_cells, coeff: np.ndarray | None = None):
    """(cells, n^3, 6) geometry factors -> (cells, 6, n^3) kernel layout,
    with an optional per-cell coefficient folded in: a host array, or a
    tensor on the device of a tensor `G_cells` (the set-up on the card)."""
    if isinstance(G_cells, torch.Tensor):
        G = G_cells.movedim(2, 1)
        if coeff is not None:
            G = G * torch.tensor(np.asarray(coeff, np.float64).reshape(-1),
                                 device=G.device)[:, None, None]
        return G.contiguous()
    G = np.moveaxis(np.asarray(G_cells), 2, 1)
    if coeff is not None:
        G = G * np.asarray(coeff, np.float64).reshape(-1)[:, None, None]
    return np.ascontiguousarray(G)


def upload(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A host array, or a tensor (the set-up on the card), as a tensor of
    `dtype` on `device` (a copy of a host array)."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype=dtype, device=device)
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# The pencil kernel's launch schedule
# ---------------------------------------------------------------------------

# The G-stream kernels' storage types: their entry points' suffix, and the
# occupancy queries' type code by bytes a value.  bfloat16 is stored in
# 2 bytes and computed in float32 (`arith_size`).
SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
TYPE_CODE = {4: 0, 8: 1, 2: 2}


def arith_size(itemsize: int) -> int:
    """Bytes of the type a kernel computes in for a storage type of
    `itemsize` bytes: float32 for bfloat16, the storage type otherwise."""
    return 4 if itemsize == 2 else itemsize


def arith_dtype(dtype: torch.dtype) -> torch.dtype:
    """`arith_size` as a dtype: the type a kernel computes in, and holds
    its GLL nodes and weights in, for fields of `dtype`."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


SMEM_BLOCK = 232_448     # shared bytes one block may use (H100)
SMEM_SM = 233_472        # shared bytes an SM holds
SMEM_RESERVED = 1_024    # of those, what each resident block reserves
MAX_THREADS = 256        # threads a block: n^2 a cell
STAGES = 2               # stages of the G ring
TABLE_ROW = 5            # int64 a chunk-table row
ROW_RING = 3             # chunk-table rows a block keeps in shared memory


class PencilSchedule(NamedTuple):
    """How the pencil kernel runs one apply of an operator shape."""

    cpb: int                 # cells a chunk (a block has n^2 cpb threads)
    stages: int              # stages of the ring
    stage_bytes: int         # bytes a stage: cpb cells of the geometry
                             # stream (G or the corner's channels) and 16
    smem: int                # dynamic shared bytes a block
    blocks_per_sm: int       # resident blocks of that shape on an SM
    blocks: int              # persistent grid: blocks_per_sm x SMs
    classes: np.ndarray      # (nclass, 3) int64: first row, pencils, rows a
                             # pencil
    chunks: np.ndarray       # (rows, 5) int64: first cell, cells, span
                             # offset in the stream (bytes), span bytes,
                             # grid index of the chunk's node (0, 0, 0)


def _round16(b: int) -> int:
    return -(-b // 16) * 16


def corner_channels(geom_deg: int) -> int:
    """Channels a cell of the corner stream: the Jacobian's monomials (36
    trilinear, 162 triquadratic) and the coefficient (``corner.cuh``
    CornerChannels)."""
    return 9 * geom_deg * (geom_deg + 1) ** 2 + 1


def cell_values(P: int, channels: int = 0) -> int:
    """Values a cell of the pencil kernel's geometry stream: the corner's
    `channels`, or G's 6 n^3 (channels 0)."""
    return channels or 6 * (P + 1) ** 3


def pencil_smem(P: int, itemsize: int, cpb: int, pair: bool = False,
                stages: int = STAGES, ids: bool = False,
                channels: int = 0) -> tuple[int, int]:
    """(bytes a stage, dynamic shared bytes a block) of the pencil kernel:
    the stages' mbarriers and a ring of ROW_RING chunk-table rows (each
    padded to 16 B; with `ids`, the extruded stacks' form, a ring of as
    many chunks' n^2 int32 row ids after it), the stages (cpb cells of the
    geometry stream and 16 B of slack for the aligned span), two buffers
    of every cell's u (n^3 values), two of the chunk's y (n^2 (cpb P + 1)
    values), for the pair two of x2 and of the cells' (c1, c2), and what
    the geometry keeps after them: the G stream (channels 0) nothing, its
    body's f1, f2 going into G's components 0 and 1 in the stage, but in
    bfloat16 (`itemsize` 2) every cell's f1, f2 (2 n^3 values); the
    corner stream (`channels` a cell) every cell's f1, f2 and the n GLL
    nodes and weights.  The stream is stored in `itemsize` bytes a value,
    the rest in the arithmetic type (`arith_size`).  The layout of
    ``stiffness_pencil.cuh``, whose D (n^2 values) is static shared memory
    besides."""
    n = P + 1
    stage = _round16(cpb * cell_values(P, channels) * itemsize + 16)
    rows = n * n * (cpb * P + 1)
    values = 2 * n ** 3 * cpb + 2 * rows + (2 * rows + 4 * cpb if pair else 0)
    if channels:
        values += 2 * n ** 3 * cpb + 2 * n
    elif arith_size(itemsize) != itemsize:
        values += 2 * n ** 3 * cpb
    head = _round16(8 * stages) + _round16(8 * ROW_RING * TABLE_ROW)
    if ids:
        head += _round16(4 * ROW_RING * n * n)
    return stage, head + stages * stage + values * arith_size(itemsize)


def bulk_spans(cell0: np.ndarray, ncell: np.ndarray, cell_bytes: int,
               total: int) -> tuple[np.ndarray, np.ndarray]:
    """(offset, bytes) of each chunk's bulk-copy span in G: its run of
    cells [cell0, cell0 + ncell), `cell_bytes` each, widened to 16 B on
    both sides and cut back to a 16 B boundary where that would pass G's
    end (`total` bytes; the kernel reads the bytes past the span itself,
    ``bulk_copy.cuh`` `read_span_tail`)."""
    start, end = cell0 * cell_bytes, (cell0 + ncell) * cell_bytes
    off = start // 16 * 16
    stop = -(-end // 16) * 16
    stop = np.where(stop > total, end // 16 * 16, stop)
    return off, stop - off


def _static_smem(P: int, itemsize: int) -> int:
    """The kernel's static shared memory: D, n^2 values of the arithmetic
    type (`arith_size`), which the compiler rounds up to 128 B."""
    return -(-(P + 1) ** 2 * arith_size(itemsize) // 128) * 128


def model_occupancy(P: int, itemsize: int, pair: bool, cpb: int,
                    smem: int) -> int:
    """Blocks an SM holds by its threads and shared memory alone (the card's
    occupancy query also counts registers): what the CPU tests use."""
    threads = (P + 1) ** 2 * cpb
    return min(2048 // threads, 32,
               SMEM_SM // (smem + _static_smem(P, itemsize) + SMEM_RESERVED))


# The cost model of the stack and chunk kernels' schedules, in bytes of G
# streamed by the busiest SM.  A chunk step costs what the SM's resident
# blocks stream in it, but no less than STEP_FLOOR_BYTES (a block's
# per-chunk chain of waits, copies and barriers does not shrink with fewer
# blocks on the SM), and each class launch CLASS_BYTES more (its launch and
# the drain of its last round).  Both fitted to the stack kernel's times
# over 57 (cells a chunk, segments) schedules at the imported bowl (P = 4,
# float32, H100; rank correlation 0.95 with the measured times).
STEP_FLOOR_BYTES = 96_000
CLASS_BYTES = 300_000


def class_cost(units: int, per: int, cpb: int, bps: int, sms: int,
               cell_bytes: int) -> int:
    """Cost of one class launch of `units` pencils (segments, chunks) of
    `per` chunk steps each, cpb cells of `cell_bytes` of G a chunk, on a
    persistent grid of bps blocks an SM on `sms` SMs: each round of the
    grid's blocks takes `per` steps, each step the G of the busiest SM's
    blocks of that round or STEP_FLOOR_BYTES, whichever is more; plus
    CLASS_BYTES."""
    blocks, cost = bps * sms, CLASS_BYTES
    while units > 0:
        now = min(units, blocks)
        units -= now
        cost += per * max(-(-now // sms) * cpb * cell_bytes, STEP_FLOOR_BYTES)
    return cost


def _steps(nc, cpb: int, blocks: int) -> int:
    """Chunks that the busiest block of each class walks, summed over the
    classes: the apply's serial length."""
    ncx, ncy, ncz = nc
    pencils = [((ncx - pa + 1) // 2) * ((ncy - pb + 1) // 2)
               for pa in (0, 1) for pb in (0, 1)]
    return sum(-(-m // blocks) * -(-ncz // cpb) for m in pencils if m)


def pencil_schedule(nc, P: int, itemsize: int, sms: int, pair: bool = False,
                    occupancy=model_occupancy, channels: int = 0,
                    cpb: int | None = None, layout=None,
                    stages: int = STAGES) -> PencilSchedule:
    """The launch of one apply on a card of `sms` SMs, for nc cells of
    degree P in a dtype of `itemsize` bytes; `occupancy(P, itemsize, pair,
    cpb, smem)` gives the blocks an SM holds (the card's answer is 0 for a
    block beyond the kernel's launch bounds); `channels`: the corner
    stream's channels a cell (its layout, ``pencil_smem``), G's stream
    when 0; `cpb` fixes the cells a chunk; `layout(cpb)` -> (bytes a
    stage, shared bytes) replaces ``pencil_smem``'s for another policy of
    the walk (``ops/anatomy.py``), with `stages` stages of the ring.

    - cells a chunk: the cpb that makes the apply shortest, its length taken
      as the chunks that the busiest block of each class walks (`_steps`)
      times the cells that share its SM (blocks x cpb): a step of the G
      stream costs the G its SM's cells take.  A step of the corner stream
      costs the same whatever its cells (its channels are far below the
      stack model's STEP_FLOOR_BYTES; measured at P = 2, 4 and 6 by
      ``demos/exp_pencil --corner --sweep``), so there the length is the
      steps alone.  On a tie the larger cpb.  A chunk holds at most ncz
      cells and a block MAX_THREADS;
    - classes (cx % 2, cy % 2) in that order; a class's pencils in (cx, cy)
      order, each pencil's chunks along z;
    - each chunk's bulk-copy span: its run of the stream widened to 16 B
      on both sides, and cut back to a 16 B boundary where that would pass
      the stream's end (the kernel reads the bytes past the span itself)."""
    n = P + 1
    ncx, ncy, ncz = (int(c) for c in nc)
    if cpb and n * n * cpb > MAX_THREADS:
        raise ValueError(f"pencil kernel: {cpb} cells of degree {P} need "
                         f"more than {MAX_THREADS} threads")
    best = None
    for c in [cpb] if cpb else range(1, max(1, MAX_THREADS // (n * n)) + 1):
        if c > ncz:
            break
        stage, smem = (layout(c) if layout else
                       pencil_smem(P, itemsize, c, pair, channels=channels))
        if smem + _static_smem(P, itemsize) > SMEM_BLOCK:
            break
        bps = int(occupancy(P, itemsize, pair, c, smem))
        if bps < 1:
            continue
        steps = _steps((ncx, ncy, ncz), c, bps * sms)
        key = (steps * (1 if channels else c * bps), -c)
        if best is None or key < best[0]:
            best = (key, c, stage, smem, bps)
    if best is None:
        raise ValueError(f"pencil kernel: no block of degree {P}"
                         + (f" and {cpb} cells" if cpb else "")
                         + " fits an SM")
    _, cpb, stage, smem, bps = best
    c0 = np.arange(0, ncz, cpb)
    cn = np.minimum(cpb, ncz - c0)
    firsts, classes, rows = [], [], 0
    for pa in (0, 1):
        for pb in (0, 1):
            ab = (np.arange(pa, ncx, 2)[:, None] * ncy
                  + np.arange(pb, ncy, 2)[None, :]).reshape(-1)
            if ab.size == 0:
                continue
            classes.append((rows, ab.size, c0.size))
            firsts.append((ab[:, None] * ncz + c0[None, :]).reshape(-1))
            rows += ab.size * c0.size
    cell0 = np.concatenate(firsts).astype(np.int64)
    ncell = np.tile(cn, rows // c0.size).astype(np.int64)
    cb = cell_values(P, channels) * itemsize
    off, nbytes = bulk_spans(cell0, ncell, cb, ncx * ncy * ncz * cb)
    gz = ncz * P + 1
    sx = (ncy * P + 1) * gz
    a, b, c = cell0 // (ncy * ncz), (cell0 // ncz) % ncy, cell0 % ncz
    return PencilSchedule(
        cpb=cpb, stages=stages, stage_bytes=stage, smem=smem,
        blocks_per_sm=bps, blocks=bps * sms,
        classes=np.asarray(classes, np.int64).reshape(-1, 3),
        chunks=np.stack([cell0, ncell, off, nbytes,
                         a * P * sx + b * P * gz + c * P], axis=1))


# The occupancy query of the box pencils' kernel by geometry stream: G (0)
# or the corner channels of geometry degree 1.
OCCUPANCY = ("fustpu_stiffness_occupancy", "fustpu_corner_pencil_occupancy")


@functools.cache
def _card_schedule(nc: tuple, P: int, dtype: torch.dtype, pair: bool,
                   device: torch.device, geo: int = 0,
                   cpb: int | None = None) -> tuple:
    """The schedule on `device` (its SMs, its kernel's occupancy answers)
    of the geometry stream `geo`, its chunk table there and its classes as
    a C array, built once per shape (`cpb`: another cells a chunk than the
    schedule's choice)."""
    from fustpu_torch import _build

    query = getattr(_build.load(), OCCUPANCY[geo])

    def occupancy(P, itemsize, pair, cpb, smem):
        got = query(P, TYPE_CODE[itemsize], int(pair), cpb, smem)
        if got < 0:
            raise RuntimeError(f"pencil kernel occupancy query failed: "
                               f"error {-got}")
        return got

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    itemsize = torch.empty((), dtype=dtype).element_size()
    with torch.cuda.device(device):
        sched = pencil_schedule(nc, P, itemsize, sms, pair, occupancy,
                                corner_channels(geo) if geo else 0, cpb)
    classes = sched.classes.reshape(-1)
    return (sched, torch.as_tensor(sched.chunks, device=device),
            (ctypes.c_longlong * classes.size)(*classes.tolist()))


def card_schedule(op: CellStiffness, x: torch.Tensor,
                  pair: bool) -> PencilSchedule:
    """The schedule that an apply of `op` on x's card runs."""
    return _card_schedule(tuple(op.nc), op.P, x.dtype, pair, x.device)[0]


# ---------------------------------------------------------------------------
# Plain versions: the matmul formulation on the same operator data
# ---------------------------------------------------------------------------

def _expand_cells(a: torch.Tensor, nc, n: int) -> torch.Tensor:
    """(cells, ...) per-cell values -> (..., ex, ey, ez) by n-fold repeat."""
    a = a.reshape(*nc, -1)
    for ax in range(3):
        a = a.repeat_interleave(n, dim=ax)
    return a.permute(3, 0, 1, 2)


def to_mm(op: CellStiffness):
    """(MMStiffness, c1_e, c2_e) holding the same numbers as `op` in the
    matmul layout, on op's device (c*_e are None without pair
    coefficients)."""
    P, n = op.P, op.P + 1
    ncx, ncy, ncz = op.nc
    G = op.G.reshape(ncx, ncy, ncz, 6, n, n, n).permute(3, 0, 4, 1, 5, 2, 6)
    mm_op = mm.MMStiffness(
        W=tuple(mm.window_tensor(c, P, op.G.dtype, op.G.device)
                for c in op.nc),
        Dt=tuple(torch.block_diag(*([op.D] * c)) for c in op.nc),
        G=G.reshape(6, ncx * n, ncy * n, ncz * n).contiguous())
    if op.C is None:
        return mm_op, None, None
    ce = _expand_cells(op.C, op.nc, n)
    return mm_op, ce[0].contiguous(), ce[1].contiguous()


def stiffness_plain(op: CellStiffness, x: torch.Tensor) -> torch.Tensor:
    """Plain version of `stiffness`."""
    return mm.stiffness_apply_mm(to_mm(op)[0], x)


def stiffness_pair_plain(op: CellStiffness, x1: torch.Tensor,
                         x2: torch.Tensor) -> torch.Tensor:
    """Plain version of `stiffness_pair`."""
    mm_op, c1_e, c2_e = to_mm(op)
    return mm.stiffness_apply_mm_pair(mm_op, x1, x2, c1_e, c2_e)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

# the entry points' suffix of the kernels with no bfloat16 form (the
# anatomy's designs, ``ops/anatomy.py``)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(op: CellStiffness, *xs: torch.Tensor, pair: bool) -> None:
    x = xs[0]
    if x.device.type != "cuda":
        raise ValueError(f"stiffness kernel: tensor on {x.device}, "
                         "expected a CUDA device")
    if x.dtype not in SUFFIX:
        raise ValueError(f"stiffness kernel: dtype {x.dtype} unsupported "
                         "(float32, float64 or bfloat16)")
    if not 2 <= op.P <= 10:
        raise ValueError(f"stiffness kernel: degree {op.P} outside 2..10")
    n = op.P + 1
    ncells = op.nc[0] * op.nc[1] * op.nc[2]
    grid = tuple(c * op.P + 1 for c in op.nc)
    shapes = [(t, grid, "x") for t in xs] + [
        (op.G, (ncells, 6, n ** 3), "G"), (op.D, (n, n), "D")]
    if pair:
        if op.C is None:
            raise ValueError("stiffness_pair needs pair coefficients C")
        shapes.append((op.C, (ncells, 2), "C"))
    for t, shape, name in shapes:
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"stiffness kernel: {name} is {t.dtype} on "
                             f"{t.device}, expected {x.dtype} on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"stiffness kernel: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"stiffness kernel: {name} is not contiguous")


def _launch(name: str, op: CellStiffness, xs, extra,
            cpb: int | None = None) -> torch.Tensor:
    from fustpu_torch import _build

    x = xs[0]
    if op.G.data_ptr() % 16:
        raise ValueError("stiffness kernel: G's data is not 16 B-aligned "
                         "(the bulk copies need it)")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"stiffness kernel: {x.numel()} grid nodes, the "
                         "kernel indexes fewer than 2^31")
    sched, chunks, classes = _card_schedule(tuple(op.nc), op.P, x.dtype,
                                            len(xs) == 2, x.device, cpb=cpb)
    y = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    fn = getattr(_build.load(), f"fustpu_{name}_{SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(t.data_ptr() for t in xs), *extra, op.G.data_ptr(),
                 op.D.data_ptr(), y.data_ptr(), op.P, chunks.data_ptr(),
                 classes, len(sched.classes), sched.blocks, sched.cpb,
                 sched.stages, sched.stage_bytes, sched.smem, op.nc[1],
                 op.nc[2], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {err}")
    count(launches, bf16_launches, name, x.dtype)
    return y


def stiffness(op: CellStiffness, x: torch.Tensor,
              cpb: int | None = None) -> torch.Tensor:
    """y_grid = A_stiff(x_grid) through the single-field kernel (the plain
    version for a CPU tensor); `cpb`: cells a chunk in place of the
    schedule's choice (`pencil_schedule`)."""
    if x.device.type == "cpu":
        return stiffness_plain(op, x)
    _check(op, x, pair=False)
    return _launch("stiffness", op, (x,), (), cpb)


def stiffness_pair(op: CellStiffness, x1: torch.Tensor, x2: torch.Tensor,
                   cpb: int | None = None) -> torch.Tensor:
    """y_grid = A_c1(x1) + A_c2(x2) through the pair kernel (the plain
    version for CPU tensors); `cpb` as for `stiffness`."""
    if x1.device.type == "cpu":
        return stiffness_pair_plain(op, x1, x2)
    _check(op, x1, x2, pair=True)
    return _launch("stiffness_pair", op, (x1, x2), (op.C.data_ptr(),), cpb)
