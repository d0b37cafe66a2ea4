"""Extruded stiffness apply on the card: the hand-written CUDA kernels of
``fustpu_torch/csrc/extruded_stack.cu`` (the z-pencil kernel of
``stiffness_pencil.cuh`` walking the stacks) and ``extruded.cu`` (the
class-launch design it replaced), their wrappers, launch counters and
schedule, and the host build of the operator in the kernel layout.

Counterpart of ``fustpu/ops/pallas_extruded.py`` (its G-stream form):

- `extruded` replaces `_mk_kernel` through `stiffness_apply_extruded_pallas`:
  one field, any per-cell coefficient folded into G at build time;
- `extruded_pair` replaces it through
  `stiffness_apply_extruded_pallas_pair`: y = A_c1(x1) + A_c2(x2) with a
  unit G and per-cell (c1, c2), the heterogeneous Westervelt stage.

Both kernels read and write the flat field through the per-stack row ids
(dof = rows2d[s, i n + j] gz + kz P + k), so no gather or scatter runs
around them, and both scatter deterministically, without atomics.

`extruded` / `extruded_pair` run the stack kernel.  A stack is a z-pencil
whose N^2 rows are not on a grid, and its G (stack order) one contiguous
run: a block walks a stack's layers in chunks, with one bulk copy of each
chunk's G into a ring of shared stages, as the structured pencil kernel
walks a box pencil.  `stack_schedule` decides the launch on the host: the
classes are the stack colours of `colour_stacks` (no two stacks of a colour
share a row), and where a colour's stacks are too few for the card, stacks
cut into z-segments whose parity joins the colour in the class.

`extruded_classes` / `extruded_classes_pair` run the class-launch design
that the stack kernel replaced, kept as the comparison: one launch per
(colour, layer parity) class of scattered cells, G read by the threads
themselves.

`StackPlan` is the host part of both schedules on one mesh (the stack
colouring), shared by every operator built on it.  A wrapper given CPU
tensors runs the plain version (`extruded_plain` / `extruded_pair_plain`,
the einsum formulation of ``fustpu_torch.ops.extruded`` on the same data).
Given CUDA tensors it launches the kernel or raises: there is no fallback.
Each wrapper counts its applies in `launches` (one per apply, whatever the
class count).

The stack kernel also comes in bfloat16 (the JAX package's ``--dtype
bf16``: fields, G, D and C stored in bfloat16, computed in float32, y
rounded where it is stored; ``stiffness_pencil.cuh``), counted in
`bf16_launches`; its plain version computes in float32 and rounds once.
The class-launch design has float32 and float64 only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.ops import extruded as ext
from fustpu_torch.ops import spectral_mm as mm

# Applies that went through each kernel (not counting the plain version):
# the main path's, and the class-launch design's.
launches = {"extruded": 0, "extruded_pair": 0}
class_launches = {"extruded_classes": 0, "extruded_classes_pair": 0}
# the stack kernel's bfloat16 form (``cuda_stiffness.count``)
bf16_launches = {"extruded_bf16": 0, "extruded_pair_bf16": 0}


def reset_launches() -> None:
    for counts in (launches, class_launches, bf16_launches):
        for k in counts:
            counts[k] = 0


class ExtrudedCellStiffness(NamedTuple):
    """Extruded stiffness operator in the kernel layout, on one device."""

    G: torch.Tensor                  # (cells, 6, n^3), cell s*nz + kz,
                                     # coefficient folded in
    D: torch.Tensor                  # (n, n) D[q, i] = l_i'(x_q)
    rows: torch.Tensor               # (ns, n^2) int32 2D row ids
    nz: int                          # layers
    n2d: int                         # 2D rows
    plan: "StackPlan | None"         # the schedules' host part (None: the
                                     # plain version only)
    C: torch.Tensor | None = None    # (cells, 2) pair coefficients

    @property
    def P(self) -> int:
        return self.D.shape[0] - 1

    @property
    def gz(self) -> int:
        return self.nz * self.P + 1

    @property
    def ndofs(self) -> int:
        return self.n2d * self.gz


def colour_stacks(rows2d: np.ndarray) -> np.ndarray:
    """Greedy colouring of the stacks, in stack order, such that no two
    stacks of one colour share a 2D row (a footprint node).  Returns the
    (ns,) colour of each stack."""
    rows2d = np.asarray(rows2d, np.int64)
    ns, n2 = rows2d.shape
    flat = rows2d.reshape(-1)
    order = np.argsort(flat, kind="stable")
    stack_of = order // n2
    ptr = np.searchsorted(flat[order], np.arange(flat.max() + 2))
    colour = np.full(ns, -1, np.int64)
    for s in range(ns):
        r = np.unique(rows2d[s])
        nbrs = np.concatenate([stack_of[ptr[i]:ptr[i + 1]] for i in r])
        used = np.unique(colour[nbrs])
        used = used[used >= 0]
        free = np.flatnonzero(np.isin(np.arange(used.size + 1), used,
                                      invert=True))
        colour[s] = free[0]
    return colour


def scatter_classes(rows2d: np.ndarray, nz: int,
                    colour: np.ndarray | None = None
                    ) -> tuple[np.ndarray, tuple]:
    """(cells, bounds): the stack-order cell ids s*nz + kz grouped into
    classes (colour, kz % 2), each class ordered by (stack, layer), and the
    class boundaries (the class-launch design's launches; `colour`: the
    stacks' `colour_stacks`, if known).  Cells of one class share no
    dof."""
    if colour is None:
        colour = colour_stacks(rows2d)
    ids, bounds = [], [0]
    for c in range(int(colour.max()) + 1):
        stacks = np.flatnonzero(colour == c)
        for parity in (0, 1):
            kz = np.arange(parity, nz, 2)
            ids.append((stacks[:, None] * nz + kz[None, :]).reshape(-1))
            bounds.append(bounds[-1] + ids[-1].size)
    return np.concatenate(ids).astype(np.int32), tuple(bounds)


# ---------------------------------------------------------------------------
# The stack kernel's launch schedule
# ---------------------------------------------------------------------------

class StackSchedule(NamedTuple):
    """How the stack kernel runs one apply on a mesh's stacks."""

    cpb: int                 # cells a chunk (a block has n^2 cpb threads)
    segments: int            # z-segments a stack
    stages: int              # stages of the ring
    stage_bytes: int         # bytes a stage: cpb cells of the geometry
                             # stream (G or the corner's channels) and 16
    smem: int                # dynamic shared bytes a block
    blocks_per_sm: int       # resident blocks of that shape on an SM
    blocks: int              # persistent grid: blocks_per_sm x SMs
    classes: np.ndarray      # (nclass, 3) int64: first row, segments, rows
                             # a segment
    chunks: np.ndarray       # (rows, 5) int64: first cell s nz + kz0,
                             # cells, span offset in the stream (bytes),
                             # span bytes, kz0 P
    ids: np.ndarray          # (segments in table order, n^2) int32: each
                             # segment's stack's row ids


def split_even(length: int, parts: int) -> np.ndarray:
    """`parts` lengths that sum to `length` and differ by at most one, the
    longer first."""
    return length // parts + (np.arange(parts) < length % parts)


def segment_lengths(nz: int, segments: int) -> np.ndarray:
    """Layers of each of a stack's z-segments: nz split evenly, the longer
    segments all on one parity where they fit there, so that the segments
    of a class (one parity) differ as little as possible."""
    lens = np.full(segments, nz // segments)
    extra = nz % segments
    odd, even = np.arange(1, segments, 2), np.arange(0, segments, 2)
    if extra <= odd.size:
        lens[odd[:extra]] += 1
    elif extra <= even.size:
        lens[even[:extra]] += 1
    else:
        lens[odd] += 1
        lens[even[:extra - odd.size]] += 1
    return lens


def _chunks_a_segment(lens: np.ndarray, cpb: int) -> list | None:
    """Chunks of each parity's segments: the same number for every segment
    of a parity (the kernel walks a class's segments in lockstep), enough
    that none holds more than cpb layers; None where a segment of the
    parity is too short for that many."""
    out = []
    for parity in (0, 1):
        mine = lens[parity::2]
        if not mine.size:
            out.append(0)
            continue
        m = -(-int(mine.max()) // cpb)
        if m > int(mine.min()):
            return None
        out.append(m)
    return out


def _stack_cost(per_colour: np.ndarray, lens: np.ndarray, cpb: int,
                bps: int, sms: int, cell_bytes: int) -> int | None:
    """The apply's cost (``cuda_stiffness.class_cost``), summed over the
    classes (colour, segment parity); None when the segments `lens` cannot
    be chunked (`_chunks_a_segment`)."""
    per_seg = _chunks_a_segment(lens, cpb)
    if per_seg is None:
        return None
    return sum(cs.class_cost(int(m) * lens[parity::2].size, per_seg[parity],
                             cpb, bps, sms, cell_bytes)
               for parity in (0, 1) if lens[parity::2].size
               for m in per_colour if m)


def stack_schedule(colour: np.ndarray, rows2d: np.ndarray, nz: int, P: int,
                   itemsize: int, sms: int, pair: bool = False,
                   occupancy=cs.model_occupancy, segments: int | None = None,
                   cpb: int | None = None,
                   channels: int = 0) -> StackSchedule:
    """The stack kernel's launch of one apply on a card of `sms` SMs, for
    stacks of `nz` layers coloured `colour` (`colour_stacks`) with row ids
    `rows2d`, degree P, a dtype of `itemsize` bytes; `occupancy(P,
    itemsize, pair, cpb, smem)` gives the blocks an SM holds (the card's
    answer is 0 for a block beyond the kernel's launch bounds);
    `channels`: the corner stream's channels a cell (its shared-memory
    layout, ``cuda_stiffness.pencil_smem``), G's stream when 0.

    - cells a chunk and z-segments a stack: the pair whose classes cost
      least (`_stack_cost`, ``cuda_stiffness.class_cost``: each round of
      a class's segments walks their chunks, a chunk step costing the
      stream bytes that the busiest SM takes in it or a floor, and each
      class a launch); on a tie the larger cpb, then fewer segments.
      `segments` or `cpb` fix one.  The segments' layers are
      `segment_lengths`, and every segment of a class takes the same
      number of chunks (its layers split evenly among them);
    - classes (colour, segment parity) in that order, parity 1 only with
      more than one segment; a class's segments in (stack, segment) order,
      each segment's chunks along z; the row ids, one row a segment, in
      the same order;
    - each chunk's bulk-copy span as the pencil kernel's
      (``cuda_stiffness.bulk_spans``)."""
    cell_bytes = cs.cell_values(P, channels) * itemsize
    n = P + 1
    if cpb and n * n * cpb > cs.MAX_THREADS:
        raise ValueError(f"stack kernel: {cpb} cells of degree {P} need "
                         f"more than {cs.MAX_THREADS} threads")
    colour = np.asarray(colour, np.int64)
    per_colour = np.bincount(colour)
    best = None
    cpbs = [cpb] if cpb else range(1, max(1, cs.MAX_THREADS // (n * n)) + 1)
    segs = [segments] if segments else range(1, nz + 1)
    for c in cpbs:
        if c > nz:
            break
        stage, smem = cs.pencil_smem(P, itemsize, c, pair, ids=True,
                                     channels=channels)
        if smem + cs._static_smem(P, itemsize) > cs.SMEM_BLOCK:
            break
        bps = int(occupancy(P, itemsize, pair, c, smem))
        if bps < 1:
            continue
        for nseg in segs:
            cost = _stack_cost(per_colour, segment_lengths(nz, nseg), c,
                               bps, sms, cell_bytes)
            if cost is None:
                continue
            key = (cost, -c, nseg)
            if best is None or key < best[0]:
                best = (key, c, nseg, stage, smem, bps)
    if best is None:
        raise ValueError(f"stack kernel: no schedule of degree {P} fits an "
                         f"SM (cpb {cpb}, segments {segments})")
    _, cpb, nseg, stage, smem, bps = best
    lens = segment_lengths(nz, nseg)
    z0 = np.concatenate([[0], np.cumsum(lens)[:-1]])
    per_seg = _chunks_a_segment(lens, cpb)
    ck = []                          # each segment's chunks: layer, layers
    for g, (z, m) in enumerate(zip(z0, lens)):
        sizes = split_even(int(m), per_seg[g % 2])
        ck.append((z + np.concatenate([[0], np.cumsum(sizes)[:-1]]), sizes))
    classes, cell0, ncell, seg_stack = [], [], [], []
    rows = 0
    for c in range(per_colour.size):
        stacks = np.flatnonzero(colour == c)
        for parity in (0, 1):
            mine = range(parity, nseg, 2)
            if not len(mine) or not stacks.size:
                continue
            classes.append((rows, stacks.size * len(mine), per_seg[parity]))
            rows += stacks.size * len(mine) * per_seg[parity]
            for s in stacks:
                for g in mine:
                    cell0.append(s * nz + ck[g][0])
                    ncell.append(ck[g][1])
                    seg_stack.append(s)
    cell0 = np.concatenate(cell0).astype(np.int64)
    ncell = np.concatenate(ncell).astype(np.int64)
    off, nbytes = cs.bulk_spans(cell0, ncell, cell_bytes,
                                colour.size * nz * cell_bytes)
    return StackSchedule(
        cpb=cpb, segments=nseg, stages=cs.STAGES, stage_bytes=stage,
        smem=smem, blocks_per_sm=bps, blocks=bps * sms,
        classes=np.asarray(classes, np.int64).reshape(-1, 3),
        chunks=np.stack([cell0, ncell, off, nbytes, (cell0 % nz) * P],
                        axis=1),
        ids=np.ascontiguousarray(np.asarray(rows2d, np.int32)[seg_stack]))


# The stack kernel's occupancy query by geometry: the G stream (0) and the
# corner stream of geometry degree 1 (hex8) or 2 (hex27)
OCCUPANCY = ("fustpu_extruded_stack_occupancy",
             "fustpu_extruded_corner_stack_occupancy",
             "fustpu_extruded_corner_hex27_stack_occupancy")


class StackPlan:
    """The host part of the extruded kernels' schedules on one mesh's
    stacks: their colouring (`colour_stacks`), from which the class-launch
    designs' classes and, per card, dtype, form and geometry stream, the
    stack kernel's schedule follow (each built on first use and kept)."""

    def __init__(self, rows2d: np.ndarray, nz: int):
        self.rows2d = np.ascontiguousarray(rows2d, np.int32)
        self.nz = int(nz)
        self.colour = colour_stacks(self.rows2d)
        self._card = {}

    def __getstate__(self) -> dict:
        """Pickled (a model saved for ranks) without the per-card cache of
        device tensors and C arrays, which each process builds anew."""
        return {**self.__dict__, "_card": {}}

    @functools.cached_property
    def classes(self) -> tuple[np.ndarray, tuple]:
        """The class-launch design's (cells, bounds) (`scatter_classes`)."""
        return scatter_classes(self.rows2d, self.nz, self.colour)

    def class_cells(self, device) -> tuple[torch.Tensor, tuple]:
        """`classes` with the cell ids on `device`."""
        key = ("classes", torch.device(device))
        if key not in self._card:
            cells, bounds = self.classes
            self._card[key] = (torch.as_tensor(cells, device=device), bounds)
        return self._card[key]

    def card(self, P: int, dtype: torch.dtype, pair: bool, device,
             segments: int | None = None, cpb: int | None = None,
             geo: int = 0) -> tuple:
        """(schedule, chunk table, row ids, classes as a C array) of the
        stack kernel on `device` (its SMs, its occupancy answers); `segments`
        and `cpb` as `stack_schedule` takes them; `geo`: the geometry
        stream, G (0) or the corner channels of geometry degree 1 or 2."""
        device = torch.device(device)
        key = (P, dtype, pair, device, segments, cpb, geo)
        if key not in self._card:
            from fustpu_torch import _build

            query = getattr(_build.load(), OCCUPANCY[geo])

            def occupancy(P, itemsize, pair, cpb, smem):
                got = query(P, cs.TYPE_CODE[itemsize], int(pair), cpb,
                            smem)
                if got < 0:
                    raise RuntimeError(f"stack kernel occupancy query "
                                       f"failed: error {-got}")
                return got

            sms = torch.cuda.get_device_properties(
                device).multi_processor_count
            itemsize = torch.empty((), dtype=dtype).element_size()
            with torch.cuda.device(device):
                sched = stack_schedule(
                    self.colour, self.rows2d, self.nz, P, itemsize, sms,
                    pair, occupancy, segments, cpb,
                    cs.corner_channels(geo) if geo else 0)
            classes = sched.classes.reshape(-1)
            self._card[key] = (
                sched, torch.as_tensor(sched.chunks, device=device),
                torch.as_tensor(sched.ids, device=device),
                (ctypes.c_longlong * classes.size)(*classes.tolist()))
        return self._card[key]


def card_schedule(op: "ExtrudedCellStiffness", x: torch.Tensor,
                  pair: bool) -> StackSchedule:
    """The schedule that an apply of `op` on x's card runs."""
    return op.plan.card(op.P, x.dtype, pair, x.device)[0]


def stack_order(mesh, a):
    """Per-cell rows of `a` (mesh cell order; a host array, or a tensor on
    its device) in stack order s*nz + kz."""
    if isinstance(a, torch.Tensor):
        return a[torch.as_tensor(mesh.stack_cells.reshape(-1),
                                 device=a.device)]
    return np.asarray(a)[mesh.stack_cells.reshape(-1)]


def build(mesh, G_cells, D_1d: np.ndarray, dtype: torch.dtype,
          device, coeff=None, pair=None,
          plan: StackPlan | None = None) -> ExtrudedCellStiffness:
    """The operator in the kernel layout on `device`, from float64 data:
    G_cells (cells, n^3, 6) in mesh cell order (a host array, or a tensor
    of the set-up on the card); `coeff` (per-cell) is folded into G; `pair`
    = (c1, c2) per-cell fields makes a unit-G pair operator; `plan`: the
    mesh's `StackPlan`, if known."""
    c = None if coeff is None else stack_order(mesh, np.broadcast_to(
        np.asarray(coeff, np.float64), (mesh.num_cells,)))
    G = cs.pack_G(stack_order(mesh, G_cells), c)
    C = None
    if pair is not None:
        C = np.stack([stack_order(mesh, np.broadcast_to(
            np.asarray(c, np.float64), (mesh.num_cells,))) for c in pair],
            axis=1)
    return from_host(mesh, G, D_1d, dtype, device, C, plan)


def from_host(mesh, G: np.ndarray, D_1d: np.ndarray, dtype: torch.dtype,
              device, C: np.ndarray | None = None,
              plan: StackPlan | None = None) -> ExtrudedCellStiffness:
    """Upload kernel-layout host arrays (G (cells, 6, n^3), a host array or
    a tensor, and C (cells, 2) in stack order) and the mesh's rows, with
    the schedules' host part `plan` (made here unless given)."""
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return ExtrudedCellStiffness(
        G=cs.upload(G, dtype, device), D=t(D_1d),
        rows=torch.as_tensor(np.ascontiguousarray(mesh.rows2d, np.int32),
                             device=device),
        nz=mesh.nz, n2d=mesh.n2d,
        plan=plan or StackPlan(mesh.rows2d, mesh.nz),
        C=None if C is None else t(C))


# ---------------------------------------------------------------------------
# Plain versions: the einsum formulation on the same operator data
# ---------------------------------------------------------------------------

def to_plain(op: ExtrudedCellStiffness):
    """(PlainExtruded, c1_x, c2_x) holding the same numbers as `op` in the
    einsum layout, on op's device (c*_x are None without pair
    coefficients)."""
    n, nz = op.P + 1, op.nz
    ns = op.rows.shape[0]
    G6 = op.G.reshape(ns, nz, 6, n, n, n).permute(2, 0, 3, 4, 1, 5)
    plain = ext.PlainExtruded(
        rows=op.rows.reshape(-1).long(),
        G6=G6.reshape(6, ns, n, n, nz * n).contiguous(),
        Wz=mm.window_tensor(nz, op.P, op.G.dtype, op.G.device),
        Dz=torch.block_diag(*([op.D] * nz)), D=op.D)
    if op.C is None:
        return plain, None, None
    ce = op.C.reshape(ns, nz, 2).repeat_interleave(n, dim=1)
    return (plain, ce[..., 0].reshape(ns, 1, 1, -1).contiguous(),
            ce[..., 1].reshape(ns, 1, 1, -1).contiguous())


def extruded_plain(op: ExtrudedCellStiffness,
                   x: torch.Tensor) -> torch.Tensor:
    """Plain version of `extruded`."""
    return ext.stiffness_apply_extruded(x, to_plain(op)[0], op.ndofs)


def extruded_pair_plain(op: ExtrudedCellStiffness, x1: torch.Tensor,
                        x2: torch.Tensor) -> torch.Tensor:
    """Plain version of `extruded_pair`."""
    plain, c1_x, c2_x = to_plain(op)
    return ext.stiffness_apply_extruded_pair(x1, x2, plain, op.ndofs, c1_x,
                                             c2_x)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

# the class-launch design's types (the main path's: cs.SUFFIX)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(op: ExtrudedCellStiffness, *xs: torch.Tensor, pair: bool,
           types: dict = cs.SUFFIX) -> None:
    x = xs[0]
    if x.device.type != "cuda":
        raise ValueError(f"extruded kernel: tensor on {x.device}, "
                         "expected a CUDA device")
    if x.dtype not in types:
        raise ValueError(f"extruded kernel: dtype {x.dtype} unsupported "
                         f"({', '.join(map(str, types))})")
    if not 2 <= op.P <= 10:
        raise ValueError(f"extruded kernel: degree {op.P} outside 2..10")
    if op.plan is None:
        raise ValueError("extruded kernel: the operator has no StackPlan "
                         "(a plain-version operator)")
    n = op.P + 1
    ns = op.rows.shape[0]
    ncells = ns * op.nz
    shapes = [(t, (op.ndofs,), x.dtype, "x") for t in xs] + [
        (op.G, (ncells, 6, n ** 3), x.dtype, "G"),
        (op.D, (n, n), x.dtype, "D"),
        (op.rows, (ns, n * n), torch.int32, "rows")]
    if pair:
        if op.C is None:
            raise ValueError("extruded_pair needs pair coefficients C")
        shapes.append((op.C, (ncells, 2), x.dtype, "C"))
    for t, shape, dtype, name in shapes:
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"extruded kernel: {name} is {t.dtype} on "
                             f"{t.device}, expected {dtype} on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"extruded kernel: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"extruded kernel: {name} is not contiguous")
    if op.plan.colour.size != ns or op.plan.nz != op.nz:
        raise ValueError(f"extruded kernel: the plan covers "
                         f"{op.plan.colour.size} stacks of {op.plan.nz} "
                         f"layers, the operator {ns} of {op.nz}")


def _launch_stack(name: str, op: ExtrudedCellStiffness, xs, extra,
                  segments: int | None = None,
                  cpb: int | None = None) -> torch.Tensor:
    """One apply through the stack kernel (`segments`, `cpb`: a schedule
    other than the model's, as `stack_schedule` takes them)."""
    from fustpu_torch import _build

    x = xs[0]
    if op.G.data_ptr() % 16:
        raise ValueError("extruded kernel: G's data is not 16 B-aligned "
                         "(the bulk copies need it)")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"extruded kernel: {x.numel()} dofs, the stack "
                         "kernel indexes fewer than 2^31")
    sched, chunks, ids, classes = op.plan.card(op.P, x.dtype, len(xs) == 2,
                                               x.device, segments, cpb)
    y = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    fn = getattr(_build.load(), f"fustpu_extruded_stack"
                 f"{'_pair' if len(xs) == 2 else ''}_{cs.SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(t.data_ptr() for t in xs), *extra, op.G.data_ptr(),
                 op.D.data_ptr(), y.data_ptr(), op.P, chunks.data_ptr(),
                 ids.data_ptr(), classes, len(sched.classes), sched.blocks,
                 sched.cpb, sched.stages, sched.stage_bytes, sched.smem,
                 op.nz, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {err}")
    cs.count(launches, bf16_launches, name, x.dtype)
    return y


def _launch_classes(name: str, op: ExtrudedCellStiffness, xs, extra
                    ) -> torch.Tensor:
    """One apply through the class-launch kernel."""
    from fustpu_torch import _build

    x = xs[0]
    cells, bounds = op.plan.class_cells(x.device)
    y = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    fn = getattr(_build.load(), f"fustpu_extruded"
                 f"{'_pair' if len(xs) == 2 else ''}_{_SUFFIX[x.dtype]}")
    b = (ctypes.c_longlong * len(bounds))(*bounds)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(t.data_ptr() for t in xs), *extra, op.G.data_ptr(),
                 op.D.data_ptr(), op.rows.data_ptr(), cells.data_ptr(),
                 ctypes.addressof(b), len(bounds) - 1,
                 y.data_ptr(), op.P, op.nz, op.gz, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {err}")
    class_launches[name] += 1
    return y


def extruded(op: ExtrudedCellStiffness, x: torch.Tensor, **schedule
             ) -> torch.Tensor:
    """y = A_stiff(x) on flat fields through the single-field stack kernel
    (the plain version for a CPU tensor); `schedule`: `segments` and / or
    `cpb` in place of the model's choice."""
    if x.device.type == "cpu":
        return extruded_plain(op, x)
    _check(op, x, pair=False)
    return _launch_stack("extruded", op, (x,), (), **schedule)


def extruded_pair(op: ExtrudedCellStiffness, x1: torch.Tensor,
                  x2: torch.Tensor, **schedule) -> torch.Tensor:
    """y = A_c1(x1) + A_c2(x2) on flat fields through the pair stack kernel
    (the plain version for CPU tensors)."""
    if x1.device.type == "cpu":
        return extruded_pair_plain(op, x1, x2)
    _check(op, x1, x2, pair=True)
    return _launch_stack("extruded_pair", op, (x1, x2), (op.C.data_ptr(),),
                         **schedule)


def extruded_classes(op: ExtrudedCellStiffness,
                     x: torch.Tensor) -> torch.Tensor:
    """`extruded` through the class-launch kernel (the plain version for a
    CPU tensor)."""
    if x.device.type == "cpu":
        return extruded_plain(op, x)
    _check(op, x, pair=False, types=_SUFFIX)
    return _launch_classes("extruded_classes", op, (x,), ())


def extruded_classes_pair(op: ExtrudedCellStiffness, x1: torch.Tensor,
                          x2: torch.Tensor) -> torch.Tensor:
    """`extruded_pair` through the class-launch kernel (the plain version
    for CPU tensors)."""
    if x1.device.type == "cpu":
        return extruded_pair_plain(op, x1, x2)
    _check(op, x1, x2, pair=True, types=_SUFFIX)
    return _launch_classes("extruded_classes_pair", op, (x1, x2),
                           (op.C.data_ptr(),))
