"""Indexed stiffness apply on the card (any conforming hex mesh): the
hand-written CUDA kernels of ``fustpu_torch/csrc/indexed_chunk.cu`` (cell
chunks with a bulk-copied G ring) and ``indexed.cu`` (the class-launch
design it replaced), their wrappers, launch counters and schedule, and the
host build of the operator in the kernel layout.

Counterpart of the fused gather/scatter engine of
``fustpu/ops/pallas_gather.py`` (`_mk_fused_kernel` through `fused_apply`
and `fused_apply_pair`):

- `indexed` replaces its 'plain' and 'coeff' modes: one field, any
  per-cell coefficient folded into G at build time;
- `indexed_pair` replaces its 'pair' mode: y = A_c1(x1) + A_c2(x2) with a
  unit G and per-cell (c1, c2), the heterogeneous Westervelt stage.

`indexed` / `indexed_pair` run the chunk kernel (in bfloat16 its lean
form, below).  The mesh's cells are in
`locality_order`, so consecutive cells are a compact blob whose G is one
contiguous run: a block walks chunks of consecutive cells, one bulk copy
of each chunk's G into a ring of shared stages, and reads x and writes y
through a chunk-local table built on the host (`chunk_tables`: the chunk's
unique dofs and its inverse map, for each unique dof the (cell, node)
positions that hold it), once per unique dof.  `chunk_schedule` decides
the launch: the cells a chunk, and classes of chunks that share no dof
(`colour_sets` over the chunks' dofs), one launch of a persistent grid
each.  The scatter is deterministic, without atomics.

`indexed_classes` / `indexed_classes_pair` run the class-launch design
that the chunk kernel replaced, kept as the comparison: `colour_cells`
colours the cells so that no two cells of a colour share a dof, and the
kernel runs one launch per colour of scattered cells, reading G and the
dofmap by its threads.

`ChunkPlan` is the host part of both schedules on one dofmap, shared by
every operator built on it.  A wrapper given CPU tensors runs the plain
version (`indexed_plain` / `indexed_pair_plain`,
``fustpu_torch.ops.indexed`` on the same data).  Given CUDA tensors it
launches the kernel or raises: there is no fallback.  Each wrapper counts
its applies in `launches` (one per apply, whatever the class count).

The chunk kernel also comes in bfloat16 (the JAX package's ``--dtype
bf16``: fields, G, D and C stored in bfloat16, computed in float32, each
unique dof's sum over a chunk in float32, rounded where y is stored, and
again by each later colour class that adds to the dof, once per class
that touches it), counted in `bf16_launches`; its plain version computes
in float32 and rounds once.  A bfloat16 apply runs the lean chunk kernel
(``csrc/indexed_lean.cu``: overlapped class launches, no y read or
zeroed in a dof's first class, three barriers a chunk) at the degrees of
`LEAN_BF16`, on the first design's chunks and classes, and the first
bfloat16 form (``indexed_chunk.cu``) at the others;
that form is also reached as `indexed_first` / `indexed_pair_first`, the
comparison, counted in `comparison_launches`.  `bf16_launches` counts
`name`_bf16 on the lean kernel, `name`_bf16_first_walk on the first
(``cuda_stiffness.bf16_key``).  The class-launch design has float32 and
float64 only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.ops import indexed as idx

# Applies that went through each kernel (not counting the plain version):
# the main path's, and the class-launch design's.
launches = {"indexed": 0, "indexed_pair": 0}
class_launches = {"indexed_classes": 0, "indexed_classes_pair": 0}
# the chunk kernel's bfloat16 form on the main path (``cuda_stiffness.count``:
# the lean chunk kernel, and the first bfloat16 form outside LEAN_BF16), and
# the first bfloat16 form called as the lean kernel's comparison
bf16_launches = {"indexed_bf16": 0, "indexed_pair_bf16": 0,
                 "indexed_bf16_first_walk": 0,
                 "indexed_pair_bf16_first_walk": 0}
comparison_launches = {"indexed_first_bf16": 0,
                       "indexed_pair_first_bf16": 0}


def reset_launches() -> None:
    for counts in (launches, class_launches, bf16_launches,
                   comparison_launches):
        for k in counts:
            counts[k] = 0


class IndexedCellStiffness(NamedTuple):
    """Indexed stiffness operator in the kernel layout, on one device."""

    G: torch.Tensor                  # (cells, 6, n^3), coefficient folded in
    D: torch.Tensor                  # (n, n) D[q, i] = l_i'(x_q)
    dofmap: torch.Tensor             # (cells, n^3) int32
    ndofs: int
    plan: "ChunkPlan | None"         # the schedules' host part (None: the
                                     # plain version only)
    C: torch.Tensor | None = None    # (cells, 2) pair coefficients

    @property
    def P(self) -> int:
        return self.D.shape[0] - 1


def colour_sets(sets, ndofs: int) -> np.ndarray:
    """Greedy colouring of dof sets (cells, or chunks of cells), in order,
    such that no two sets of one colour share a dof: each dof keeps a
    bitmask of the colours of the sets that touch it, and a set takes the
    lowest colour free on all of its dofs.  Returns the colour of each
    set."""
    used = np.zeros(ndofs, np.uint64)
    colour = []
    for c, ids in enumerate(sets):
        taken = int(np.bitwise_or.reduce(used[ids]))
        k = (~taken & (taken + 1)).bit_length() - 1    # lowest free colour
        if k >= 64:
            raise ValueError(f"set {c} needs more than 64 colours")
        colour.append(k)
        used[ids] |= np.uint64(1 << k)
    return np.asarray(colour, np.int64)


def colour_cells(dofmap: np.ndarray, ndofs: int) -> np.ndarray:
    """The (cells,) colour of each cell: `colour_sets` of the dofmap's
    rows, in cell order."""
    return colour_sets(np.asarray(dofmap, np.int64), ndofs)


def scatter_classes(dofmap: np.ndarray, ndofs: int) -> tuple[np.ndarray,
                                                              tuple]:
    """(cells, bounds): the cell ids grouped into colour classes, each in
    ascending order, and the class boundaries.  Cells of one class share
    no dof."""
    colour = colour_cells(dofmap, ndofs)
    ids = [np.flatnonzero(colour == k) for k in range(int(colour.max()) + 1)]
    dm = np.asarray(dofmap)
    for k, cls in enumerate(ids):
        # the kernel's plain y += is race-free only on dof-disjoint classes
        if np.bincount(dm[cls].reshape(-1), minlength=ndofs).max() > 1:
            raise RuntimeError(f"colour class {k} shares a dof")
    bounds = tuple(int(b) for b in np.cumsum([0] + [a.size for a in ids]))
    return np.concatenate(ids).astype(np.int32), bounds


# ---------------------------------------------------------------------------
# The chunk kernel's tables and launch schedule
# ---------------------------------------------------------------------------

class ChunkTables(NamedTuple):
    """A dofmap cut into chunks of cpb consecutive cells, with each chunk's
    local table and colour (`chunk_tables`)."""

    cpb: int
    cell0: np.ndarray        # (chunks,) first cell
    ncell: np.ndarray        # (chunks,) cells
    u0: np.ndarray           # (chunks,) first entry in `uniq` / `ends`
    nu: np.ndarray           # (chunks,) unique dofs
    uniq: np.ndarray         # (sum nu,) int32 each chunk's dofs, ascending
    ends: np.ndarray         # (sum nu,) int16 end of each unique dof's
                             # entries in its chunk's `pos` run
    pos: np.ndarray          # (cells n^3,) int16 chunk-local positions
                             # (cell - cell0) n^3 + node, grouped by unique
                             # dof, ascending within each
    colour: np.ndarray       # (chunks,) colour (`colour_sets`)
    lead_ends: np.ndarray    # (sum nu,) int16 `ends` with bit 15 set where
                             # the chunk is the dof's first (lowest colour)
                             # holder: the lean kernel reads no y there

    @property
    def maxu(self) -> int:
        return int(self.nu.max())


def chunk_tables(dofmap: np.ndarray, ndofs: int, cpb: int) -> ChunkTables:
    """Cut the cells into chunks of cpb consecutive cells (the last one
    shorter) and build each chunk's table: its unique dofs, and its inverse
    map (for each unique dof, the chunk's (cell, node) positions that hold
    it, in ascending order: `pos` from the chunk's first cell's position,
    `ends` the exclusive end of each dof's entries there); colour the
    chunks in order so that no two chunks of a colour share a dof; and flag
    each
    chunk's unique dofs that no chunk of a lower colour holds (`lead_ends`,
    bit 15 of `ends`): the colour classes run in ascending order, so there
    the y that earlier classes left is the zero y starts from."""
    dm = np.asarray(dofmap)
    cells, nnn = dm.shape
    if cpb * nnn >= 2 ** 15:
        raise ValueError(f"chunks of {cpb} cells of {nnn} nodes: the int16 "
                         "positions hold fewer than 2^15")
    cell0 = np.arange(0, cells, cpb, dtype=np.int64)
    ncell = np.minimum(cpb, cells - cell0)
    chunk = np.repeat(np.arange(cell0.size), ncell * nnn)
    key = chunk * np.int64(ndofs) + dm.reshape(-1)
    uk, inv = np.unique(key, return_inverse=True)
    uchunk = uk // ndofs
    u0 = np.searchsorted(uchunk, np.arange(cell0.size))
    nu = np.diff(np.append(u0, uk.size))
    first = cell0 * nnn                       # a chunk's first position
    ends = np.cumsum(np.bincount(inv, minlength=uk.size)) - first[uchunk]
    order = np.argsort(inv, kind="stable")
    uniq = (uk % ndofs).astype(np.int32)
    colour = colour_sets((uniq[a:a + m] for a, m in zip(u0, nu)), ndofs)
    held = colour[uchunk]                     # each entry's chunk's colour
    lowest = np.full(ndofs, np.iinfo(np.int64).max)
    np.minimum.at(lowest, uniq, held)
    ends = ends.astype(np.int16)
    lead = np.where(held == lowest[uniq], np.int16(-2 ** 15), np.int16(0))
    return ChunkTables(cpb=cpb, cell0=cell0, ncell=ncell, u0=u0, nu=nu,
                       uniq=uniq, ends=ends,
                       pos=(order - first[chunk[order]]).astype(np.int16),
                       colour=colour, lead_ends=ends | lead)


CHUNK_ROW = 6            # int64 a chunk-table row
CHUNK_RING = 4           # chunk-table rows a block keeps in shared memory
ID_RING = 3              # chunks' unique ids a block keeps
SHORTLIST = 3            # cells-a-chunk candidates whose tables are built


class ChunkSchedule(NamedTuple):
    """How the chunk kernel runs one apply on a dofmap."""

    cpb: int                 # cells a chunk (a block has n^2 cpb threads)
    stages: int              # stages of the G ring
    stage_bytes: int         # bytes a stage: cpb cells of G and 16
    smem: int                # dynamic shared bytes a block
    maxu: int                # the most unique dofs of a chunk
    blocks_per_sm: int       # resident blocks of that shape on an SM
    blocks: int              # persistent grid: blocks_per_sm x SMs
    classes: np.ndarray      # (nclass, 2) int64: first row, chunks
    chunks: np.ndarray       # (rows, 6) int64: first cell, cells, span
                             # offset in G (bytes), span bytes, first
                             # entry in uniq / ends, unique dofs


def chunk_smem(P: int, itemsize: int, cpb: int, maxu: int,
               pair: bool = False) -> tuple[int, int]:
    """(bytes a stage, dynamic shared bytes a block) of the chunk kernel:
    the stages' mbarriers and a ring of CHUNK_RING table rows (each padded
    to 16 B), the stages (cpb cells of G, stored in `itemsize` bytes a
    value, and 16 B of slack; the cells' node sums go over G there), the
    cells' u (n^3 values a cell), two buffers of the earlier y (maxu
    values), for the pair two of the cells' (c1, c2), in bfloat16
    (`itemsize` 2) the cells' f1, f2 (2 n^3 values a cell), a ring of
    ID_RING chunks' unique ids (maxu int32), two buffers of the inverse
    map's ends (maxu int16) and two of its positions (cpb n^3 int16): the
    layout of ``indexed_chunk.cu``, values in the arithmetic type
    (``cuda_stiffness.arith_size``), whose D (n^2 values) is static shared
    memory besides."""
    nnn = (P + 1) ** 3
    stage = cs._round16(cpb * 6 * nnn * itemsize + 16)
    head = cs._round16(8 * cs.STAGES) + cs._round16(8 * CHUNK_RING * CHUNK_ROW)
    values = cpb * nnn + 2 * maxu + (4 * cpb if pair else 0)
    if cs.arith_size(itemsize) != itemsize:
        values += 2 * cpb * nnn
    return stage, (head + cs.STAGES * stage + values * cs.arith_size(itemsize)
                   + 4 * ID_RING * maxu + 2 * 2 * maxu + 2 * 2 * cpb * nnn)


def chunk_schedule(plan: "ChunkPlan", P: int, itemsize: int, sms: int,
                   pair: bool = False, occupancy=cs.model_occupancy,
                   cpb: int | None = None) -> ChunkSchedule:
    """The chunk kernel's launch of one apply on a card of `sms` SMs, for
    the dofmap of `plan` at degree P in a dtype of `itemsize` bytes;
    `occupancy(P, itemsize, pair, cpb, smem)` gives the blocks an SM holds.

    - cells a chunk: the cpb whose classes cost least
      (``cuda_stiffness.class_cost``, one chunk step a chunk); on a tie the
      larger cpb.  The colouring that fixes the classes needs the cpb's
      tables, so the SHORTLIST cheapest cpb by an estimate (8 equal
      classes, the fewest a hex mesh's vertex allows, and the shared
      memory of chunks whose cells share no dof) get their tables
      (`chunk_tables`, kept in the plan) and are costed with their own
      classes and the card's occupancy answer for their fullest chunk.
      `cpb` fixes it;
    - classes: the chunks' colours in order, each class's chunks ascending;
    - each chunk's bulk-copy span as the pencil kernel's
      (``cuda_stiffness.bulk_spans``)."""
    nnn = (P + 1) ** 3
    cells, cb = plan.cells, 6 * nnn * itemsize
    if cpb and (P + 1) ** 2 * cpb > cs.MAX_THREADS:
        raise ValueError(f"chunk kernel: {cpb} cells of degree {P} need "
                         f"more than {cs.MAX_THREADS} threads")
    estimates = []
    for c in ([cpb] if cpb else
              range(1, max(1, cs.MAX_THREADS // (P + 1) ** 2) + 1)):
        if c > cells and not cpb:
            break
        _, smem = chunk_smem(P, itemsize, c, c * nnn, pair)
        if smem + cs._static_smem(P, itemsize) > cs.SMEM_BLOCK:
            break
        bps = int(occupancy(P, itemsize, pair, c, smem))
        if bps < 1:
            continue
        chunks = -(-cells // c)
        estimates.append((8 * cs.class_cost(-(-chunks // 8), 1, c, bps, sms,
                                            cb), -c))
    if not estimates:
        raise ValueError(f"chunk kernel: no block of degree {P} fits an SM")
    best = None
    for _, c in sorted(estimates)[:SHORTLIST]:
        tab = plan.tables(-c)
        stage, smem = chunk_smem(P, itemsize, tab.cpb, tab.maxu, pair)
        bps = int(occupancy(P, itemsize, pair, tab.cpb, smem))
        classes = np.bincount(tab.colour)
        key = (sum(cs.class_cost(int(m), 1, tab.cpb, bps, sms, cb)
                   for m in classes), c)
        if best is None or key < best[0]:
            best = (key, tab, stage, smem, bps, classes)
    _, tab, stage, smem, bps, classes = best
    order = np.argsort(tab.colour, kind="stable")
    cell0, ncell = tab.cell0[order], tab.ncell[order]
    off, nbytes = cs.bulk_spans(cell0, ncell, cb, cells * cb)
    return ChunkSchedule(
        cpb=tab.cpb, stages=cs.STAGES, stage_bytes=stage, smem=smem,
        maxu=tab.maxu, blocks_per_sm=bps, blocks=bps * sms,
        classes=np.stack([np.cumsum(classes) - classes, classes], axis=1),
        chunks=np.stack([cell0, ncell, off, nbytes, tab.u0[order],
                         tab.nu[order]], axis=1).astype(np.int64))


# The degrees (P, pair?) at which a bfloat16 apply runs the lean chunk
# kernel (``csrc/indexed_lean.cu``): where it measured faster than the first
# bfloat16 form in turns on the 64 x 40 x 40 general box (``demos/
# exp_engine_bf16 --indexed``, H100; PERF.md, the bf16 rows of #11).  From
# P = 5 on its register cap spills; P = 9, 10 were not timed.
# ``indexed_lean.cu`` instantiates the kernel at these degrees only
# (FUSTPU_LEAN_CHUNK_SINGLE, FUSTPU_LEAN_CHUNK_PAIR).
LEAN_BF16 = frozenset({(2, True), (3, False), (3, True), (4, False),
                       (4, True)})


def lean_runs(P: int, pair: bool, dtype: torch.dtype) -> bool:
    """Whether an apply of degree P (pair or not) in `dtype` runs the lean
    chunk kernel: bfloat16 at the degrees of `LEAN_BF16`."""
    return dtype == torch.bfloat16 and (P, pair) in LEAN_BF16


def design(P: int, pair: bool, dtype: torch.dtype) -> str:
    """The chunk kernel that such an apply runs: "lean" where `lean_runs`,
    else "first"."""
    return "lean" if lean_runs(P, pair, dtype) else "first"


def lean_schedule(first: ChunkSchedule, P: int, sms: int, pair: bool,
                  occupancy) -> ChunkSchedule:
    """The lean chunk kernel's launch of the first design's schedule
    `first`: the same cells a chunk, chunk table and classes (a dof shared
    by chunks of k classes is rounded k times, so another schedule would
    round other dofs) and its shared layout (`chunk_smem`, which the lean
    kernel's launcher checks), with the lean kernel's blocks an SM,
    `occupancy(P, 2, pair, cpb, smem)`, in the persistent grid."""
    bps = int(occupancy(P, 2, pair, first.cpb, first.smem))
    if bps < 1:
        raise ValueError(f"lean chunk kernel: no block of {first.cpb} cells "
                         f"of degree {P} fits an SM")
    return first._replace(blocks_per_sm=bps, blocks=bps * sms)


class ChunkPlan:
    """The host part of the indexed kernels' schedules on one dofmap: the
    chunk tables of each cells-a-chunk (`chunk_tables`), the class-launch
    design's colour classes (`scatter_classes`) and, per card, dtype and
    form, the chunk kernel's schedule, each built on first use and kept,
    so that every operator of a mesh shares them."""

    def __init__(self, dofmap: np.ndarray, ndofs: int):
        self.dofmap = np.asarray(dofmap)
        self.ndofs = int(ndofs)
        self.cells = self.dofmap.shape[0]
        self._tables = {}
        self._card = {}

    def __getstate__(self) -> dict:
        """Pickled (a model saved for ranks) without the per-card cache of
        device tensors and C arrays, which each process builds anew."""
        return {**self.__dict__, "_card": {}}

    def tables(self, cpb: int) -> ChunkTables:
        if cpb not in self._tables:
            self._tables[cpb] = chunk_tables(self.dofmap, self.ndofs, cpb)
        return self._tables[cpb]

    @functools.cached_property
    def covers(self) -> bool:
        """Whether the cells hold every dof (then a kernel that writes each
        dof its cells hold writes all of y)."""
        return bool(np.bincount(self.dofmap.reshape(-1),
                                minlength=self.ndofs).min() > 0)

    @functools.cached_property
    def classes(self) -> tuple[np.ndarray, tuple]:
        """The class-launch design's (cells, bounds) (`scatter_classes`)."""
        return scatter_classes(self.dofmap, self.ndofs)

    def class_cells(self, device) -> tuple[torch.Tensor, tuple]:
        """`classes` with the cell ids on `device`."""
        key = ("classes", torch.device(device))
        if key not in self._card:
            cells, bounds = self.classes
            self._card[key] = (torch.as_tensor(cells, device=device), bounds)
        return self._card[key]

    def card(self, P: int, dtype: torch.dtype, pair: bool, device,
             cpb: int | None = None, design: str = "first") -> tuple:
        """(schedule, chunk table, uniq, ends, pos, classes as a C array)
        of the chunk kernel `design` on `device` (its SMs, its occupancy
        answers): "first" (float32, float64 and the first bfloat16 form) or
        the bfloat16 "lean" kernel, which runs the first design's schedule
        (`lean_schedule`) and reads the tables' `lead_ends` for `ends`;
        `cpb` as `chunk_schedule` takes it."""
        device = torch.device(device)
        key = (P, dtype, pair, device, cpb, design)
        if key not in self._card:
            from fustpu_torch import _build

            lib = _build.load()
            sms = torch.cuda.get_device_properties(
                device).multi_processor_count
            t = lambda a: torch.as_tensor(a, device=device)
            if design == "lean":
                first = self.card(P, dtype, pair, device, cpb)
                occupancy = cs.occupancy_query(
                    lib, "fustpu_indexed_chunk_occupancy",
                    "fustpu_indexed_lean_occupancy", "lean",
                    "lean chunk kernel")
                with torch.cuda.device(device):
                    sched = lean_schedule(first[0], P, sms, pair, occupancy)
                tab = self.tables(sched.cpb)
                chunks, uniq, _, pos, classes = first[1:]
                self._card[key] = (sched, chunks, uniq, t(tab.lead_ends), pos,
                                   classes)
                return self._card[key]
            occupancy = cs.occupancy_query(
                lib, "fustpu_indexed_chunk_occupancy", "", "first",
                "chunk kernel")
            itemsize = torch.empty((), dtype=dtype).element_size()
            with torch.cuda.device(device):
                sched = chunk_schedule(self, P, itemsize, sms, pair,
                                       occupancy, cpb)
            tab = self.tables(sched.cpb)
            classes = sched.classes.reshape(-1)
            self._card[key] = (
                sched, t(sched.chunks), t(tab.uniq), t(tab.ends), t(tab.pos),
                (ctypes.c_longlong * classes.size)(*classes.tolist()))
        return self._card[key]


def card_schedule(op: "IndexedCellStiffness", x: torch.Tensor,
                  pair: bool) -> ChunkSchedule:
    """The schedule that an apply of `op` on x's card runs."""
    return op.plan.card(op.P, x.dtype, pair, x.device,
                        design=design(op.P, pair, x.dtype))[0]


def build(mesh, G_cells, D_1d: np.ndarray, dtype: torch.dtype,
          device, coeff=None, pair=None,
          plan: ChunkPlan | None = None) -> IndexedCellStiffness:
    """The operator in the kernel layout on `device`, from float64 data:
    G_cells (cells, n^3, 6) in mesh cell order (a host array, or a tensor
    of the set-up on the card); `coeff` (per-cell) is folded into G; `pair`
    = (c1, c2) per-cell fields makes a unit-G pair operator; `plan`: the
    mesh's `ChunkPlan`, if known."""
    cell_field = lambda c: np.broadcast_to(
        np.asarray(c, np.float64).reshape(-1), (mesh.num_cells,))
    G = cs.pack_G(G_cells, None if coeff is None else cell_field(coeff))
    C = None
    if pair is not None:
        C = np.stack([cell_field(c) for c in pair], axis=1)
    return from_host(mesh.dofmap, mesh.ndofs, G, D_1d, dtype, device, C,
                     plan)


def from_host(dofmap: np.ndarray, ndofs: int, G: np.ndarray,
              D_1d: np.ndarray, dtype: torch.dtype, device,
              C: np.ndarray | None = None,
              plan: ChunkPlan | None = None) -> IndexedCellStiffness:
    """Upload kernel-layout host arrays (G (cells, 6, n^3), a host array or
    a tensor, and C (cells, 2) in mesh cell order) and the dofmap, with
    the schedules' host part `plan` (made here unless given)."""
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return IndexedCellStiffness(
        G=cs.upload(G, dtype, device), D=t(D_1d),
        dofmap=torch.tensor(np.asarray(dofmap), dtype=torch.int32,
                            device=device),
        ndofs=int(ndofs), plan=plan or ChunkPlan(dofmap, ndofs),
        C=None if C is None else t(C))


# ---------------------------------------------------------------------------
# Plain versions: ``fustpu_torch.ops.indexed`` on the same operator data
# ---------------------------------------------------------------------------

class PlainIndexed(NamedTuple):
    """The indexed operator in the layout of ``fustpu_torch.ops.indexed``,
    on one device."""

    G: torch.Tensor                  # (6, cells, n^3)
    dofmap: torch.Tensor             # (cells, n^3) int64
    D: torch.Tensor                  # (n, n)
    c1: torch.Tensor | None          # (cells,) pair coefficients
    c2: torch.Tensor | None


def to_plain(op: IndexedCellStiffness) -> PlainIndexed:
    """The same numbers as `op` in the plain layout, on op's device."""
    c1 = c2 = None
    if op.C is not None:
        c1, c2 = op.C[:, 0].contiguous(), op.C[:, 1].contiguous()
    return PlainIndexed(G=op.G.permute(1, 0, 2).contiguous(),
                        dofmap=op.dofmap.long(), D=op.D, c1=c1, c2=c2)


def indexed_plain(op: IndexedCellStiffness, x: torch.Tensor) -> torch.Tensor:
    """Plain version of `indexed`."""
    p = to_plain(op)
    return idx.stiffness_apply_indexed(x, p.G, None, p.dofmap, p.D, op.ndofs)


def indexed_pair_plain(op: IndexedCellStiffness, x1: torch.Tensor,
                       x2: torch.Tensor) -> torch.Tensor:
    """Plain version of `indexed_pair`."""
    p = to_plain(op)
    return idx.stiffness_apply_indexed_pair(x1, p.c1, x2, p.c2, p.G,
                                            p.dofmap, p.D, op.ndofs)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

# the class-launch design's types (the main path's: cs.SUFFIX)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(op: IndexedCellStiffness, *xs: torch.Tensor, pair: bool,
           types: dict = cs.SUFFIX) -> None:
    x = xs[0]
    if x.device.type != "cuda":
        raise ValueError(f"indexed kernel: tensor on {x.device}, "
                         "expected a CUDA device")
    if x.dtype not in types:
        raise ValueError(f"indexed kernel: dtype {x.dtype} unsupported "
                         f"({', '.join(map(str, types))})")
    if not 2 <= op.P <= 10:
        raise ValueError(f"indexed kernel: degree {op.P} outside 2..10")
    if op.plan is None:
        raise ValueError("indexed kernel: the operator has no ChunkPlan "
                         "(a plain-version operator)")
    nnn = (op.P + 1) ** 3
    ncells = op.dofmap.shape[0]
    shapes = [(t, (op.ndofs,), x.dtype, "x") for t in xs] + [
        (op.G, (ncells, 6, nnn), x.dtype, "G"),
        (op.D, (op.P + 1, op.P + 1), x.dtype, "D"),
        (op.dofmap, (ncells, nnn), torch.int32, "dofmap")]
    if pair:
        if op.C is None:
            raise ValueError("indexed_pair needs pair coefficients C")
        shapes.append((op.C, (ncells, 2), x.dtype, "C"))
    for t, shape, dtype, name in shapes:
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"indexed kernel: {name} is {t.dtype} on "
                             f"{t.device}, expected {dtype} on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"indexed kernel: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"indexed kernel: {name} is not contiguous")
    if op.plan.dofmap.shape != (ncells, nnn) or op.plan.ndofs != op.ndofs:
        raise ValueError(f"indexed kernel: the plan's dofmap "
                         f"{op.plan.dofmap.shape} of {op.plan.ndofs} dofs "
                         f"is not the operator's")


def _launch_chunks(name: str, op: IndexedCellStiffness, xs, extra,
                   cpb: int | None = None,
                   design: str = "first") -> torch.Tensor:
    """One apply through the chunk kernel `design` ("first": float32,
    float64 and the first bfloat16 form; "lean": the bfloat16 lean chunk
    kernel), uncounted (`cpb`: cells a chunk other than the model's
    choice)."""
    from fustpu_torch import _build

    x = xs[0]
    if op.G.data_ptr() % 16:
        raise ValueError("indexed kernel: G's data is not 16 B-aligned "
                         "(the bulk copies need it)")
    sched, chunks, uniq, ends, pos, classes = op.plan.card(
        op.P, x.dtype, len(xs) == 2, x.device, cpb, design)
    # the lean kernel writes every dof the cells hold, and reads no y in a
    # dof's first class
    fresh = torch.empty if design == "lean" and op.plan.covers else \
        torch.zeros
    y = fresh(x.shape, dtype=x.dtype, device=x.device)
    form = f"{'_pair' if len(xs) == 2 else ''}"
    if design == "lean":
        fn = getattr(_build.load(), f"fustpu_indexed_lean{form}_bf16")
        D = cs.host_D(op.D)
    else:
        fn = getattr(_build.load(), f"fustpu_indexed_chunk{form}_"
                     f"{cs.SUFFIX[x.dtype]}")
        D = op.D.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(t.data_ptr() for t in xs), *extra, op.G.data_ptr(), D,
                 y.data_ptr(), op.P, chunks.data_ptr(), uniq.data_ptr(),
                 ends.data_ptr(), pos.data_ptr(), classes,
                 len(sched.classes), sched.blocks, sched.cpb,
                 sched.stage_bytes, sched.smem, sched.maxu, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {err}")
    return y


def _launch_classes(name: str, op: IndexedCellStiffness, xs, extra
                    ) -> torch.Tensor:
    """One apply through the class-launch kernel."""
    from fustpu_torch import _build

    x = xs[0]
    cells, bounds = op.plan.class_cells(x.device)
    y = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    fn = getattr(_build.load(), f"fustpu_indexed"
                 f"{'_pair' if len(xs) == 2 else ''}_{_SUFFIX[x.dtype]}")
    b = (ctypes.c_longlong * len(bounds))(*bounds)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(t.data_ptr() for t in xs), *extra, op.G.data_ptr(),
                 op.D.data_ptr(), op.dofmap.data_ptr(), cells.data_ptr(),
                 ctypes.addressof(b), len(bounds) - 1,
                 y.data_ptr(), op.P, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {err}")
    class_launches[name] += 1
    return y


def indexed(op: IndexedCellStiffness, x: torch.Tensor,
            cpb: int | None = None) -> torch.Tensor:
    """y = A_stiff(x) on flat fields through the single-field chunk kernel
    (the plain version for a CPU tensor); `cpb`: cells a chunk in place of
    the model's choice."""
    if x.device.type == "cpu":
        return indexed_plain(op, x)
    _check(op, x, pair=False)
    kind = design(op.P, False, x.dtype)
    y = _launch_chunks("indexed", op, (x,), (), cpb, kind)
    cs.count(launches, bf16_launches, "indexed", x.dtype, kind == "lean")
    return y


def indexed_pair(op: IndexedCellStiffness, x1: torch.Tensor,
                 x2: torch.Tensor, cpb: int | None = None) -> torch.Tensor:
    """y = A_c1(x1) + A_c2(x2) on flat fields through the pair chunk kernel
    (the plain version for CPU tensors); bfloat16 and `cpb` as for
    `indexed`."""
    if x1.device.type == "cpu":
        return indexed_pair_plain(op, x1, x2)
    _check(op, x1, x2, pair=True)
    kind = design(op.P, True, x1.dtype)
    y = _launch_chunks("indexed_pair", op, (x1, x2), (op.C.data_ptr(),),
                       cpb, kind)
    cs.count(launches, bf16_launches, "indexed_pair", x1.dtype,
             kind == "lean")
    return y


def indexed_first(op: IndexedCellStiffness, x: torch.Tensor,
                  cpb: int | None = None) -> torch.Tensor:
    """`indexed` of a bfloat16 operator through the first bfloat16 chunk
    kernel (`fustpu_indexed_chunk_bf16`) at every degree, the lean
    kernel's comparison; counted in `comparison_launches` (the plain
    version for a CPU tensor)."""
    if x.device.type == "cpu":
        return indexed_plain(op, x)
    _check(op, x, pair=False, types=cs.BF16_ONLY)
    y = _launch_chunks("indexed", op, (x,), (), cpb)
    comparison_launches["indexed_first_bf16"] += 1
    return y


def indexed_pair_first(op: IndexedCellStiffness, x1: torch.Tensor,
                       x2: torch.Tensor,
                       cpb: int | None = None) -> torch.Tensor:
    """`indexed_pair` through the first bfloat16 chunk kernel, as
    `indexed_first`."""
    if x1.device.type == "cpu":
        return indexed_pair_plain(op, x1, x2)
    _check(op, x1, x2, pair=True, types=cs.BF16_ONLY)
    y = _launch_chunks("indexed_pair", op, (x1, x2), (op.C.data_ptr(),),
                       cpb)
    comparison_launches["indexed_pair_first_bf16"] += 1
    return y


def indexed_classes(op: IndexedCellStiffness,
                    x: torch.Tensor) -> torch.Tensor:
    """`indexed` through the class-launch kernel (the plain version for a
    CPU tensor)."""
    if x.device.type == "cpu":
        return indexed_plain(op, x)
    _check(op, x, pair=False, types=_SUFFIX)
    return _launch_classes("indexed_classes", op, (x,), ())


def indexed_classes_pair(op: IndexedCellStiffness, x1: torch.Tensor,
                         x2: torch.Tensor) -> torch.Tensor:
    """`indexed_pair` through the class-launch kernel (the plain version
    for CPU tensors)."""
    if x1.device.type == "cpu":
        return indexed_pair_plain(op, x1, x2)
    _check(op, x1, x2, pair=True, types=_SUFFIX)
    return _launch_classes("indexed_classes_pair", op, (x1, x2),
                           (op.C.data_ptr(),))
