"""Corner-streamed stiffness apply on the card (the capacity mode): the
hand-written CUDA kernels of ``fustpu_torch/csrc/corner_pencil.cu``,
``corner_stack.cu`` and ``corner_stack27.cu`` (the z-pencil kernel of
``stiffness_pencil.cuh`` with the corner geometry, ``corner_walk.cuh``),
the class-launch designs they replaced (``corner.cu``,
``extruded_corner.cu``, ``extruded_corner27.cu``), their wrappers, their
launch counters and the host build of the operator in the kernel layout.

Counterpart of the corner forms of the JAX package's fused kernels:

- `corner` / `corner_pair` replace ``pallas_stiffness._mk_kernel_corner``
  on a box mesh (one field with any per-cell coefficient in the last
  channel; the pair form, y = A_c1(x1) + A_c2(x2) with the coefficient
  channel 1, is the heterogeneous Westervelt stage, which the JAX package
  runs as two folded corner operators);
- `extruded_corner` / `extruded_corner_pair` replace
  ``pallas_extruded._mk_kernel`` with `corner` set on an imported prismatic
  mesh, at geometry degree 1 (hex8) or 2 (curved hex27; counted as
  ``extruded_corner_hex27`` and ``extruded_corner_hex27_pair``).

The operator (`CornerCellStiffness`) holds per-cell channels (37, or 163
for hex27: ``fustpu_torch.ops.corner``) instead of the (cells, 6, n^3)
metric, ~20x less geometry at P = 4 trilinear, and is built from the cell
corners or the hex27 lattice alone: nothing here computes the host metric.

The four wrappers above run the walk: the structured G-stream kernel's
walk of box pencils (``cuda_stiffness.pencil_schedule``) or of extruded
stacks (``cuda_extruded.stack_schedule``, the operator's `plan`), each
chunk's run of channels bulk-copied into a ring of shared stages, the
metric rebuilt from them at every node.  Each schedule is built once per
shape and card, from its SM count and the occupancy query.
`corner_classes` / `corner_classes_pair` and `extruded_corner_classes` /
`extruded_corner_classes_pair` (hex8 or hex27 by `geom_deg`) run the
class-launch design that the walk replaced, kept as the comparison: one
launch per parity or (stack colour, layer parity) class of scattered
cells, each cell's threads reading its channels themselves.

The walk also comes in bfloat16 (the JAX package's ``--dtype bf16``: the
capacity mode at half the bytes).  Its bf16 forms store x, x2, y, the
channels T, D and C in bfloat16 and compute in float32 (the GLL nodes and
weights Q are float32 tensors), rounding y where they store it
(``corner_walk.cuh``).  A bfloat16 apply runs the lean corner walk
(``csrc/corner_lean.cuh``: D, the GLL nodes and weights by value, padded
float rows, three barriers a chunk, and per form the channels widened
into float4 slots or not, D's rows in registers or not, launch bounds of
its own) at the (degree, form,
geometry) of `LEAN_CORNER_BF16`, on the first design's cells a chunk and
segments (`lean_smem`, its blocks an SM from its own occupancy query), and
the first bfloat16 corner walk elsewhere; that walk is also reached as
`corner_first`, `corner_pair_first`, `extruded_corner_first` and
`extruded_corner_pair_first`, the comparison, counted in
`comparison_launches`.  The main path's bf16 applies count in
`bf16_launches` (``cuda_stiffness.count``): `name`_bf16 on the lean walk,
`name`_bf16_first_walk on the first.  The class-launch designs have
float32 and float64 only.

A wrapper given CPU tensors runs the plain version (`corner_plain` /
`corner_pair_plain`: the channels expanded into the metric by
`corner.expand_G`, then the plain G-stream apply of
``fustpu_torch.ops.cuda_stiffness`` or ``cuda_extruded``; in bfloat16 the
channels widened to float32 and the metric expanded and kept in float32,
the apply in float32 and y rounded once).  Given CUDA tensors it launches
the kernel or raises: there is no fallback.  Each wrapper counts its
applies in `launches` (or `bf16_launches`), the class-launch designs' in
`class_launches` (one per apply).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from fustpu_torch.ops import corner as cn
from fustpu_torch.ops import cuda_extruded as ce
from fustpu_torch.ops import cuda_stiffness as cs

BF16 = torch.bfloat16

# Applies that went through each kernel (not counting the plain version):
# the walk's, and the class-launch design's.
launches = {"corner": 0, "corner_pair": 0, "extruded_corner": 0,
            "extruded_corner_pair": 0, "extruded_corner_hex27": 0,
            "extruded_corner_hex27_pair": 0}
class_launches = {name: 0 for name in (
    "corner_classes", "corner_classes_pair", "extruded_corner_classes",
    "extruded_corner_classes_pair", "extruded_corner_hex27_classes",
    "extruded_corner_hex27_classes_pair")}
# the walk's bfloat16 forms on the main path (``cuda_stiffness.count``:
# on the lean corner walk, and on the first bfloat16 corner walk outside
# LEAN_CORNER_BF16), and the first bfloat16 corner walk called as the lean
# walk's comparison
bf16_launches = {cs.bf16_key(name, lean): 0 for name in launches
                 for lean in (True, False)}
comparison_launches = {f"{name}_first_bf16": 0 for name in launches}


def reset_launches() -> None:
    for counts in (launches, class_launches, bf16_launches,
                   comparison_launches):
        for k in counts:
            counts[k] = 0


class CornerCellStiffness(NamedTuple):
    """Corner-streamed stiffness operator in the kernel layout, on one
    device: a box operator when `nc` is set, an extruded one otherwise."""

    T: torch.Tensor                  # (cells, nch + 1) channels, coefficient
                                     # last; box order cx*ncy*ncz + cy*ncz
                                     # + cz or stack order s*nz + kz
    D: torch.Tensor                  # (n, n) D[q, i] = l_i'(x_q)
    Q: torch.Tensor                  # (2, n) unit GLL nodes, then weights,
                                     # in the arithmetic type (float32 for
                                     # bfloat16 channels)
    geom_deg: int                    # 1 (hex8) or 2 (hex27, extruded only)
    nc: tuple | None = None          # box: cells per axis
    rows: torch.Tensor | None = None  # extruded: (ns, n^2) int32 row ids
    nz: int = 0                      # extruded: layers
    n2d: int = 0                     # extruded: 2D rows
    cells: torch.Tensor | None = None  # extruded: (cells,) int32 by class
    bounds: tuple = ()               # extruded: class boundaries (the
                                     # class-launch design's)
    C: torch.Tensor | None = None    # (cells, 2) pair coefficients
    plan: "ce.StackPlan | None" = None  # extruded: the stack walk's host
                                     # part (its schedules per card)

    @property
    def P(self) -> int:
        return self.D.shape[0] - 1

    @property
    def box(self) -> bool:
        return self.nc is not None

    @property
    def kernel(self) -> str:
        """The launch counter of the single-field kernel of this
        operator's float32 / float64 form (the class-launch design's: this
        and `_classes`; the bfloat16 form's: this and `_bf16`)."""
        if self.box:
            return "corner"
        return "extruded_corner" + ("_hex27" if self.geom_deg == 2 else "")

    @property
    def channels(self) -> int:
        return cs.corner_channels(self.geom_deg)

    @property
    def gz(self) -> int:
        return self.nz * self.P + 1

    @property
    def grid_shape(self) -> tuple:
        """The field's shape: the node grid of a box, flat otherwise."""
        if self.box:
            return tuple(c * self.P + 1 for c in self.nc)
        return (self.n2d * self.gz,)


def _tensors(T: np.ndarray, D_1d: np.ndarray, dtype: torch.dtype, device,
             C: np.ndarray | None):
    t = lambda a, dt=dtype: torch.as_tensor(np.ascontiguousarray(a),
                                            dtype=dt, device=device)
    n = D_1d.shape[0]
    return dict(T=t(T), D=t(D_1d),
                Q=t(cn.quadrature(n), cs.arith_dtype(dtype)),
                C=None if C is None else t(C))


def _pair_coeffs(pair, shape, order=None) -> np.ndarray:
    """(cells, 2) per-cell (c1, c2) of per-cell fields of `shape`, in
    `order` when given."""
    C = np.stack([np.broadcast_to(np.asarray(c, np.float64), shape
                                  ).reshape(-1) for c in pair], axis=1)
    return C if order is None else C[order]


def build_box(mesh, D_1d: np.ndarray, dtype: torch.dtype, device,
              coeff=None, pair=None) -> CornerCellStiffness:
    """The structured operator from the box mesh's cell corners: `coeff`
    (per-cell) goes into the coefficient channel; `pair` = (c1, c2)
    per-cell fields makes a unit-channel pair operator."""
    c = None if coeff is None else np.broadcast_to(
        np.asarray(coeff, np.float64), mesh.nc).reshape(-1)
    T = cn.jacobian_coefficients(mesh.cell_corners_flat, c)
    C = None if pair is None else _pair_coeffs(pair, mesh.nc)
    return from_host_box(mesh.nc, T, D_1d, dtype, device, C)


def from_host_box(nc, T: np.ndarray, D_1d: np.ndarray, dtype: torch.dtype,
                  device, C: np.ndarray | None = None) -> CornerCellStiffness:
    """Upload box-order host channels T (cells, 37) and C (cells, 2) of a
    box of `nc` cells per axis."""
    return CornerCellStiffness(**_tensors(T, D_1d, dtype, device, C),
                               geom_deg=1, nc=tuple(nc))


def build_extruded(mesh, D_1d: np.ndarray, dtype: torch.dtype, device,
                   coeff=None, pair=None) -> CornerCellStiffness:
    """The extruded operator from `corner.corner_stream` (hex8 corners or
    the hex27 lattice), in stack order, with the mesh's rows and scatter
    classes: `coeff` and `pair` as for `build_box`."""
    c = None if coeff is None else np.broadcast_to(
        np.asarray(coeff, np.float64), (mesh.num_cells,))
    T = cn.corner_stream(mesh, c)
    T = T.reshape(-1, T.shape[2])
    C = None if pair is None else _pair_coeffs(
        pair, (mesh.num_cells,), mesh.stack_cells.reshape(-1))
    return from_host_extruded(mesh, T, D_1d, dtype, device, C)


def from_host_extruded(mesh, T: np.ndarray, D_1d: np.ndarray,
                       dtype: torch.dtype, device,
                       C: np.ndarray | None = None) -> CornerCellStiffness:
    """Upload stack-order host channels T (cells, nch + 1) and C
    (cells, 2) with the mesh's rows, the stack walk's plan and the
    class-launch design's scatter classes (both from one colouring of the
    stacks)."""
    plan = ce.StackPlan(mesh.rows2d, mesh.nz)
    cells, bounds = plan.classes
    return CornerCellStiffness(
        **_tensors(T, D_1d, dtype, device, C),
        geom_deg=cn.geom_degree(mesh),
        rows=torch.as_tensor(np.ascontiguousarray(mesh.rows2d, np.int32),
                             device=device),
        nz=mesh.nz, n2d=mesh.n2d,
        cells=torch.as_tensor(cells, device=device), bounds=bounds,
        plan=plan)


# ---------------------------------------------------------------------------
# Plain versions: the channels expanded into the metric, then the plain
# G-stream apply on the same data
# ---------------------------------------------------------------------------

def to_g_stream(op: CornerCellStiffness):
    """The G-stream operator (`cs.CellStiffness` or
    `ce.ExtrudedCellStiffness`) holding the metric that `op`'s channels
    give, on op's device: the plain version's operator data.  The metric
    is expanded in the walk's arithmetic type (`cs.arith_dtype`): bfloat16
    channels are widened to float32 (exactly) and G stays float32, as the
    kernel's metric never rounds to bfloat16; D and C stay as they are
    (the plain apply widens them, ``spectral_mm.rounds_once``)."""
    n = op.P + 1
    G = cn.expand_G(op.T.to(cs.arith_dtype(op.T.dtype)), n, op.geom_deg,
                    op.box)
    if op.box:
        return cs.CellStiffness(G=G, D=op.D, nc=op.nc, C=op.C)
    return ce.ExtrudedCellStiffness(G=G, D=op.D, rows=op.rows, nz=op.nz,
                                    n2d=op.n2d, plan=None, C=op.C)


def corner_plain(op: CornerCellStiffness, x: torch.Tensor) -> torch.Tensor:
    """Plain version of `corner` and `extruded_corner`."""
    g = to_g_stream(op)
    return cs.stiffness_plain(g, x) if op.box else ce.extruded_plain(g, x)


def corner_pair_plain(op: CornerCellStiffness, x1: torch.Tensor,
                      x2: torch.Tensor) -> torch.Tensor:
    """Plain version of `corner_pair` and `extruded_corner_pair`."""
    g = to_g_stream(op)
    if op.box:
        return cs.stiffness_pair_plain(g, x1, x2)
    return ce.extruded_pair_plain(g, x1, x2)


def apply_cost(op: CornerCellStiffness, ndofs: int, fields: int,
               extra: int = 0) -> tuple[int, int]:
    """(least bytes, operations) of one apply of `op`: the channels, each
    input field and the pair coefficients read once, y written once,
    plus `extra` bytes (row ids); per node the sum factorisation
    (2 x 3 derivative sums of n products each way and the add, 3 more to
    combine a pair) and the metric rebuilt in registers (J by Horner in x,
    the adjugate, det, |det| and the scale, t = a^T w and f = scale a t:
    80 operations for hex8, 98 for hex27, an FMA counted as 2); per line
    of a cell, the fold of every Jacobian channel with its line's power
    y^my z^mz (one FMA, the powers kept for the line as the walk keeps
    them; the class-launch design rebuilds them, 3 operations a channel,
    which this least count leaves out) and the scaled weight (2)."""
    cells, nch1 = op.T.shape
    n = op.D.shape[0]
    b = op.T.element_size()
    nbytes = op.T.numel() * b + (fields + 1) * ndofs * b + extra
    if fields == 2:
        nbytes += cells * 2 * b
    metric = 98 if op.geom_deg == 2 else 80
    per_node = 12 * n + 1 + metric + (3 if fields == 2 else 0)
    per_line = 2 * (nch1 - 1) + 2
    return nbytes, cells * (n ** 3 * per_node + n ** 2 * per_line)


# ---------------------------------------------------------------------------
# The walk's schedules
# ---------------------------------------------------------------------------

GEOMETRIES = ("box", "hex8", "hex27")

# The (degree P, pair?, geometry) at which a bfloat16 apply runs the lean
# corner walk: where it measured at least 3% faster than the first
# bfloat16 corner walk in turns on an H100, more than the largest spread
# between two turns of one design there (2.9%), and then won every turn of
# three rounds on the flagship's grid (PERF.md, PR 22; at P = 4 also on the
# imported bowl): ``tools/corner_split`` at P = 4, ``demos/exp_pencil
# --corner --bf16 --degrees`` and ``demos/exp_imported --corner --bf16
# --hex27 --degrees`` at each degree.  The others keep the first design:
# the hex8 single form everywhere (its best gain 2.7%), #3 single but at
# P = 7 (at P = 4 1.2%), the hex27 pair at P = 4 (2.6% faster on the
# imported bowl, 6.3% slower on the flagship's grid), P = 9 and 10
# (untimed).  ``csrc/corner_lean.cu``, ``corner_lean_stack.cu`` and
# ``corner_lean_stack27.cu`` instantiate the lean walk at these only.
LEAN_CORNER_BF16 = frozenset(
    [(7, False, "box")]
    + [(P, True, "box") for P in (3, 4, 6, 7, 8)]
    + [(P, True, "hex8") for P in (4, 7)]
    + [(P, False, "hex27") for P in (4, 6, 7)]
    + [(P, True, "hex27") for P in (5, 7, 8)])


def geometry(op: CornerCellStiffness) -> str:
    """"box" (box pencils), "hex8" or "hex27" (extruded stacks)."""
    if op.box:
        return "box"
    return "hex27" if op.geom_deg == 2 else "hex8"


def lean_runs(op: CornerCellStiffness, pair: bool,
              dtype: torch.dtype) -> bool:
    """Whether an apply of `op` (pair or not) in `dtype` runs the lean
    corner walk: bfloat16, at the (P, pair, geometry) of
    `LEAN_CORNER_BF16`."""
    return dtype == BF16 and (op.P, pair, geometry(op)) in LEAN_CORNER_BF16


def slot_floats(geom_deg: int) -> int:
    """Floats of a cell's widened channels in the lean corner walk
    (``corner_lean.cuh`` Slots): nine blocks of the channels of one J[p][q]
    (4 trilinear, 18 triquadratic), each padded to a multiple of 4, then
    the coefficient, the whole padded to a multiple of 4."""
    block = (cs.corner_channels(geom_deg) - 1) // 9
    return -(-(9 * (-(-block // 4) * 4) + 1) // 4) * 4


def lean_smem(P: int, cpb: int, pair: bool = False, ids: bool = False,
              geom_deg: int = 1,
              stages: int = cs.STAGES) -> tuple[int, int]:
    """(bytes a stage, dynamic shared bytes a block) of the lean corner
    walk (``corner_lean.cuh``): the head of ``cuda_stiffness.pencil_smem``
    (mbarriers, the row ring, with `ids` the stacks' row ids), the stages
    (cpb cells of bfloat16 channels and 16 B, the first design's stages),
    then float32: two buffers of every cell's u and every cell's f1 and
    f2, each n^2 rows padded to a multiple of 4 values, every cell's
    widened channels (`slot_floats`), two of the chunk's y (n^2 (cpb P + 1)
    values), for the pair two of x2 and of the cells' (c1, c2), and D (n^2
    values, padded to 4).  No static shared memory."""
    n = P + 1
    cellf = n * n * (-(-n // 4) * 4)
    stage = cs._round16(cpb * cs.corner_channels(geom_deg) * 2 + 16)
    rows = n * n * (cpb * P + 1)
    values = (4 * cpb * cellf + cpb * slot_floats(geom_deg) + 2 * rows
              + (2 * rows + 4 * cpb if pair else 0) + -(-n * n // 4) * 4)
    head = cs._round16(8 * stages) + cs._round16(8 * cs.ROW_RING
                                                 * cs.TABLE_ROW)
    if ids:
        head += cs._round16(4 * cs.ROW_RING * n * n)
    return stage, head + stages * stage + 4 * values


def _first_card(op: CornerCellStiffness, dtype: torch.dtype, pair: bool,
                device, segments: int | None = None,
                cpb: int | None = None) -> tuple:
    """(schedule, chunk table, row ids or None, classes as a C array) of
    the first design's walk of `op` on `device` (`cpb`, and on stacks
    `segments`: another schedule than the model's)."""
    if op.box:
        if segments is not None:
            raise ValueError("corner kernel: a box pencil has no segments")
        sched, chunks, classes = cs._card_schedule(
            tuple(op.nc), op.P, dtype, pair, torch.device(device), geo=1,
            cpb=cpb)
        return sched, chunks, None, classes
    return op.plan.card(op.P, dtype, pair, device, segments, cpb,
                        geo=op.geom_deg)


def lean_schedule(sched, P: int, pair: bool, ids: bool, geom_deg: int,
                  occupancy, sms: int):
    """The lean corner walk's schedule on the first design's `sched` (a
    `cs.PencilSchedule`, or with `ids` a `ce.StackSchedule`): its cells a
    chunk, segments, classes and chunk table (a node shared by several
    chunks or segments rounds once per writer, so another schedule would
    round others), with the lean walk's shared layout (`lean_smem`), blocks
    an SM (`occupancy(P, pair, cpb, smem)`, the card's answer for the lean
    walk's block) and grid on a card of `sms` SMs; raises where the first
    design's block does not fit the lean walk."""
    stage, smem = lean_smem(P, sched.cpb, pair, ids, geom_deg, sched.stages)
    if stage != sched.stage_bytes:
        raise ValueError(f"lean corner walk: a stage of {stage} B against "
                         f"the first design's {sched.stage_bytes}")
    bps = int(occupancy(P, pair, sched.cpb, smem)) \
        if smem <= cs.SMEM_BLOCK else 0
    if bps < 0:
        raise RuntimeError(f"lean corner walk occupancy query failed: "
                           f"error {-bps}")
    if bps == 0:
        raise ValueError(f"lean corner walk: a block of {sched.cpb} cells "
                         f"and {smem:,} B at P={P} does not fit an SM")
    return sched._replace(smem=smem, blocks_per_sm=bps, blocks=bps * sms)


def _card(op: CornerCellStiffness, dtype: torch.dtype, pair: bool, device,
          segments: int | None = None, cpb: int | None = None,
          design: str = "first") -> tuple:
    """(schedule, chunk table, row ids or None, classes as a C array) of
    the walk `design` of `op` on `device`: "first", or the bfloat16 "lean"
    corner walk on the first design's schedule (`lean_schedule`, the
    card's occupancy answers)."""
    first = _first_card(op, dtype, pair, device, segments, cpb)
    if design != "lean":
        return first
    sched, *rest = first
    kept = _LEAN.get(id(sched))
    if kept is None or kept[0] is not sched:    # once a first schedule
        from fustpu_torch import _build

        device = torch.device(device)
        kind = "corner_pencil" if op.box else f"{op.kernel}_stack"
        query = getattr(_build.load(), f"fustpu_{kind}_lean_occupancy")

        def occupancy(P, pair_, cpb_, smem):
            with torch.cuda.device(device):
                return query(P, int(pair_), cpb_, smem)

        sms = torch.cuda.get_device_properties(device).multi_processor_count
        kept = _LEAN[id(sched)] = (sched, lean_schedule(
            sched, op.P, pair, not op.box, op.geom_deg, occupancy, sms))
    return (kept[1], *rest)


# the lean schedules, by the first design's schedule they were built on
_LEAN: dict = {}


def card_schedule(op: CornerCellStiffness, x: torch.Tensor, pair: bool,
                  design: str | None = None, **schedule):
    """The schedule (`cs.PencilSchedule` on a box, `ce.StackSchedule` on
    stacks) that an apply of `op` on x's card runs (`design`: "first" or
    "lean" in place of the main path's; `schedule`: `cpb`, and on stacks
    `segments`, in place of the model's choice)."""
    design = design or ("lean" if lean_runs(op, pair, x.dtype) else "first")
    return _card(op, x.dtype, pair, x.device, design=design, **schedule)[0]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

# the types of the first bfloat16 corner walk's comparison entry points
BF16_ONLY = (BF16,)


def _check(op: CornerCellStiffness, *xs: torch.Tensor, pair: bool,
           classes: bool = False, types: tuple | None = None) -> None:
    """Checks an apply's tensors: float32, float64 or (the walk only, not
    the class-launch design) bfloat16; `types` in place of those."""
    x = xs[0]
    if x.device.type != "cuda":
        raise ValueError(f"corner kernel: tensor on {x.device}, expected a "
                         "CUDA device")
    if types is None:
        types = (torch.float32, torch.float64) if classes else tuple(
            cs.SUFFIX)
    if x.dtype not in types:
        raise ValueError(f"corner kernel: dtype {x.dtype} unsupported "
                         f"({', '.join(map(str, types))})")
    if not 2 <= op.P <= 10:
        raise ValueError(f"corner kernel: degree {op.P} outside 2..10")
    if op.geom_deg not in ((1,) if op.box else (1, 2)):
        raise ValueError(f"corner kernel: geometry degree {op.geom_deg}")
    n = op.P + 1
    nch = op.channels
    if op.box:
        ncells = op.nc[0] * op.nc[1] * op.nc[2]
    else:
        ncells = op.rows.shape[0] * op.nz
    shapes = [(t, op.grid_shape, x.dtype, "x") for t in xs] + [
        (op.T, (ncells, nch), x.dtype, "T"), (op.D, (n, n), x.dtype, "D"),
        (op.Q, (2, n), cs.arith_dtype(x.dtype), "Q")]
    if not op.box:
        shapes += [(op.rows, (op.rows.shape[0], n * n), torch.int32, "rows"),
                   (op.cells, (ncells,), torch.int32, "cells")]
        if op.bounds[-1] != ncells:
            raise ValueError(f"corner kernel: the scatter classes cover "
                             f"{op.bounds[-1]} of {ncells} cells")
        if op.plan is None or op.plan.colour.size != op.rows.shape[0] or \
                op.plan.nz != op.nz:
            raise ValueError("corner kernel: the operator's StackPlan does "
                             "not cover its stacks")
    if pair:
        if op.C is None:
            raise ValueError("the corner pair kernel needs pair "
                             "coefficients C")
        shapes.append((op.C, (ncells, 2), x.dtype, "C"))
    for t, shape, dtype, name in shapes:
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"corner kernel: {name} is {t.dtype} on "
                             f"{t.device}, expected {dtype} on {x.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"corner kernel: {name} has shape "
                             f"{tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"corner kernel: {name} is not contiguous")
    if op.T.data_ptr() % 16:
        raise ValueError("corner kernel: T's data is not 16 B-aligned (the "
                         "bulk copies need it)")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"corner kernel: {x.numel()} grid nodes, the walk "
                         "indexes fewer than 2^31")


def _walk_entry(op: CornerCellStiffness, pair: bool, dtype,
                design: str = "first") -> str:
    kind = "corner_pencil" if op.box else f"{op.kernel}_stack"
    suffix = "lean_bf16" if design == "lean" else cs.SUFFIX[dtype]
    return f"fustpu_{kind}{'_pair' if pair else ''}_{suffix}"


def _launch(op: CornerCellStiffness, xs, extra,
            segments: int | None = None, cpb: int | None = None,
            design: str = "first", types: tuple | None = None
            ) -> torch.Tensor:
    """One apply through the walk `design` ("first": float32, float64 and
    the first bfloat16 corner walk, or only `types`; "lean": the bfloat16
    lean corner walk, D and the GLL nodes and weights by value), its
    tensors checked before anything is built or launched; `cpb`, and on
    stacks `segments`: another schedule than the model's.  Counted by the
    caller."""
    from fustpu_torch import _build

    x = xs[0]
    pair = len(xs) == 2
    _check(op, *xs, pair=pair, types=BF16_ONLY if design == "lean" else types)
    sched, chunks, ids, classes = _card(op, x.dtype, pair, x.device,
                                        segments, cpb, design)
    y = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    fn = getattr(_build.load(), _walk_entry(op, pair, x.dtype, design))
    consts = ((cs.host_D(op.D), cs.host_D(op.Q)) if design == "lean" else
              (op.D.data_ptr(), op.Q.data_ptr()))
    args = (*(t.data_ptr() for t in xs), *extra, op.T.data_ptr(), *consts,
            y.data_ptr(), op.P, chunks.data_ptr())
    sched_args = (classes, len(sched.classes), sched.blocks, sched.cpb,
                  sched.stages, sched.stage_bytes, sched.smem)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if op.box:
            err = fn(*args, *sched_args, op.nc[1], op.nc[2], stream)
        else:
            err = fn(*args, ids.data_ptr(), *sched_args, op.nz, stream)
    if err != 0:
        raise RuntimeError(f"{op.kernel}{'_pair' if pair else ''} "
                           f"{design} kernel launch failed: error {err}")
    return y


def _launch_classes(name: str, op: CornerCellStiffness, xs,
                    extra) -> torch.Tensor:
    """One apply through the class-launch design."""
    from fustpu_torch import _build

    x = xs[0]
    y = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    kernel = op.kernel + ("_pair" if len(xs) == 2 else "")
    fn = getattr(_build.load(), f"fustpu_{kernel}_{cs.SUFFIX[x.dtype]}")
    ptrs = (*(t.data_ptr() for t in xs), *extra, op.T.data_ptr(),
            op.D.data_ptr(), op.Q.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if op.box:
            err = fn(*ptrs, y.data_ptr(), op.P, *op.nc, stream)
        else:
            bounds = (ctypes.c_longlong * len(op.bounds))(*op.bounds)
            err = fn(*ptrs, op.rows.data_ptr(), op.cells.data_ptr(),
                     ctypes.addressof(bounds), len(op.bounds) - 1,
                     y.data_ptr(), op.P, op.nz, op.gz, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {err}")
    class_launches[name] += 1
    return y


def _apply(op: CornerCellStiffness, xs, classes: bool = False,
           first: bool = False, **schedule) -> torch.Tensor:
    """One apply of `op` on the field(s) `xs` (two: the pair form): the
    plain version on CPU tensors; on the card the class-launch design
    (`classes`), the first bfloat16 corner walk as the comparison (`first`,
    bfloat16 only), or the main path's walk (`lean_runs`)."""
    pair = len(xs) == 2
    if xs[0].device.type == "cpu":
        return (corner_pair_plain if pair else corner_plain)(op, *xs)
    name = op.kernel + ("_pair" if pair else "")
    if classes:
        _check(op, *xs, pair=pair, classes=True)
        return _launch_classes(op.kernel + "_classes"
                               + ("_pair" if pair else ""), op, xs,
                               (op.C.data_ptr(),) if pair else ())
    extra = (op.C.data_ptr(),) if pair and op.C is not None else ()
    if first:
        y = _launch(op, xs, extra, types=BF16_ONLY, **schedule)
        comparison_launches[f"{name}_first_bf16"] += 1
        return y
    lean = lean_runs(op, pair, xs[0].dtype)
    y = _launch(op, xs, extra, design="lean" if lean else "first",
                **schedule)
    cs.count(launches, bf16_launches, name, xs[0].dtype, lean)
    return y


def _box(op: CornerCellStiffness, name: str) -> None:
    if not op.box:
        raise ValueError(f"{name}: an extruded operator (use extruded_"
                         f"{name})")


def _stacks(op: CornerCellStiffness, name: str) -> None:
    if op.box:
        raise ValueError(f"{name}: a box operator (use "
                         f"{name.removeprefix('extruded_')})")


def corner(op: CornerCellStiffness, x: torch.Tensor,
           cpb: int | None = None) -> torch.Tensor:
    """y_grid = A_stiff(x_grid) on a box through the walk of box pencils
    (the plain version for a CPU tensor); `cpb`: cells a chunk in place of
    the schedule's choice."""
    _box(op, "corner")
    return _apply(op, (x,), cpb=cpb)


def corner_pair(op: CornerCellStiffness, x1: torch.Tensor,
                x2: torch.Tensor, cpb: int | None = None) -> torch.Tensor:
    """y_grid = A_c1(x1) + A_c2(x2) on a box through the pair walk of box
    pencils (the plain version for CPU tensors); `cpb` as for `corner`."""
    _box(op, "corner_pair")
    return _apply(op, (x1, x2), cpb=cpb)


def extruded_corner(op: CornerCellStiffness, x: torch.Tensor,
                    **schedule) -> torch.Tensor:
    """y = A_stiff(x) on flat fields through the stack walk of the
    operator's geometry degree (the plain version for a CPU tensor);
    `schedule`: `segments` and / or `cpb` in place of the model's
    choice."""
    _stacks(op, "extruded_corner")
    return _apply(op, (x,), **schedule)


def extruded_corner_pair(op: CornerCellStiffness, x1: torch.Tensor,
                         x2: torch.Tensor, **schedule) -> torch.Tensor:
    """y = A_c1(x1) + A_c2(x2) on flat fields through the pair stack walk
    (the plain version for CPU tensors)."""
    _stacks(op, "extruded_corner_pair")
    return _apply(op, (x1, x2), **schedule)


def corner_classes(op: CornerCellStiffness, x: torch.Tensor) -> torch.Tensor:
    """`corner` through the class-launch design (the plain version for a
    CPU tensor)."""
    _box(op, "corner_classes")
    return _apply(op, (x,), classes=True)


def corner_classes_pair(op: CornerCellStiffness, x1: torch.Tensor,
                        x2: torch.Tensor) -> torch.Tensor:
    """`corner_pair` through the class-launch design (the plain version for
    CPU tensors)."""
    _box(op, "corner_classes_pair")
    return _apply(op, (x1, x2), classes=True)


def extruded_corner_classes(op: CornerCellStiffness,
                            x: torch.Tensor) -> torch.Tensor:
    """`extruded_corner` through the class-launch design of the operator's
    geometry degree (the plain version for a CPU tensor)."""
    _stacks(op, "extruded_corner_classes")
    return _apply(op, (x,), classes=True)


def extruded_corner_classes_pair(op: CornerCellStiffness, x1: torch.Tensor,
                                 x2: torch.Tensor) -> torch.Tensor:
    """`extruded_corner_pair` through the class-launch design (the plain
    version for CPU tensors)."""
    _stacks(op, "extruded_corner_classes_pair")
    return _apply(op, (x1, x2), classes=True)


def corner_first(op: CornerCellStiffness, x: torch.Tensor,
                 cpb: int | None = None) -> torch.Tensor:
    """`corner` of a bfloat16 operator through the first bfloat16 corner
    walk at every degree, on its own schedule unless `cpb` gives another,
    the lean corner walk's comparison; counted in `comparison_launches`
    (the plain version for a CPU tensor)."""
    _box(op, "corner_first")
    return _apply(op, (x,), first=True, cpb=cpb)


def corner_pair_first(op: CornerCellStiffness, x1: torch.Tensor,
                      x2: torch.Tensor,
                      cpb: int | None = None) -> torch.Tensor:
    """`corner_pair` through the first bfloat16 corner walk, as
    `corner_first`."""
    _box(op, "corner_pair_first")
    return _apply(op, (x1, x2), first=True, cpb=cpb)


def extruded_corner_first(op: CornerCellStiffness, x: torch.Tensor,
                          **schedule) -> torch.Tensor:
    """`extruded_corner` (hex8 or hex27) through the first bfloat16 corner
    walk, as `corner_first`; `schedule`: `segments` and / or `cpb`."""
    _stacks(op, "extruded_corner_first")
    return _apply(op, (x,), first=True, **schedule)


def extruded_corner_pair_first(op: CornerCellStiffness, x1: torch.Tensor,
                               x2: torch.Tensor,
                               **schedule) -> torch.Tensor:
    """`extruded_corner_pair` through the first bfloat16 corner walk, as
    `extruded_corner_first`."""
    _stacks(op, "extruded_corner_pair_first")
    return _apply(op, (x1, x2), first=True, **schedule)
