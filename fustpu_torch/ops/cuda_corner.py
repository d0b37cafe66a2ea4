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
(``corner_walk.cuh``); they count in `bf16_launches`
(``cuda_stiffness.count``).  The class-launch designs have float32 and
float64 only.

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

# Applies that went through each kernel (not counting the plain version):
# the walk's, and the class-launch design's.
launches = {"corner": 0, "corner_pair": 0, "extruded_corner": 0,
            "extruded_corner_pair": 0, "extruded_corner_hex27": 0,
            "extruded_corner_hex27_pair": 0}
class_launches = {name: 0 for name in (
    "corner_classes", "corner_classes_pair", "extruded_corner_classes",
    "extruded_corner_classes_pair", "extruded_corner_hex27_classes",
    "extruded_corner_hex27_classes_pair")}
# the walk's bfloat16 forms (``cuda_stiffness.count``)
bf16_launches = {f"{name}_bf16": 0 for name in launches}


def reset_launches() -> None:
    for counts in (launches, class_launches, bf16_launches):
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

def _card(op: CornerCellStiffness, dtype: torch.dtype, pair: bool, device,
          segments: int | None = None, cpb: int | None = None) -> tuple:
    """(schedule, chunk table, row ids or None, classes as a C array) of
    the walk of `op` on `device` (`cpb`, and on stacks `segments`: another
    schedule than the model's)."""
    if op.box:
        if segments is not None:
            raise ValueError("corner kernel: a box pencil has no segments")
        sched, chunks, classes = cs._card_schedule(
            tuple(op.nc), op.P, dtype, pair, torch.device(device), geo=1,
            cpb=cpb)
        return sched, chunks, None, classes
    return op.plan.card(op.P, dtype, pair, device, segments, cpb,
                        geo=op.geom_deg)


def card_schedule(op: CornerCellStiffness, x: torch.Tensor, pair: bool,
                  **schedule):
    """The schedule (`cs.PencilSchedule` on a box, `ce.StackSchedule` on
    stacks) that an apply of `op` on x's card runs (`schedule`: `cpb`, and
    on stacks `segments`, in place of the model's choice)."""
    return _card(op, x.dtype, pair, x.device, **schedule)[0]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(op: CornerCellStiffness, *xs: torch.Tensor, pair: bool,
           classes: bool = False) -> None:
    """Checks an apply's tensors: float32, float64 or (the walk only, not
    the class-launch design) bfloat16."""
    x = xs[0]
    if x.device.type != "cuda":
        raise ValueError(f"corner kernel: tensor on {x.device}, expected a "
                         "CUDA device")
    types = (torch.float32, torch.float64) if classes else tuple(cs.SUFFIX)
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


def _walk_entry(op: CornerCellStiffness, pair: bool, dtype) -> str:
    kind = "corner_pencil" if op.box else f"{op.kernel}_stack"
    return f"fustpu_{kind}{'_pair' if pair else ''}_{cs.SUFFIX[dtype]}"


def _launch(name: str, op: CornerCellStiffness, xs, extra,
            segments: int | None = None,
            cpb: int | None = None) -> torch.Tensor:
    """One apply through the walk (`cpb`, and on stacks `segments`: another
    schedule than the model's)."""
    from fustpu_torch import _build

    x = xs[0]
    if op.T.data_ptr() % 16:
        raise ValueError("corner kernel: T's data is not 16 B-aligned (the "
                         "bulk copies need it)")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"corner kernel: {x.numel()} grid nodes, the walk "
                         "indexes fewer than 2^31")
    pair = len(xs) == 2
    sched, chunks, ids, classes = _card(op, x.dtype, pair, x.device,
                                        segments, cpb)
    y = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    fn = getattr(_build.load(), _walk_entry(op, pair, x.dtype))
    args = (*(t.data_ptr() for t in xs), *extra, op.T.data_ptr(),
            op.D.data_ptr(), op.Q.data_ptr(), y.data_ptr(), op.P,
            chunks.data_ptr())
    sched_args = (classes, len(sched.classes), sched.blocks, sched.cpb,
                  sched.stages, sched.stage_bytes, sched.smem)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if op.box:
            err = fn(*args, *sched_args, op.nc[1], op.nc[2], stream)
        else:
            err = fn(*args, ids.data_ptr(), *sched_args, op.nz, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {err}")
    cs.count(launches, bf16_launches, name, x.dtype)
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


def _apply(op: CornerCellStiffness, x: torch.Tensor, classes: bool = False,
           **schedule) -> torch.Tensor:
    if x.device.type == "cpu":
        return corner_plain(op, x)
    _check(op, x, pair=False, classes=classes)
    if classes:
        return _launch_classes(op.kernel + "_classes", op, (x,), ())
    return _launch(op.kernel, op, (x,), (), **schedule)


def _apply_pair(op: CornerCellStiffness, x1: torch.Tensor,
                x2: torch.Tensor, classes: bool = False,
                **schedule) -> torch.Tensor:
    if x1.device.type == "cpu":
        return corner_pair_plain(op, x1, x2)
    _check(op, x1, x2, pair=True, classes=classes)
    if classes:
        return _launch_classes(op.kernel + "_classes_pair", op, (x1, x2),
                               (op.C.data_ptr(),))
    return _launch(op.kernel + "_pair", op, (x1, x2), (op.C.data_ptr(),),
                   **schedule)


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
    return _apply(op, x, cpb=cpb)


def corner_pair(op: CornerCellStiffness, x1: torch.Tensor,
                x2: torch.Tensor, cpb: int | None = None) -> torch.Tensor:
    """y_grid = A_c1(x1) + A_c2(x2) on a box through the pair walk of box
    pencils (the plain version for CPU tensors); `cpb` as for `corner`."""
    _box(op, "corner_pair")
    return _apply_pair(op, x1, x2, cpb=cpb)


def extruded_corner(op: CornerCellStiffness, x: torch.Tensor,
                    **schedule) -> torch.Tensor:
    """y = A_stiff(x) on flat fields through the stack walk of the
    operator's geometry degree (the plain version for a CPU tensor);
    `schedule`: `segments` and / or `cpb` in place of the model's
    choice."""
    _stacks(op, "extruded_corner")
    return _apply(op, x, **schedule)


def extruded_corner_pair(op: CornerCellStiffness, x1: torch.Tensor,
                         x2: torch.Tensor, **schedule) -> torch.Tensor:
    """y = A_c1(x1) + A_c2(x2) on flat fields through the pair stack walk
    (the plain version for CPU tensors)."""
    _stacks(op, "extruded_corner_pair")
    return _apply_pair(op, x1, x2, **schedule)


def corner_classes(op: CornerCellStiffness, x: torch.Tensor) -> torch.Tensor:
    """`corner` through the class-launch design (the plain version for a
    CPU tensor)."""
    _box(op, "corner_classes")
    return _apply(op, x, classes=True)


def corner_classes_pair(op: CornerCellStiffness, x1: torch.Tensor,
                        x2: torch.Tensor) -> torch.Tensor:
    """`corner_pair` through the class-launch design (the plain version for
    CPU tensors)."""
    _box(op, "corner_classes_pair")
    return _apply_pair(op, x1, x2, classes=True)


def extruded_corner_classes(op: CornerCellStiffness,
                            x: torch.Tensor) -> torch.Tensor:
    """`extruded_corner` through the class-launch design of the operator's
    geometry degree (the plain version for a CPU tensor)."""
    _stacks(op, "extruded_corner_classes")
    return _apply(op, x, classes=True)


def extruded_corner_classes_pair(op: CornerCellStiffness, x1: torch.Tensor,
                                 x2: torch.Tensor) -> torch.Tensor:
    """`extruded_corner_pair` through the class-launch design (the plain
    version for CPU tensors)."""
    _stacks(op, "extruded_corner_classes_pair")
    return _apply_pair(op, x1, x2, classes=True)
