"""The staged gather / contract / scatter engine on the card: the four
hand-written CUDA kernels of ``fustpu_torch/csrc/engine.cu`` (the bfloat16
contraction and scatter: ``fustpu_torch/csrc/engine_bf16.cu``), their
wrappers, their launch counters and the host build of the operator.

Counterpart of the 3-kernel engine of ``fustpu/ops/pallas_gather.py``
(`gather`, `gather2`, `dense_contract`, `scatter_add`) as
``fustpu/ops/operators.py`` composes it (`stiffness_apply_indexed` and
`_pair` with ``engine=``):

- `gather` / `gather2`: one or two fields to the (cells, n^3) element
  stream;
- `contract`: the per-cell stiffness contraction, with unit coefficients,
  a per-cell coefficient (the linear model) or the pair fold
  c1 u1 + c2 u2 of two gathered fields (heterogeneous Westervelt);
- `scatter`: the deterministic scatter-add through the inverse map;
- `engine` / `engine_pair`: the three composed, one apply (three
  launches).

`EngineCellStiffness` keeps G in the indexed kernel's (cells, 6, n^3)
layout, so `to_indexed` drives ``fustpu_torch.ops.cuda_indexed`` on the
same buffers.  A wrapper given CPU tensors runs the plain version
(``fustpu_torch.ops.engine`` on the same data).  Given CUDA tensors it
launches the kernel or raises: there is no fallback.  Each kernel wrapper
counts its launches in `launches`, where it launches; the kernels launch
through the lean path of ``fustpu_torch.ops.launch``.  `gather_flat` runs
the single-field gather's first design (one thread a position), kept as
the comparison and counted apart in `comparison_launches`, as are
`gather2_flat`, the two-field gather's first design (one thread a
position), and `contract_cells` and `scatter_dofs`, the first bfloat16
designs of the contraction (one block a few cells, the cell body's own
global loads) and the scatter (one thread a dof).

Each kernel comes in float32, float64 and bfloat16.  The bfloat16 forms
(the JAX package's ``--dtype bf16``, counted in `bf16_launches`) take an
operator whose G, D, coeff and C are bfloat16 (`build` / `from_host` of
``torch.bfloat16``) and bfloat16 fields, and store:

- `gather` / `gather2`: u2 in bfloat16, a copy of the field's values
  (exact), four positions a thread; the dofmap and the outputs 16
  B-aligned;
- `contract`: y2 in bfloat16, each value rounded once from float32
  arithmetic on the widened u2, G, D, coeff and C (the pair fold
  c1 u1 + c2 u2 too): chunks of cells bulk-copied into a ring of shared
  stages on a persistent grid, D by value from a host copy (`host_D`);
  u1, u2, G and y2 16 B-aligned;
- `scatter`: y in bfloat16, each dof's float32 sum of its positions'
  y2 in ascending order rounded once: runs of dofs with their segment of
  the inverse map in tiles; pos 16 B-aligned, y 4 B-aligned.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from fustpu_torch.ops import cuda_indexed as ci
from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.ops import engine as eng
from fustpu_torch.ops import launch

# Launches of each kernel, not counting the plain version, and of its
# bfloat16 form (``cuda_stiffness.count``).
launches = {"engine_gather": 0, "engine_gather2": 0, "engine_contract": 0,
            "engine_scatter": 0}
bf16_launches = {f"{k}_bf16": 0 for k in launches}
comparison_launches = {"engine_gather_flat": 0,
                       "engine_gather2_flat": 0,
                       "engine_gather2_flat_bf16": 0,
                       "engine_contract_cells_bf16": 0,
                       "engine_scatter_dofs_bf16": 0}

_MODES = {"plain": 0, "coeff": 1, "pair": 2}
# The dtypes whose two-field gather keeps its first design on the main path
# (one thread a position, `engine_gather<T, 2>`): in float64 the quads
# design ran slower on an H100 (0.2264 against 0.1389 ms at the bodyfit
# bowl's size, `demos/exp_gather2`; PERF.md's #8 row), in float32 and
# bfloat16 faster.
GATHER2_FIRST_DESIGN = (torch.float64,)


def reset_launches() -> None:
    for counts in (launches, bf16_launches, comparison_launches):
        for k in counts:
            counts[k] = 0


def kernels(dtype: torch.dtype, pair: bool) -> tuple[str, ...]:
    """The launch counters that one composed apply in `dtype` moves: the
    gather (gather2 for a pair), the contraction and the scatter."""
    names = ("engine_gather2" if pair else "engine_gather",
             "engine_contract", "engine_scatter")
    if dtype == torch.bfloat16:
        return tuple(f"{k}_bf16" for k in names)
    return names


class EngineCellStiffness(NamedTuple):
    """The engine operator in the kernel layout, on one device."""

    G: torch.Tensor                  # (cells, 6, n^3), unit coefficients
    D: torch.Tensor                  # (n, n) D[q, i] = l_i'(x_q)
    dofmap: torch.Tensor             # (cells, n^3) int32: g = dofmap.ravel()
    ndofs: int
    pos: torch.Tensor                # (cells n^3,) int32 positions by dof
    ptr: torch.Tensor                # (ndofs + 1,) int32 offsets into pos
    coeff: torch.Tensor | None = None  # (cells,) per-cell coefficient
    C: torch.Tensor | None = None    # (cells, 2) pair coefficients

    @property
    def P(self) -> int:
        return self.D.shape[0] - 1

    @property
    def mode(self) -> str:
        if self.C is not None:
            return "pair"
        return "plain" if self.coeff is None else "coeff"


def inverse_map(dofmap: np.ndarray, ndofs: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """(pos, ptr): for each dof d, the positions p with g[p] == d in
    ascending order, pos[ptr[d]:ptr[d + 1]] (int32 CSR), g =
    dofmap.ravel()."""
    g = np.asarray(dofmap).reshape(-1)
    if g.size >= 2 ** 31:
        raise ValueError(f"{g.size} positions: the engine's int32 inverse "
                         "map holds fewer than 2^31")
    pos = np.argsort(g, kind="stable").astype(np.int32)
    ptr = np.zeros(ndofs + 1, np.int64)
    np.cumsum(np.bincount(g, minlength=ndofs), out=ptr[1:])
    return pos, ptr.astype(np.int32)


def build(mesh, G_cells, D_1d: np.ndarray, dtype: torch.dtype,
          device, coeff=None, pair=None) -> EngineCellStiffness:
    """The operator on `device` from float64 data: G_cells (cells, n^3, 6)
    in mesh cell order (a host array, or a tensor of the set-up on the
    card); `coeff` (per-cell) stays a separate per-cell coefficient;
    `pair` = (c1, c2) per-cell fields makes a pair operator."""
    cell_field = lambda c: np.broadcast_to(np.asarray(c, np.float64),
                                           (mesh.num_cells,))
    C = None
    if pair is not None:
        C = np.stack([cell_field(c) for c in pair], axis=1)
    return from_host(mesh.dofmap, mesh.ndofs, cs.pack_G(G_cells), D_1d,
                     dtype, device,
                     coeff=None if coeff is None else cell_field(coeff), C=C)


def from_host(dofmap: np.ndarray, ndofs: int, G: np.ndarray,
              D_1d: np.ndarray, dtype: torch.dtype, device, coeff=None,
              C=None) -> EngineCellStiffness:
    """Upload kernel-layout host arrays (G (cells, 6, n^3), a host array or
    a tensor, coeff (cells,), C (cells, 2), in dofmap cell order) with the
    dofmap and its inverse map."""
    t = lambda a: None if a is None else torch.tensor(
        np.asarray(a), dtype=dtype, device=device)
    i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32,
                                 device=device)
    pos, ptr = inverse_map(dofmap, ndofs)
    return EngineCellStiffness(G=cs.upload(G, dtype, device), D=t(D_1d),
                               dofmap=i32(dofmap), ndofs=int(ndofs),
                               pos=i32(pos), ptr=i32(ptr), coeff=t(coeff),
                               C=t(C))


def to_indexed(op: EngineCellStiffness, plan: ci.ChunkPlan
               ) -> ci.IndexedCellStiffness:
    """The indexed kernels' operator on the same G, D, dofmap and C
    buffers (unit coefficients or the pair form), with the dofmap's
    schedules' host part `plan` (``cuda_indexed.ChunkPlan``)."""
    if op.coeff is not None:
        raise ValueError("the indexed kernel folds a coefficient into G")
    return ci.IndexedCellStiffness(G=op.G, D=op.D, dofmap=op.dofmap,
                                   ndofs=op.ndofs, plan=plan, C=op.C)


# ---------------------------------------------------------------------------
# Plain versions: ``fustpu_torch.ops.engine`` on the same operator data
# ---------------------------------------------------------------------------

class PlainEngine(NamedTuple):
    """The engine operator in the layout of ``fustpu_torch.ops.engine``."""

    G6: torch.Tensor                 # (6, cells, n^3)
    g: torch.Tensor                  # (cells n^3,) int64
    D: torch.Tensor
    coeff: torch.Tensor | None
    c1: torch.Tensor | None
    c2: torch.Tensor | None


def to_plain(op: EngineCellStiffness) -> PlainEngine:
    """The same numbers as `op` in the plain layout, on op's device."""
    c1 = c2 = None
    if op.C is not None:
        c1, c2 = op.C[:, 0].contiguous(), op.C[:, 1].contiguous()
    return PlainEngine(G6=op.G.permute(1, 0, 2).contiguous(),
                       g=op.dofmap.reshape(-1).long(), D=op.D,
                       coeff=op.coeff, c1=c1, c2=c2)


def engine_plain(op: EngineCellStiffness, x: torch.Tensor) -> torch.Tensor:
    """Plain version of `engine`."""
    p = to_plain(op)
    return eng.stiffness_apply_engine(x, p.G6, p.coeff, p.g, p.D, op.ndofs)


def engine_pair_plain(op: EngineCellStiffness, x1: torch.Tensor,
                      x2: torch.Tensor) -> torch.Tensor:
    """Plain version of `engine_pair`."""
    p = to_plain(op)
    return eng.stiffness_apply_engine_pair(x1, p.c1, x2, p.c2, p.G6, p.g,
                                           p.D, op.ndofs)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(op: EngineCellStiffness, name: str, *xs: torch.Tensor,
           shape: tuple, dtype: torch.dtype | None = None) -> None:
    """Device, dtype (`dtype`, or the first input's), shape and contiguity
    of the inputs `xs` (each of `shape`) and of the operator tensors the
    kernel `name` reads (in the operator's dtype, G's)."""
    x = xs[0]
    dtype = x.dtype if dtype is None else dtype
    if x.device.type != "cuda":
        raise ValueError(f"{name} kernel: tensor on {x.device}, expected a "
                         "CUDA device")
    kinds = {"engine_gather_flat": (torch.float32, torch.float64),
             "engine_contract_cells": (torch.bfloat16,),
             "engine_scatter_dofs": (torch.bfloat16,)}.get(name, cs.SUFFIX)
    if x.dtype not in kinds:
        raise ValueError(f"{name} kernel: dtype {x.dtype} unsupported "
                         f"({', '.join(map(str, kinds))})")
    if not 2 <= op.P <= 10:
        raise ValueError(f"{name} kernel: degree {op.P} outside 2..10")
    cells, nnn = op.dofmap.shape
    need = [(t, shape, dtype, "input") for t in xs]
    if name.startswith("engine_contract"):
        need += [(op.G, (cells, 6, nnn), dtype, "G"),
                 (op.D, (op.P + 1, op.P + 1), dtype, "D")]
        if op.coeff is not None:
            need.append((op.coeff, (cells,), dtype, "coeff"))
        if op.C is not None:
            need.append((op.C, (cells, 2), dtype, "C"))
    elif name.startswith("engine_scatter"):
        need += [(op.pos, (cells * nnn,), torch.int32, "pos"),
                 (op.ptr, (op.ndofs + 1,), torch.int32, "ptr")]
    else:
        need.append((op.dofmap, (cells, nnn), torch.int32, "dofmap"))
    for t, shp, dtype, what in need:
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"{name} kernel: {what} is {t.dtype} on "
                             f"{t.device}, expected {dtype} on {x.device}")
        if tuple(t.shape) != tuple(shp):
            raise ValueError(f"{name} kernel: {what} has shape "
                             f"{tuple(t.shape)}, expected {tuple(shp)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: {what} is not contiguous")


def _launch(name: str, dtype: torch.dtype, x: torch.Tensor, *args,
            comparison: bool = False) -> None:
    """Launch kernel `name`'s form for storage `dtype` on x's card,
    counted in `launches` (its bfloat16 form in `bf16_launches`), or, for
    a first design kept as the comparison, in `comparison_launches`."""
    suffix = cs.SUFFIX[dtype]
    launch.launch(f"fustpu_{name}_{suffix}", x.get_device(), *args)
    if comparison:
        comparison_launches[name if dtype != torch.bfloat16
                            else f"{name}_{suffix}"] += 1
    else:
        cs.count(launches, bf16_launches, name, dtype)


def _aligned(name: str, **tensors) -> None:
    """Raise unless each tensor's data is aligned to its bytes (16 or 4):
    tensors = {what: (tensor, bytes)}."""
    for what, (t, b) in tensors.items():
        if t is not None and t.data_ptr() % b:
            raise ValueError(f"{name} kernel: {what} not {b}-byte aligned")


_D_HOST = WeakIdKeyDictionary()


def host_D(D: torch.Tensor) -> int:
    """The address of a host copy of D as float32 (what the bfloat16
    contraction takes by value), made once a tensor (and again after an
    in-place change of it) and kept while the tensor lives."""
    kept = _D_HOST.get(D)
    if kept is None or kept[0] != D._version:
        vals = D.detach().float().cpu().reshape(-1).tolist()
        kept = _D_HOST[D] = (D._version, (ctypes.c_float * len(vals))(*vals))
    return ctypes.addressof(kept[1])


def _positions(op: EngineCellStiffness) -> int:
    return op.dofmap.numel()


def gather(op: EngineCellStiffness, x: torch.Tensor) -> torch.Tensor:
    """u2 = x[g] as (cells, n^3) rows through `engine_gather` (the plain
    version for a CPU tensor): four positions a thread, on a one-wave
    grid."""
    cells = op.dofmap.shape[0]
    if x.device.type == "cpu":
        return eng.gather(x, op.dofmap.reshape(-1).long()).reshape(cells, -1)
    _check(op, "engine_gather", x, shape=(op.ndofs,))
    out = x.new_empty(op.dofmap.shape)
    pg, po = op.dofmap.data_ptr(), out.data_ptr()
    if pg % 16 or po % 16:
        raise ValueError("engine_gather kernel: the dofmap and the output "
                         "16-byte aligned")
    n = _positions(op)
    _launch("engine_gather", x.dtype, x, x.data_ptr(), pg, po, n,
            launch.gather_blocks(n, launch.sm_count(x.get_device())))
    return out


def gather_flat(op: EngineCellStiffness, x: torch.Tensor) -> torch.Tensor:
    """`gather` through the first design's kernel, the comparison: one
    thread a position (`engine_gather_flat`)."""
    if x.device.type == "cpu":
        return gather(op, x)
    _check(op, "engine_gather_flat", x, shape=(op.ndofs,))
    out = x.new_empty(op.dofmap.shape)
    _launch("engine_gather_flat", x.dtype, x, x.data_ptr(),
            op.dofmap.data_ptr(),
            out.data_ptr(), _positions(op), comparison=True)
    return out


def gather2(op: EngineCellStiffness, x1: torch.Tensor, x2: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(x1[g], x2[g]) in one pass through `engine_gather2` (the plain
    version for a CPU tensor): four positions a thread on a one-wave grid,
    one index load for both fields; in the dtypes of GATHER2_FIRST_DESIGN
    the first design's kernel, one thread a position."""
    cells = op.dofmap.shape[0]
    if x1.device.type == "cpu":
        u1, u2 = eng.gather2(x1, x2, op.dofmap.reshape(-1).long())
        return u1.reshape(cells, -1), u2.reshape(cells, -1)
    _check(op, "engine_gather2", x1, x2, shape=(op.ndofs,))
    o1 = x1.new_empty(op.dofmap.shape)
    o2 = x1.new_empty(op.dofmap.shape)
    n = _positions(op)
    args = (x1.data_ptr(), x2.data_ptr(), op.dofmap.data_ptr(),
            o1.data_ptr(), o2.data_ptr(), n)
    if x1.dtype in GATHER2_FIRST_DESIGN:
        launch.launch(f"fustpu_engine_gather2_flat_{cs.SUFFIX[x1.dtype]}",
                      x1.get_device(), *args)
        cs.count(launches, bf16_launches, "engine_gather2", x1.dtype)
        return o1, o2
    _aligned("engine_gather2", dofmap=(op.dofmap, 16), o1=(o1, 16),
             o2=(o2, 16))
    _launch("engine_gather2", x1.dtype, x1, *args,
            launch.gather_blocks(n, launch.sm_count(x1.get_device())))
    return o1, o2


def gather2_flat(op: EngineCellStiffness, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`gather2` through the first design's kernel, the comparison: one
    thread a position (`engine_gather2_flat`)."""
    if x1.device.type == "cpu":
        return gather2(op, x1, x2)
    _check(op, "engine_gather2_flat", x1, x2, shape=(op.ndofs,))
    o1 = x1.new_empty(op.dofmap.shape)
    o2 = x1.new_empty(op.dofmap.shape)
    _launch("engine_gather2_flat", x1.dtype, x1, x1.data_ptr(),
            x2.data_ptr(), op.dofmap.data_ptr(), o1.data_ptr(),
            o2.data_ptr(), _positions(op), comparison=True)
    return o1, o2


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


def _fields(op: EngineCellStiffness, u1: torch.Tensor,
            u2: torch.Tensor | None) -> tuple[torch.Tensor, ...]:
    """The contraction's inputs: two fields for a pair operator, else one."""
    pair = op.mode == "pair"
    if (u2 is not None) != pair:
        raise ValueError(f"contract of a {op.mode} operator takes "
                         f"{'two fields' if pair else 'one field'}")
    return (u1,) if u2 is None else (u1, u2)


def contract(op: EngineCellStiffness, u1: torch.Tensor,
             u2: torch.Tensor | None = None) -> torch.Tensor:
    """y2 = D3^T (c G . D3 u) on (cells, n^3) rows through
    `engine_contract`: u = u1 with unit coefficients or op.coeff, or
    u = c1 u1 + c2 u2 with op.C (the pair form)."""
    mode = op.mode
    xs = _fields(op, u1, u2)
    if u1.device.type == "cpu":
        p = to_plain(op)
        if mode == "pair":
            u1 = eng.fold(u1, p.c1, u2, p.c2)
        return eng.dense_contract(u1, p.G6, p.D, p.coeff)
    dtype = op.G.dtype
    _check(op, "engine_contract", *xs, shape=tuple(op.dofmap.shape),
           dtype=dtype)
    cells = op.dofmap.shape[0]
    if dtype != torch.bfloat16:     # the float32 / float64 kernels add
        y = u1.new_zeros(op.dofmap.shape, dtype=dtype)
        _launch("engine_contract", dtype, u1, u1.data_ptr(), _ptr(u2),
                _ptr(op.C), _ptr(op.coeff), op.G.data_ptr(),
                op.D.data_ptr(), y.data_ptr(), cells, op.P, _MODES[mode])
        return y
    y = u1.new_empty(op.dofmap.shape, dtype=dtype)
    _aligned("engine_contract", u1=(u1, 16), u2=(u2, 16), G=(op.G, 16),
             y2=(y, 16))
    dev = u1.get_device()
    blocks = launch.contract_blocks(
        cells, op.P, launch.contract_occupancy(dev, op.P, _MODES[mode]),
        launch.sm_count(dev))
    _launch("engine_contract", dtype, u1, u1.data_ptr(), _ptr(u2),
            _ptr(op.C), _ptr(op.coeff), op.G.data_ptr(), host_D(op.D),
            y.data_ptr(), cells, op.P, _MODES[mode],
            launch.CONTRACT_CELLS[op.P], blocks)
    return y


def contract_cells(op: EngineCellStiffness, u1: torch.Tensor,
                   u2: torch.Tensor | None = None) -> torch.Tensor:
    """`contract` on a bfloat16 operator through the first design's kernel,
    the comparison (`engine_contract_cells`: a block of a few cells, each
    thread's loads of u2 and G and stores of y2 its own)."""
    if u1.device.type == "cpu":
        return contract(op, u1, u2)
    xs = _fields(op, u1, u2)
    _check(op, "engine_contract_cells", *xs, shape=tuple(op.dofmap.shape))
    y = u1.new_empty(op.dofmap.shape)
    _launch("engine_contract_cells", u1.dtype, u1, u1.data_ptr(), _ptr(u2),
            _ptr(op.C), _ptr(op.coeff), op.G.data_ptr(), op.D.data_ptr(),
            y.data_ptr(), op.dofmap.shape[0], op.P, _MODES[op.mode],
            comparison=True)
    return y


def scatter(op: EngineCellStiffness, v: torch.Tensor) -> torch.Tensor:
    """y[g[p]] += v[p] over zeros(ndofs) through `engine_scatter`: each
    dof sums its positions in ascending order (the plain version for a CPU
    tensor); v and y in the operator's dtype."""
    dtype = op.G.dtype
    if v.device.type == "cpu":
        return eng.scatter_add(v, op.dofmap.reshape(-1).long(), op.ndofs)
    _check(op, "engine_scatter", v, shape=tuple(op.dofmap.shape),
           dtype=dtype)
    y = v.new_empty(op.ndofs, dtype=dtype)
    args = (v.data_ptr(), op.pos.data_ptr(), op.ptr.data_ptr(),
            y.data_ptr(), op.ndofs)
    if dtype == torch.bfloat16:
        _aligned("engine_scatter", pos=(op.pos, 16), y=(y, 4))
        args += (_positions(op), launch.scatter_blocks(op.ndofs))
    _launch("engine_scatter", dtype, v, *args)
    return y


def scatter_dofs(op: EngineCellStiffness, v: torch.Tensor) -> torch.Tensor:
    """`scatter` on bfloat16 values through the first design's kernel, the
    comparison (`engine_scatter_dofs`: one thread a dof)."""
    if v.device.type == "cpu":
        return scatter(op, v)
    _check(op, "engine_scatter_dofs", v, shape=tuple(op.dofmap.shape))
    y = v.new_empty(op.ndofs)
    _launch("engine_scatter_dofs", v.dtype, v, v.data_ptr(),
            op.pos.data_ptr(), op.ptr.data_ptr(), y.data_ptr(), op.ndofs,
            comparison=True)
    return y


def engine(op: EngineCellStiffness, x: torch.Tensor) -> torch.Tensor:
    """y = A(x) on flat fields: gather, contract, scatter (three launches
    on a CUDA tensor, the plain version on a CPU one)."""
    return scatter(op, contract(op, gather(op, x)))


def engine_pair(op: EngineCellStiffness, x1: torch.Tensor,
                x2: torch.Tensor) -> torch.Tensor:
    """y = A_c1(x1) + A_c2(x2) on flat fields: the two-field gather, the
    pair contraction, the scatter."""
    return scatter(op, contract(op, *gather2(op, x1, x2)))
