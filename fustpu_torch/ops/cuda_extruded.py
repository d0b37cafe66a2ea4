"""Extruded stiffness apply on the card: the hand-written CUDA kernel of
``fustpu_torch/csrc/extruded.cu``, its wrappers, its launch counters and the
host build of the operator in the kernel layout.

Counterpart of ``fustpu/ops/pallas_extruded.py`` (its G-stream form):

- `extruded` replaces `_mk_kernel` through `stiffness_apply_extruded_pallas`:
  one field, any per-cell coefficient folded into G at build time;
- `extruded_pair` replaces it through
  `stiffness_apply_extruded_pallas_pair`: y = A_c1(x1) + A_c2(x2) with a
  unit G and per-cell (c1, c2), the heterogeneous Westervelt stage.

The kernel reads and writes the flat field through the per-stack row ids
(dof = rows2d[s, i n + j] gz + kz P + k), so no gather or scatter runs
around it.  Its scatter is deterministic: `colour_stacks` colours the stacks
so that no two stacks of a colour share a row, and the kernel runs one
launch per (colour, layer parity) class, whose cells share no dof.

A wrapper given CPU tensors runs the plain version (`extruded_plain` /
`extruded_pair_plain`, the einsum formulation of
``fustpu_torch.ops.extruded`` on the same data).  Given CUDA tensors it
launches the kernel or raises: there is no fallback.  Each wrapper counts
its applies in `launches` (one per apply, whatever the class count).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from fustpu_torch.ops import extruded as ext
from fustpu_torch.ops import spectral_mm as mm

# Applies that went through each kernel (not counting the plain version).
launches = {"extruded": 0, "extruded_pair": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class ExtrudedCellStiffness(NamedTuple):
    """Extruded stiffness operator in the kernel layout, on one device."""

    G: torch.Tensor                  # (cells, 6, n^3), cell s*nz + kz,
                                     # coefficient folded in
    D: torch.Tensor                  # (n, n) D[q, i] = l_i'(x_q)
    rows: torch.Tensor               # (ns, n^2) int32 2D row ids
    nz: int                          # layers
    n2d: int                         # 2D rows
    cells: torch.Tensor              # (cells,) int32 ids grouped by class
    bounds: tuple                    # class boundaries into `cells`
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


def scatter_classes(rows2d: np.ndarray, nz: int) -> tuple[np.ndarray,
                                                          tuple]:
    """(cells, bounds): the stack-order cell ids s*nz + kz grouped into
    classes (colour, kz % 2), each class ordered by (stack, layer), and the
    class boundaries.  Cells of one class share no dof."""
    colour = colour_stacks(rows2d)
    ids, bounds = [], [0]
    for c in range(int(colour.max()) + 1):
        stacks = np.flatnonzero(colour == c)
        for parity in (0, 1):
            kz = np.arange(parity, nz, 2)
            ids.append((stacks[:, None] * nz + kz[None, :]).reshape(-1))
            bounds.append(bounds[-1] + ids[-1].size)
    return np.concatenate(ids).astype(np.int32), tuple(bounds)


def stack_order(mesh, a: np.ndarray) -> np.ndarray:
    """Per-cell rows of `a` (mesh cell order) in stack order s*nz + kz."""
    return np.asarray(a)[mesh.stack_cells.reshape(-1)]


def build(mesh, G_cells: np.ndarray, D_1d: np.ndarray, dtype: torch.dtype,
          device, coeff=None, pair=None) -> ExtrudedCellStiffness:
    """The operator in the kernel layout on `device`, from host float64
    data: G_cells (cells, n^3, 6) in mesh cell order; `coeff` (per-cell)
    is folded into G; `pair` = (c1, c2) per-cell fields makes a unit-G
    pair operator."""
    G = np.moveaxis(stack_order(mesh, G_cells), 2, 1)
    if coeff is not None:
        c = stack_order(mesh, np.broadcast_to(np.asarray(coeff, np.float64),
                                              (mesh.num_cells,)))
        G = G * c[:, None, None]
    C = None
    if pair is not None:
        C = np.stack([stack_order(mesh, np.broadcast_to(
            np.asarray(c, np.float64), (mesh.num_cells,))) for c in pair],
            axis=1)
    return from_host(mesh, np.ascontiguousarray(G), D_1d, dtype, device, C)


def from_host(mesh, G: np.ndarray, D_1d: np.ndarray, dtype: torch.dtype,
              device, C: np.ndarray | None = None) -> ExtrudedCellStiffness:
    """Upload kernel-layout host arrays (G (cells, 6, n^3) and C
    (cells, 2) in stack order) and the mesh's rows and scatter classes."""
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    cells, bounds = scatter_classes(mesh.rows2d, mesh.nz)
    return ExtrudedCellStiffness(
        G=t(G), D=t(D_1d),
        rows=torch.as_tensor(np.ascontiguousarray(mesh.rows2d, np.int32),
                             device=device),
        nz=mesh.nz, n2d=mesh.n2d,
        cells=torch.as_tensor(cells, device=device), bounds=bounds,
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
        Wz=torch.as_tensor(mm.window_matrix(nz, op.P), dtype=op.G.dtype,
                           device=op.G.device),
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

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(op: ExtrudedCellStiffness, *xs: torch.Tensor, pair: bool) -> None:
    x = xs[0]
    if x.device.type != "cuda":
        raise ValueError(f"extruded kernel: tensor on {x.device}, "
                         "expected a CUDA device")
    if x.dtype not in _SUFFIX:
        raise ValueError(f"extruded kernel: dtype {x.dtype} unsupported "
                         "(float32 or float64)")
    if not 2 <= op.P <= 10:
        raise ValueError(f"extruded kernel: degree {op.P} outside 2..10")
    n = op.P + 1
    ns = op.rows.shape[0]
    ncells = ns * op.nz
    shapes = [(t, (op.ndofs,), x.dtype, "x") for t in xs] + [
        (op.G, (ncells, 6, n ** 3), x.dtype, "G"),
        (op.D, (n, n), x.dtype, "D"),
        (op.rows, (ns, n * n), torch.int32, "rows"),
        (op.cells, (ncells,), torch.int32, "cells")]
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
    if op.bounds[-1] != ncells:
        raise ValueError(f"extruded kernel: the scatter classes cover "
                         f"{op.bounds[-1]} of {ncells} cells")


def _launch(name: str, op: ExtrudedCellStiffness, xs, extra
            ) -> torch.Tensor:
    from fustpu_torch import _build

    x = xs[0]
    y = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    fn = getattr(_build.load(), f"fustpu_{name}_{_SUFFIX[x.dtype]}")
    bounds = (ctypes.c_longlong * len(op.bounds))(*op.bounds)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(t.data_ptr() for t in xs), *extra, op.G.data_ptr(),
                 op.D.data_ptr(), op.rows.data_ptr(), op.cells.data_ptr(),
                 ctypes.addressof(bounds), len(op.bounds) - 1,
                 y.data_ptr(), op.P, op.nz, op.gz, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {err}")
    launches[name] += 1
    return y


def extruded(op: ExtrudedCellStiffness, x: torch.Tensor) -> torch.Tensor:
    """y = A_stiff(x) on flat fields through the single-field kernel (the
    plain version for a CPU tensor)."""
    if x.device.type == "cpu":
        return extruded_plain(op, x)
    _check(op, x, pair=False)
    return _launch("extruded", op, (x,), ())


def extruded_pair(op: ExtrudedCellStiffness, x1: torch.Tensor,
                  x2: torch.Tensor) -> torch.Tensor:
    """y = A_c1(x1) + A_c2(x2) on flat fields through the pair kernel (the
    plain version for CPU tensors)."""
    if x1.device.type == "cpu":
        return extruded_pair_plain(op, x1, x2)
    _check(op, x1, x2, pair=True)
    return _launch("extruded_pair", op, (x1, x2), (op.C.data_ptr(),))
