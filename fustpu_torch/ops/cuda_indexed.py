"""Indexed stiffness apply on the card (any conforming hex mesh): the
hand-written CUDA kernel of ``fustpu_torch/csrc/indexed.cu``, its
wrappers, its launch counters and the host build of the operator in the
kernel layout.

Counterpart of the fused gather/scatter engine of
``fustpu/ops/pallas_gather.py`` (`_mk_fused_kernel` through `fused_apply`
and `fused_apply_pair`):

- `indexed` replaces its 'plain' and 'coeff' modes: one field, any
  per-cell coefficient folded into G at build time;
- `indexed_pair` replaces its 'pair' mode: y = A_c1(x1) + A_c2(x2) with a
  unit G and per-cell (c1, c2), the heterogeneous Westervelt stage.

The kernel reads and writes the flat field through the dofmap itself, so
no gather or scatter runs around it.  Its scatter is deterministic:
`colour_cells` colours the cells so that no two cells of a colour share a
dof, and the kernel runs one launch per colour.

A wrapper given CPU tensors runs the plain version (`indexed_plain` /
`indexed_pair_plain`, ``fustpu_torch.ops.indexed`` on the same data).
Given CUDA tensors it launches the kernel or raises: there is no fallback.
Each wrapper counts its applies in `launches` (one per apply, whatever the
class count).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from fustpu_torch.ops import indexed as idx

# Applies that went through each kernel (not counting the plain version).
launches = {"indexed": 0, "indexed_pair": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class IndexedCellStiffness(NamedTuple):
    """Indexed stiffness operator in the kernel layout, on one device."""

    G: torch.Tensor                  # (cells, 6, n^3), coefficient folded in
    D: torch.Tensor                  # (n, n) D[q, i] = l_i'(x_q)
    dofmap: torch.Tensor             # (cells, n^3) int32
    ndofs: int
    cells: torch.Tensor              # (cells,) int32 ids grouped by class
    bounds: tuple                    # class boundaries into `cells`
    C: torch.Tensor | None = None    # (cells, 2) pair coefficients

    @property
    def P(self) -> int:
        return self.D.shape[0] - 1


def colour_cells(dofmap: np.ndarray, ndofs: int) -> np.ndarray:
    """Greedy colouring of the cells, in cell order, such that no two cells
    of one colour share a dof: each dof keeps a bitmask of the colours of
    the cells that touch it, and a cell takes the lowest colour free on
    all of its dofs.  Returns the (cells,) colour of each cell."""
    dm = np.asarray(dofmap, np.int64)
    used = np.zeros(ndofs, np.uint64)
    colour = np.empty(dm.shape[0], np.int64)
    for c, ids in enumerate(dm):
        taken = int(np.bitwise_or.reduce(used[ids]))
        k = (~taken & (taken + 1)).bit_length() - 1    # lowest free colour
        if k >= 64:
            raise ValueError(f"cell {c} needs more than 64 colours")
        colour[c] = k
        used[ids] |= np.uint64(1 << k)
    return colour


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


def build(mesh, G_cells: np.ndarray, D_1d: np.ndarray, dtype: torch.dtype,
          device, coeff=None, pair=None,
          classes: tuple | None = None) -> IndexedCellStiffness:
    """The operator in the kernel layout on `device`, from host float64
    data: G_cells (cells, n^3, 6) in mesh cell order; `coeff` (per-cell)
    is folded into G; `pair` = (c1, c2) per-cell fields makes a unit-G
    pair operator; `classes`: the mesh's `scatter_classes`, if known."""
    cell_field = lambda c: np.broadcast_to(np.asarray(c, np.float64),
                                           (mesh.num_cells,))
    G = np.moveaxis(np.asarray(G_cells), 2, 1)
    if coeff is not None:
        G = G * cell_field(coeff)[:, None, None]
    C = None
    if pair is not None:
        C = np.stack([cell_field(c) for c in pair], axis=1)
    return from_host(mesh.dofmap, mesh.ndofs, np.ascontiguousarray(G),
                     D_1d, dtype, device, C, classes)


def from_host(dofmap: np.ndarray, ndofs: int, G: np.ndarray,
              D_1d: np.ndarray, dtype: torch.dtype, device,
              C: np.ndarray | None = None,
              classes: tuple | None = None) -> IndexedCellStiffness:
    """Upload kernel-layout host arrays (G (cells, 6, n^3) and C
    (cells, 2) in mesh cell order), the dofmap and its scatter classes
    (computed here unless `classes` gives them)."""
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    cells, bounds = classes or scatter_classes(dofmap, ndofs)
    return IndexedCellStiffness(
        G=t(G), D=t(D_1d),
        dofmap=torch.tensor(np.asarray(dofmap), dtype=torch.int32,
                            device=device),
        ndofs=int(ndofs), cells=torch.as_tensor(cells, device=device),
        bounds=bounds, C=None if C is None else t(C))


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

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(op: IndexedCellStiffness, *xs: torch.Tensor, pair: bool) -> None:
    x = xs[0]
    if x.device.type != "cuda":
        raise ValueError(f"indexed kernel: tensor on {x.device}, "
                         "expected a CUDA device")
    if x.dtype not in _SUFFIX:
        raise ValueError(f"indexed kernel: dtype {x.dtype} unsupported "
                         "(float32 or float64)")
    if not 2 <= op.P <= 10:
        raise ValueError(f"indexed kernel: degree {op.P} outside 2..10")
    nnn = (op.P + 1) ** 3
    ncells = op.dofmap.shape[0]
    shapes = [(t, (op.ndofs,), x.dtype, "x") for t in xs] + [
        (op.G, (ncells, 6, nnn), x.dtype, "G"),
        (op.D, (op.P + 1, op.P + 1), x.dtype, "D"),
        (op.dofmap, (ncells, nnn), torch.int32, "dofmap"),
        (op.cells, (ncells,), torch.int32, "cells")]
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
    if op.bounds[-1] != ncells:
        raise ValueError(f"indexed kernel: the scatter classes cover "
                         f"{op.bounds[-1]} of {ncells} cells")


def _launch(name: str, op: IndexedCellStiffness, xs, extra) -> torch.Tensor:
    from fustpu_torch import _build

    x = xs[0]
    y = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    fn = getattr(_build.load(), f"fustpu_{name}_{_SUFFIX[x.dtype]}")
    bounds = (ctypes.c_longlong * len(op.bounds))(*op.bounds)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(t.data_ptr() for t in xs), *extra, op.G.data_ptr(),
                 op.D.data_ptr(), op.dofmap.data_ptr(), op.cells.data_ptr(),
                 ctypes.addressof(bounds), len(op.bounds) - 1,
                 y.data_ptr(), op.P, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {err}")
    launches[name] += 1
    return y


def indexed(op: IndexedCellStiffness, x: torch.Tensor) -> torch.Tensor:
    """y = A_stiff(x) on flat fields through the single-field kernel (the
    plain version for a CPU tensor)."""
    if x.device.type == "cpu":
        return indexed_plain(op, x)
    _check(op, x, pair=False)
    return _launch("indexed", op, (x,), ())


def indexed_pair(op: IndexedCellStiffness, x1: torch.Tensor,
                 x2: torch.Tensor) -> torch.Tensor:
    """y = A_c1(x1) + A_c2(x2) on flat fields through the pair kernel (the
    plain version for CPU tensors)."""
    if x1.device.type == "cpu":
        return indexed_pair_plain(op, x1, x2)
    _check(op, x1, x2, pair=True)
    return _launch("indexed_pair", op, (x1, x2), (op.C.data_ptr(),))
