"""Corner-streamed stiffness apply on the card (the capacity mode): the
hand-written CUDA kernels of ``fustpu_torch/csrc/corner.cu``,
``extruded_corner.cu`` and ``extruded_corner27.cu``, their wrappers, their
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

A wrapper given CPU tensors runs the plain version (`corner_plain` /
`corner_pair_plain`: the channels expanded into the metric by
`corner.expand_G`, then the plain G-stream apply of
``fustpu_torch.ops.cuda_stiffness`` or ``cuda_extruded``).  Given CUDA
tensors it launches the kernel or raises: there is no fallback.  Each
wrapper counts its applies in `launches` (one per apply).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from fustpu_torch.ops import corner as cn
from fustpu_torch.ops import cuda_extruded as ce
from fustpu_torch.ops import cuda_stiffness as cs

# Applies that went through each kernel (not counting the plain version).
launches = {"corner": 0, "corner_pair": 0, "extruded_corner": 0,
            "extruded_corner_pair": 0, "extruded_corner_hex27": 0,
            "extruded_corner_hex27_pair": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class CornerCellStiffness(NamedTuple):
    """Corner-streamed stiffness operator in the kernel layout, on one
    device: a box operator when `nc` is set, an extruded one otherwise."""

    T: torch.Tensor                  # (cells, nch + 1) channels, coefficient
                                     # last; box order cx*ncy*ncz + cy*ncz
                                     # + cz or stack order s*nz + kz
    D: torch.Tensor                  # (n, n) D[q, i] = l_i'(x_q)
    Q: torch.Tensor                  # (2, n) unit GLL nodes, then weights
    geom_deg: int                    # 1 (hex8) or 2 (hex27, extruded only)
    nc: tuple | None = None          # box: cells per axis
    rows: torch.Tensor | None = None  # extruded: (ns, n^2) int32 row ids
    nz: int = 0                      # extruded: layers
    n2d: int = 0                     # extruded: 2D rows
    cells: torch.Tensor | None = None  # extruded: (cells,) int32 by class
    bounds: tuple = ()               # extruded: class boundaries
    C: torch.Tensor | None = None    # (cells, 2) pair coefficients

    @property
    def P(self) -> int:
        return self.D.shape[0] - 1

    @property
    def box(self) -> bool:
        return self.nc is not None

    @property
    def kernel(self) -> str:
        """The launch counter of the single-field kernel of this
        operator."""
        if self.box:
            return "corner"
        return "extruded_corner" + ("_hex27" if self.geom_deg == 2 else "")

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
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                  device=device)
    n = D_1d.shape[0]
    return dict(T=t(T), D=t(D_1d), Q=t(cn.quadrature(n)),
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
    (cells, 2) with the mesh's rows and scatter classes."""
    cells, bounds = ce.scatter_classes(mesh.rows2d, mesh.nz)
    return CornerCellStiffness(
        **_tensors(T, D_1d, dtype, device, C),
        geom_deg=cn.geom_degree(mesh),
        rows=torch.as_tensor(np.ascontiguousarray(mesh.rows2d, np.int32),
                             device=device),
        nz=mesh.nz, n2d=mesh.n2d,
        cells=torch.as_tensor(cells, device=device), bounds=bounds)


# ---------------------------------------------------------------------------
# Plain versions: the channels expanded into the metric, then the plain
# G-stream apply on the same data
# ---------------------------------------------------------------------------

def to_g_stream(op: CornerCellStiffness):
    """The G-stream operator (`cs.CellStiffness` or
    `ce.ExtrudedCellStiffness`) holding the metric that `op`'s channels
    give, on op's device: the plain version's operator data."""
    n = op.P + 1
    G = cn.expand_G(op.T, n, op.geom_deg, op.box)
    if op.box:
        return cs.CellStiffness(G=G, D=op.D, nc=op.nc, C=op.C)
    return ce.ExtrudedCellStiffness(G=G, D=op.D, rows=op.rows, nz=op.nz,
                                    n2d=op.n2d, cells=op.cells,
                                    bounds=op.bounds, C=op.C)


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


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(op: CornerCellStiffness, *xs: torch.Tensor, pair: bool) -> None:
    x = xs[0]
    if x.device.type != "cuda":
        raise ValueError(f"corner kernel: tensor on {x.device}, expected a "
                         "CUDA device")
    if x.dtype not in _SUFFIX:
        raise ValueError(f"corner kernel: dtype {x.dtype} unsupported "
                         "(float32 or float64)")
    if not 2 <= op.P <= 10:
        raise ValueError(f"corner kernel: degree {op.P} outside 2..10")
    if op.geom_deg not in ((1,) if op.box else (1, 2)):
        raise ValueError(f"corner kernel: geometry degree {op.geom_deg}")
    n = op.P + 1
    nch = cn.channel_table(op.geom_deg, op.box)[0] + 1
    if op.box:
        ncells = op.nc[0] * op.nc[1] * op.nc[2]
    else:
        ncells = op.rows.shape[0] * op.nz
    shapes = [(t, op.grid_shape, x.dtype, "x") for t in xs] + [
        (op.T, (ncells, nch), x.dtype, "T"), (op.D, (n, n), x.dtype, "D"),
        (op.Q, (2, n), x.dtype, "Q")]
    if not op.box:
        shapes += [(op.rows, (op.rows.shape[0], n * n), torch.int32, "rows"),
                   (op.cells, (ncells,), torch.int32, "cells")]
        if op.bounds[-1] != ncells:
            raise ValueError(f"corner kernel: the scatter classes cover "
                             f"{op.bounds[-1]} of {ncells} cells")
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


def _launch(name: str, op: CornerCellStiffness, xs, extra) -> torch.Tensor:
    from fustpu_torch import _build

    x = xs[0]
    y = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    fn = getattr(_build.load(), f"fustpu_{name}_{_SUFFIX[x.dtype]}")
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
    launches[name] += 1
    return y


def _apply(op: CornerCellStiffness, x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return corner_plain(op, x)
    _check(op, x, pair=False)
    return _launch(op.kernel, op, (x,), ())


def _apply_pair(op: CornerCellStiffness, x1: torch.Tensor,
                x2: torch.Tensor) -> torch.Tensor:
    if x1.device.type == "cpu":
        return corner_pair_plain(op, x1, x2)
    _check(op, x1, x2, pair=True)
    return _launch(op.kernel + "_pair", op, (x1, x2), (op.C.data_ptr(),))


def corner(op: CornerCellStiffness, x: torch.Tensor) -> torch.Tensor:
    """y_grid = A_stiff(x_grid) on a box through the structured corner
    kernel (the plain version for a CPU tensor)."""
    if not op.box:
        raise ValueError("corner: an extruded operator (use extruded_corner)")
    return _apply(op, x)


def corner_pair(op: CornerCellStiffness, x1: torch.Tensor,
                x2: torch.Tensor) -> torch.Tensor:
    """y_grid = A_c1(x1) + A_c2(x2) on a box through the structured corner
    pair kernel (the plain version for CPU tensors)."""
    if not op.box:
        raise ValueError("corner_pair: an extruded operator (use "
                         "extruded_corner_pair)")
    return _apply_pair(op, x1, x2)


def extruded_corner(op: CornerCellStiffness,
                    x: torch.Tensor) -> torch.Tensor:
    """y = A_stiff(x) on flat fields through the extruded corner kernel of
    the operator's geometry degree (the plain version for a CPU tensor)."""
    if op.box:
        raise ValueError("extruded_corner: a box operator (use corner)")
    return _apply(op, x)


def extruded_corner_pair(op: CornerCellStiffness, x1: torch.Tensor,
                         x2: torch.Tensor) -> torch.Tensor:
    """y = A_c1(x1) + A_c2(x2) on flat fields through the extruded corner
    pair kernel (the plain version for CPU tensors)."""
    if op.box:
        raise ValueError("extruded_corner_pair: a box operator (use "
                         "corner_pair)")
    return _apply_pair(op, x1, x2)
