"""Spectral-element discretization of a structured box mesh or an
imported (prismatic or general) hex mesh: host-side (float64 numpy)
geometry, facet blocks and diagonal assembly, and the stiffness operator
on the device.

With GLL collocation every mass-type operator (cell or facet) is globally
diagonal, so each fixed coefficient field yields a precomputed diagonal
vector and an apply is one elementwise multiply (`mass_diag_host` /
`facet_diag_host`).  The stiffness operator is `StructuredStiffness` on a
box mesh, `ExtrudedStiffness` on an `ExtrudedHexMesh` and
`IndexedStiffness` on any other `UnstructuredHexMesh`: the CUDA kernels on
a CUDA device, or their plain torch versions.  In the corner-streamed
capacity mode (``stiffness_impl="pallas_corner"``) a box or an extruded mesh
takes `CornerStiffness` instead, built from the cell corners (or the hex27
lattice) without the host metric.  Counterpart of
``fustpu/models/discretization.py`` without its TPU-only parts.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from fustpu_torch.mesh.extruded import ExtrudedHexMesh
from fustpu_torch.ops import cuda_corner as cc
from fustpu_torch.ops import cuda_extruded as ce
from fustpu_torch.ops import cuda_indexed as ci
from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.ops import extruded as ext
from fustpu_torch.ops import indexed as idx
from fustpu_torch.ops import precompute as pre
from fustpu_torch.ops import spectral_mm as mm

# The names of the corner-streamed capacity mode (the JAX package's).
CORNER_IMPLS = ("pallas_corner", "extruded_pallas_corner")


class FacetBlock(NamedTuple):
    """A set of boundary facets with geometry factors (host arrays)."""

    cells: np.ndarray          # (nf,) owning cell
    dofmap_host: np.ndarray    # (nf, n^2) flat global node indices
    detJ_host: np.ndarray      # (nf, n^2) float64

    @property
    def num_facets(self) -> int:
        return self.cells.shape[0]


class Discretization:
    """Host geometry factors and facet machinery for one box mesh or
    imported (unstructured) mesh."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.P = mesh.degree
        self.structured = hasattr(mesh, "nc")
        # seconds of the host set-up steps, by name, as they run
        self.host_seconds = {}
        self._detJ_host = pre.cell_detJ(mesh)              # (cells, n^3)
        self._D_host = mesh.element.deriv_1d

    @functools.cached_property
    def _G_host(self) -> np.ndarray:
        """(cells, n^3, 6) metric factors, float64 host, computed on first
        use (never in the corner mode: 48 B per node, the largest host
        array of the set-up)."""
        t0 = time.perf_counter()
        G = pre.cell_geometry_factors(self.mesh)[1]
        self.host_seconds["geometry"] = time.perf_counter() - t0
        return G

    @functools.cached_property
    def scatter_classes(self) -> tuple[np.ndarray, tuple]:
        """The indexed kernel's colour classes of the cells (computed on
        first use, shared by every indexed operator of this mesh)."""
        t0 = time.perf_counter()
        out = ci.scatter_classes(self.mesh.dofmap, self.mesh.ndofs)
        self.host_seconds["colouring"] = time.perf_counter() - t0
        return out

    # ---- facets -----------------------------------------------------------
    def facet_block(self, boundary_data: np.ndarray) -> FacetBlock:
        bd = np.asarray(boundary_data, np.int64).reshape(-1, 2)
        return FacetBlock(cells=bd[:, 0].copy(),
                          dofmap_host=self.mesh.facet_dofmap(bd),
                          detJ_host=pre.facet_geometry_factors(self.mesh, bd))

    def facet_points(self, block: FacetBlock) -> np.ndarray:
        """(nf, n^2, 3) physical coordinates of facet nodes."""
        return self.mesh.node_coords.reshape(-1, 3)[block.dofmap_host]

    # ---- host-side float64 diagonal assembly ------------------------------
    def mass_diag_host(self, cell_coeff=None) -> np.ndarray:
        """Global diagonal of the mass operator for a per-cell coefficient
        field, float64 on host, grid-shaped (flat (ndofs,) on an
        unstructured mesh)."""
        if not self.structured:
            vals = self._detJ_host
            if cell_coeff is not None:
                vals = vals * np.asarray(
                    cell_coeff, np.float64).reshape(-1)[:, None]
            # the sum through the dofmap (the JAX package's np.add.at,
            # as one bincount)
            return np.bincount(self.mesh.dofmap.ravel(), vals.ravel(),
                               minlength=self.mesh.ndofs)
        coeff = None if cell_coeff is None else np.asarray(
            cell_coeff).reshape(self.mesh.nc)
        return mm.mass_diagonal(self.mesh.nc, self.P, self._detJ_host, coeff)

    def facet_diag_host(self, block: FacetBlock, facet_coeff,
                        node_weights: np.ndarray | None = None
                        ) -> np.ndarray:
        """Global diagonal of a facet-mass operator (float64 host).  Also
        the precomputed source vector: the source field is g(t) times this
        vector.  Optional per-facet-node `node_weights` (nf, n^2) support
        apodised / phased apertures."""
        vals = block.detJ_host * np.asarray(facet_coeff)[:, None]
        if node_weights is not None:
            vals = vals * node_weights
        y = np.zeros(self.mesh.ndofs)
        np.add.at(y, block.dofmap_host.ravel(), vals.ravel())
        return y.reshape(self.mesh.grid_shape)

    # ---- stiffness --------------------------------------------------------
    def stiffness_op(self, dtype: torch.dtype, device, coeff=None,
                     pair=None, corner: bool = False):
        """The stiffness operator in the kernel layout, on `device`
        (`cs.CellStiffness` on a box mesh, `ce.ExtrudedCellStiffness` on
        an extruded one, `ci.IndexedCellStiffness` on any other imported
        mesh): `coeff` (per-cell) is folded into G; `pair` = (c1, c2)
        per-cell fields makes a unit-G pair operator.  `corner`: the
        corner-streamed `cc.CornerCellStiffness` on a box or extruded mesh,
        built without the host metric; a general mesh has no corner form
        and takes the indexed operator, as the JAX package routes it."""
        extruded = isinstance(self.mesh, ExtrudedHexMesh)
        if corner and (self.structured or extruded):
            t0 = time.perf_counter()
            build = cc.build_extruded if extruded else cc.build_box
            op = build(self.mesh, self._D_host, dtype, device, coeff=coeff,
                       pair=pair)
            self.host_seconds["channels"] = time.perf_counter() - t0
            return op
        if extruded:
            return ce.build(self.mesh, self._G_host, self._D_host, dtype,
                            device, coeff=coeff, pair=pair)
        if not self.structured:
            return ci.build(self.mesh, self._G_host, self._D_host, dtype,
                            device, coeff=coeff, pair=pair,
                            classes=self.scatter_classes)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        C = None
        if pair is not None:
            C = t(np.stack([np.broadcast_to(np.asarray(c, np.float64),
                                            self.mesh.nc).reshape(-1)
                            for c in pair], axis=1))
        return cs.CellStiffness(G=t(cs.pack_G(self._G_host, coeff)),
                                D=t(self._D_host), nc=tuple(self.mesh.nc),
                                C=C)


def resolve_stiffness_impl(impl: str, device) -> str:
    """'auto' is the CUDA kernel on a CUDA device and the plain torch
    version elsewhere; 'mm' forces the plain version (on any mesh kind).
    The corner-mode names (CORNER_IMPLS) resolve as 'auto' does: they
    choose the operator (`Discretization.stiffness_op(corner=True)`), the
    device chooses kernel or plain version."""
    if impl == "mm":
        return "mm"
    if impl == "auto" or impl in CORNER_IMPLS:
        return "cuda" if torch.device(device).type == "cuda" else "mm"
    raise ValueError(f"stiffness_impl={impl!r}: expected 'auto', 'mm' or "
                     f"one of {CORNER_IMPLS}")


class StructuredStiffness(nn.Module):
    """The stiffness operator as buffers in the layout its implementation
    reads: the kernel layout for 'cuda', the matmul layout for 'mm'.
    ``StructuredStiffness(op.cell_op, "mm")`` is the plain version of a
    kernel-layout operator `op`, with the same numbers.
    `forward(x)` is the single-field apply, `pair(x1, x2)` the two-field
    one; both take and return grid-shaped tensors."""

    def __init__(self, op: cs.CellStiffness, impl: str):
        super().__init__()
        self.impl = impl
        self.nc = tuple(op.nc)
        self.is_pair = op.C is not None
        if impl == "cuda":
            self.register_buffer("G", op.G)
            self.register_buffer("D", op.D)
            self.register_buffer("C", op.C)
        else:
            mm_op, c1_e, c2_e = cs.to_mm(op)
            for ax in range(3):
                self.register_buffer(f"W{ax}", mm_op.W[ax])
                self.register_buffer(f"Dt{ax}", mm_op.Dt[ax])
            self.register_buffer("Gm", mm_op.G)
            self.register_buffer("c1_e", c1_e)
            self.register_buffer("c2_e", c2_e)

    @property
    def kernel(self) -> str | None:
        """The launch counter that an apply moves (None for 'mm')."""
        if self.impl != "cuda":
            return None
        return "stiffness_pair" if self.is_pair else "stiffness"

    @property
    def cell_op(self) -> cs.CellStiffness:
        return cs.CellStiffness(G=self.G, D=self.D, nc=self.nc, C=self.C)

    @property
    def mm_op(self) -> mm.MMStiffness:
        return mm.MMStiffness(W=(self.W0, self.W1, self.W2),
                              Dt=(self.Dt0, self.Dt1, self.Dt2), G=self.Gm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.impl == "cuda":
            return cs.stiffness(self.cell_op, x)
        return mm.stiffness_apply_mm(self.mm_op, x)

    def pair(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        if self.impl == "cuda":
            return cs.stiffness_pair(self.cell_op, x1, x2)
        return mm.stiffness_apply_mm_pair(self.mm_op, x1, x2,
                                          self.c1_e, self.c2_e)


class ExtrudedStiffness(nn.Module):
    """The extruded stiffness operator as buffers in the layout its
    implementation reads: the kernel layout for 'cuda', the einsum layout
    for 'mm'.  ``ExtrudedStiffness(op.cell_op, "mm")`` is the plain version
    of a kernel-layout operator `op`, with the same numbers.  `forward(x)`
    is the single-field apply, `pair(x1, x2)` the two-field one; both take
    and return flat tensors."""

    def __init__(self, op: ce.ExtrudedCellStiffness, impl: str):
        super().__init__()
        self.impl = impl
        self.nz, self.n2d, self.bounds = op.nz, op.n2d, op.bounds
        self.ndofs = op.ndofs
        self.is_pair = op.C is not None
        if impl == "cuda":
            for name in ("G", "D", "rows", "cells", "C"):
                self.register_buffer(name, getattr(op, name))
        else:
            plain, c1_x, c2_x = ce.to_plain(op)
            for name in ext.PlainExtruded._fields:
                self.register_buffer(name, getattr(plain, name))
            self.register_buffer("c1_x", c1_x)
            self.register_buffer("c2_x", c2_x)

    @property
    def kernel(self) -> str | None:
        """The launch counter that an apply moves (None for 'mm')."""
        if self.impl != "cuda":
            return None
        return "extruded_pair" if self.is_pair else "extruded"

    @property
    def cell_op(self) -> ce.ExtrudedCellStiffness:
        return ce.ExtrudedCellStiffness(
            G=self.G, D=self.D, rows=self.rows, nz=self.nz, n2d=self.n2d,
            cells=self.cells, bounds=self.bounds, C=self.C)

    @property
    def plain_op(self) -> ext.PlainExtruded:
        return ext.PlainExtruded(rows=self.rows, G6=self.G6, Wz=self.Wz,
                                 Dz=self.Dz, D=self.D)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.impl == "cuda":
            return ce.extruded(self.cell_op, x)
        return ext.stiffness_apply_extruded(x, self.plain_op, self.ndofs)

    def pair(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        if self.impl == "cuda":
            return ce.extruded_pair(self.cell_op, x1, x2)
        return ext.stiffness_apply_extruded_pair(
            x1, x2, self.plain_op, self.ndofs, self.c1_x, self.c2_x)


class IndexedStiffness(nn.Module):
    """The indexed stiffness operator as buffers in the layout its
    implementation reads: the kernel layout for 'cuda', the plain layout
    of ``fustpu_torch.ops.indexed`` for 'mm'.
    ``IndexedStiffness(op.cell_op, "mm")`` is the plain version of a
    kernel-layout operator `op`, with the same numbers.  `forward(x)` is
    the single-field apply, `pair(x1, x2)` the two-field one; both take
    and return flat tensors."""

    def __init__(self, op: ci.IndexedCellStiffness, impl: str):
        super().__init__()
        self.impl = impl
        self.ndofs, self.bounds = op.ndofs, op.bounds
        self.is_pair = op.C is not None
        if impl == "cuda":
            for name in ("G", "D", "dofmap", "cells", "C"):
                self.register_buffer(name, getattr(op, name))
        else:
            plain = ci.to_plain(op)
            for name in ci.PlainIndexed._fields:
                self.register_buffer(f"plain_{name}", getattr(plain, name))

    @property
    def kernel(self) -> str | None:
        """The launch counter that an apply moves (None for 'mm')."""
        if self.impl != "cuda":
            return None
        return "indexed_pair" if self.is_pair else "indexed"

    @property
    def cell_op(self) -> ci.IndexedCellStiffness:
        return ci.IndexedCellStiffness(
            G=self.G, D=self.D, dofmap=self.dofmap, ndofs=self.ndofs,
            cells=self.cells, bounds=self.bounds, C=self.C)

    @property
    def plain_op(self) -> ci.PlainIndexed:
        return ci.PlainIndexed(*(getattr(self, f"plain_{name}")
                                 for name in ci.PlainIndexed._fields))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.impl == "cuda":
            return ci.indexed(self.cell_op, x)
        p = self.plain_op
        return idx.stiffness_apply_indexed(x, p.G, None, p.dofmap, p.D,
                                           self.ndofs)

    def pair(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        if self.impl == "cuda":
            return ci.indexed_pair(self.cell_op, x1, x2)
        p = self.plain_op
        return idx.stiffness_apply_indexed_pair(x1, p.c1, x2, p.c2, p.G,
                                                p.dofmap, p.D, self.ndofs)


class CornerStiffness(nn.Module):
    """The corner-streamed operator (the capacity mode) of a box or an
    extruded mesh as buffers: the per-cell channels and what the kernel
    reads beside them, never a metric.  'cuda' runs the corner kernels
    (`cc.corner` on a box, `cc.extruded_corner` otherwise); 'mm' runs their
    plain version, which expands the channels into the metric at each
    apply: ``CornerStiffness(op.cell_op, "mm")`` is the plain version of a
    kernel-layout operator `op`, with the same numbers.  `forward(x)` is the
    single-field apply, `pair(x1, x2)` the two-field one; both take and
    return grid-shaped tensors on a box and flat ones otherwise."""

    def __init__(self, op: cc.CornerCellStiffness, impl: str):
        super().__init__()
        self.impl = impl
        self.is_pair = op.C is not None
        self.geom_deg, self.nc = op.geom_deg, op.nc
        self.nz, self.n2d, self.bounds = op.nz, op.n2d, op.bounds
        for name in ("T", "D", "Q", "rows", "cells", "C"):
            self.register_buffer(name, getattr(op, name))

    @property
    def cell_op(self) -> cc.CornerCellStiffness:
        return cc.CornerCellStiffness(
            T=self.T, D=self.D, Q=self.Q, geom_deg=self.geom_deg, nc=self.nc,
            rows=self.rows, nz=self.nz, n2d=self.n2d, cells=self.cells,
            bounds=self.bounds, C=self.C)

    @property
    def kernel(self) -> str | None:
        """The launch counter that an apply moves (None for 'mm')."""
        if self.impl != "cuda":
            return None
        return self.cell_op.kernel + ("_pair" if self.is_pair else "")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        op = self.cell_op
        if self.impl != "cuda":
            return cc.corner_plain(op, x)
        return cc.corner(op, x) if op.box else cc.extruded_corner(op, x)

    def pair(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        op = self.cell_op
        if self.impl != "cuda":
            return cc.corner_pair_plain(op, x1, x2)
        if op.box:
            return cc.corner_pair(op, x1, x2)
        return cc.extruded_corner_pair(op, x1, x2)


def launch_counts() -> dict:
    """Every stiffness kernel's launch counter, by name (a copy)."""
    return {**cs.launches, **ce.launches, **ci.launches, **cc.launches}


def stiffness_module(op, impl: str) -> nn.Module:
    """The stiffness module for a kernel-layout operator of any mesh
    kind."""
    if isinstance(op, cc.CornerCellStiffness):
        return CornerStiffness(op, impl)
    if isinstance(op, ce.ExtrudedCellStiffness):
        return ExtrudedStiffness(op, impl)
    if isinstance(op, ci.IndexedCellStiffness):
        return IndexedStiffness(op, impl)
    return StructuredStiffness(op, impl)
