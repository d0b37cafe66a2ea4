"""Spectral-element discretization of a structured box mesh or an
imported (prismatic or general) hex mesh: the float64 set-up (geometry,
facet blocks and diagonal assembly), on the card with the set-up kernels
(``ops/cuda_setup``) for a discretisation there, on the host in numpy (the
plain versions) otherwise, and the stiffness operator on the device.

With GLL collocation every mass-type operator (cell or facet) is globally
diagonal, so each fixed coefficient field yields a precomputed diagonal
vector and an apply is one elementwise multiply (`mass_diag` /
`facet_diag`).  The stiffness operator is `StructuredStiffness` on a
box mesh, `ExtrudedStiffness` on an `ExtrudedHexMesh` and
`IndexedStiffness` on any other `UnstructuredHexMesh`: the CUDA kernels on
a CUDA device, or their plain torch versions.  In the corner-streamed
capacity mode (``stiffness_impl="pallas_corner"``) a box or an extruded mesh
takes `CornerStiffness` instead, built from the cell corners (or the hex27
lattice) without the host metric.  ``stiffness_impl="indexed_engine"`` gives
any imported mesh, extruded or not, `EngineStiffness`: the staged gather /
contract / scatter engine, and ``stiffness_impl="indexed"`` gives any mesh, a
box too, `IndexedStiffness`, as the JAX package routes that name.
Counterpart of
``fustpu/models/discretization.py`` without its TPU-only parts.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from fustpu_torch.mesh.extruded import ExtrudedHexMesh
from fustpu_torch.ops import cuda_corner as cc
from fustpu_torch.ops import cuda_engine as cen
from fustpu_torch.ops import cuda_extruded as ce
from fustpu_torch.ops import cuda_indexed as ci
from fustpu_torch.ops import cuda_setup as setup
from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.ops import engine as eng
from fustpu_torch.ops import extruded as ext
from fustpu_torch.ops import indexed as idx
from fustpu_torch.ops import precompute as pre
from fustpu_torch.ops import spectral_mm as mm

# The names of the corner-streamed capacity mode (the JAX package's).
CORNER_IMPLS = ("pallas_corner", "extruded_pallas_corner")
# The staged engine's name (the JAX package's), for imported meshes.
ENGINE_IMPL = "indexed_engine"
# The indexed kernel's name (the JAX package's): it takes any mesh.
INDEXED_IMPL = "indexed"
# The JAX package's names of its TPU kernels ('pallas' on a box,
# 'extruded_pallas' on a prismatic import) and of its plain extruded
# einsums ('extruded'), resolved as that package resolves them.
KERNEL_IMPLS = ("pallas", "extruded_pallas")
EXTRUDED_PLAIN_IMPL = "extruded"


class FacetBlock(NamedTuple):
    """A set of boundary facets with geometry factors: host arrays, or
    tensors on the card for a discretisation there."""

    cells: np.ndarray                  # (nf,) owning cell (host)
    dofmap: np.ndarray | torch.Tensor  # (nf, n^2) flat global node indices
    detJ: np.ndarray | torch.Tensor    # (nf, n^2) float64

    @property
    def num_facets(self) -> int:
        return self.cells.shape[0]


class Discretization:
    """Geometry factors and facet machinery for one box mesh or imported
    (unstructured) mesh, set up on `device`: with the set-up kernels on a
    CUDA device (tensors there, never a host pass over the cells), in
    float64 numpy on the CPU (host arrays)."""

    def __init__(self, mesh, device="cpu"):
        self.mesh = mesh
        self.P = mesh.degree
        self.structured = hasattr(mesh, "nc")
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        # seconds of the set-up steps on the host clock, by name
        # (geometry, mass, facets), as they run (the card's work included)
        self.host_seconds = {}
        self._D_host = mesh.element.deriv_1d
        with self._timed("geometry"):
            if self.on_card:
                self._card = setup.CardGeometry(mesh, self.device)
            else:
                self._detJ_host = pre.cell_detJ(mesh)      # (cells, n^3)

    @contextlib.contextmanager
    def _timed(self, step: str):
        """Add the seconds of the block to `host_seconds[step]` (after the
        card's queue drains, on the card)."""
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.host_seconds[step] = (self.host_seconds.get(step, 0.0)
                                   + time.perf_counter() - t0)

    @functools.cached_property
    def _G_host(self) -> np.ndarray:
        """(cells, n^3, 6) metric factors, float64 host, on first use
        (never in the corner mode: 48 B per node, the largest host array of
        the set-up): the mesh's `cell_metric`, computed once per mesh, so a
        second model of the same mesh reuses it; on the card, the card's
        metric brought to the host (what the sharded models cut into
        parts, also in a rank that loaded the model onto the CPU)."""
        with self._timed("geometry"):
            if self.on_card:
                return self._card.to(self.device).metric().cpu().numpy()
            return self.mesh.cell_metric

    def _metric(self):
        """G (cells, n^3, 6) float64: computed on the card there (not kept:
        the stiffness operator holds its own copy), the host array
        otherwise."""
        if not self.on_card:
            return self._G_host
        with self._timed("geometry"):
            return self._card.metric()

    @functools.cached_property
    def chunk_plan(self) -> ci.ChunkPlan:
        """The indexed kernels' schedules' host part on this mesh (its
        chunk tables and colourings, built on first use): the imported
        mesh's own, shared by every model built on it, or on a box mesh
        this discretisation's."""
        plan = getattr(self.mesh, "chunk_plan", None)
        return plan or ci.ChunkPlan(self.mesh.dofmap, self.mesh.ndofs)

    @functools.cached_property
    def stack_plan(self) -> ce.StackPlan:
        """The extruded kernels' schedules' host part on this extruded
        mesh (its stack colouring), shared by every extruded operator of
        this mesh."""
        return ce.StackPlan(self.mesh.rows2d, self.mesh.nz)

    # ---- facets -----------------------------------------------------------
    def facet_block(self, boundary_data: np.ndarray) -> FacetBlock:
        """The (cell, local facet) pairs' dofs and geometry factors; on the
        card the facet cells' dofmap rows (`cuda_setup.box_dofmap` on a
        box) and `cuda_setup.facet_geometry`."""
        bd = np.asarray(boundary_data, np.int64).reshape(-1, 2)
        with self._timed("facets"):
            if not self.on_card:
                return FacetBlock(
                    cells=bd[:, 0].copy(), dofmap=self.mesh.facet_dofmap(bd),
                    detJ=pre.facet_geometry_factors(self.mesh, bd))
            dofmap = (setup.box_facet_dofmap(self.mesh, bd, self.device)
                      if self.structured else torch.as_tensor(
                          self.mesh.facet_dofmap(bd).astype(np.int64),
                          device=self.device))
            return FacetBlock(
                cells=bd[:, 0].copy(), dofmap=dofmap,
                detJ=setup.mesh_facet_geometry(self.mesh, bd, self.device))

    def facet_points(self, block: FacetBlock) -> np.ndarray:
        """(nf, n^2, 3) physical coordinates of facet nodes."""
        dofmap = block.dofmap
        if isinstance(dofmap, torch.Tensor):
            dofmap = dofmap.cpu().numpy()
        return self.mesh.node_coords.reshape(-1, 3)[dofmap]

    # ---- float64 diagonal assembly ----------------------------------------
    def _card_f64(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a, np.float64),
                               device=self.device)

    def mass_diag(self, cell_coeff=None):
        """Global diagonal of the mass operator for a per-cell coefficient
        field, float64, grid-shaped (flat (ndofs,) on an unstructured
        mesh): a tensor on the card from the set-up kernels (detJ, then
        `mass_diagonal_box` on a box, `mass_diagonal_map` through the
        dofmap's inverse map otherwise), `mass_diag_host` on the CPU."""
        with self._timed("mass"):
            if not self.on_card:
                return self.mass_diag_host(cell_coeff)
            coeff = (None if cell_coeff is None else
                     self._card_f64(np.asarray(cell_coeff).reshape(-1)))
            detJ = self._card.detJ()
            if self.structured:
                return setup.mass_diagonal_box(detJ, coeff, self.mesh.nc,
                                               self.P)
            pos, ptr = setup.inverse_map(
                torch.as_tensor(self.mesh.dofmap, device=self.device),
                self.mesh.ndofs)
            return setup.mass_diagonal_map(detJ.reshape(-1), coeff,
                                           detJ.shape[1], pos, ptr)

    def facet_diag(self, block: FacetBlock, facet_coeff,
                   node_weights: np.ndarray | None = None):
        """`facet_diag_host` of the block, as a float64 tensor on the card
        (the values' sum through the facet dofmap's inverse map,
        `mass_diagonal_map`, in the host version's order) or a host array
        on the CPU."""
        with self._timed("facets"):
            if not self.on_card:
                return self.facet_diag_host(block, facet_coeff, node_weights)
            vals = block.detJ * self._card_f64(facet_coeff)[:, None]
            if node_weights is not None:
                vals = vals * self._card_f64(node_weights)
            pos, ptr = setup.inverse_map(block.dofmap, self.mesh.ndofs)
            y = setup.mass_diagonal_map(vals.reshape(-1), None,
                                        vals.shape[1], pos, ptr)
            return y.reshape(self.mesh.grid_shape)

    # ---- host-side float64 diagonal assembly (the plain versions) --------
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
        vals = block.detJ * np.asarray(facet_coeff)[:, None]
        if node_weights is not None:
            vals = vals * node_weights
        y = np.zeros(self.mesh.ndofs)
        np.add.at(y, block.dofmap.ravel(), vals.ravel())
        return y.reshape(self.mesh.grid_shape)

    # ---- stiffness --------------------------------------------------------
    def stiffness_op(self, dtype: torch.dtype, device, coeff=None,
                     pair=None, corner: bool = False, engine: bool = False,
                     indexed: bool = False):
        """The stiffness operator in the kernel layout, on `device`
        (`cs.CellStiffness` on a box mesh, `ce.ExtrudedCellStiffness` on
        an extruded one, `ci.IndexedCellStiffness` on any other imported
        mesh): `coeff` (per-cell) is folded into G; `pair` = (c1, c2)
        per-cell fields makes a unit-G pair operator.  `corner`: the
        corner-streamed `cc.CornerCellStiffness` on a box or extruded mesh,
        built without the host metric; a general mesh has no corner form
        and takes the indexed operator, as the JAX package routes it.
        `engine`: the staged engine's `cen.EngineCellStiffness` on any
        imported mesh (its `coeff` stays a per-cell coefficient).
        `indexed`: `ci.IndexedCellStiffness` on any mesh, a box or an
        extruded one too (the JAX package's ``stiffness_impl="indexed"``)."""
        extruded = isinstance(self.mesh, ExtrudedHexMesh)
        if engine and self.structured:
            raise ValueError(f"stiffness_impl={ENGINE_IMPL!r} needs an "
                             "imported mesh (a box mesh runs the "
                             "structured kernels)")
        if corner and (self.structured or extruded) and not engine:
            t0 = time.perf_counter()
            build = cc.build_extruded if extruded else cc.build_box
            op = build(self.mesh, self._D_host, dtype, device, coeff=coeff,
                       pair=pair)
            self.host_seconds["channels"] = time.perf_counter() - t0
            return op
        G = self._metric()
        if engine:
            return cen.build(self.mesh, G, self._D_host, dtype, device,
                             coeff=coeff, pair=pair)
        if indexed or not (self.structured or extruded):
            return ci.build(self.mesh, G, self._D_host, dtype, device,
                            coeff=coeff, pair=pair, plan=self.chunk_plan)
        if extruded:
            return ce.build(self.mesh, G, self._D_host, dtype, device,
                            coeff=coeff, pair=pair, plan=self.stack_plan)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        C = None
        if pair is not None:
            C = t(np.stack([np.broadcast_to(np.asarray(c, np.float64),
                                            self.mesh.nc).reshape(-1)
                            for c in pair], axis=1))
        return cs.CellStiffness(G=t(cs.pack_G(G, coeff)),
                                D=t(self._D_host), nc=tuple(self.mesh.nc),
                                C=C)


def resolve_stiffness_impl(impl: str, device, mesh=None,
                           dtype: torch.dtype | None = None) -> str:
    """'auto' is the CUDA kernel on a CUDA device and the plain torch
    version elsewhere; 'mm' forces the plain version (on any mesh kind).
    The corner-mode names (CORNER_IMPLS), ENGINE_IMPL and INDEXED_IMPL
    resolve as 'auto' does: they choose the operator
    (`Discretization.stiffness_op(corner=True)`, `(engine=True)` or
    `(indexed=True)`), the device chooses kernel or plain version.

    The JAX package's kernel names (KERNEL_IMPLS) resolve as 'auto' too,
    and 'extruded' as 'mm' on a prismatic import; on a general import
    that package runs its indexed operator for either, which 'auto' is
    here.  It fails for 'extruded' and 'extruded_pallas' on a box mesh,
    and so do these: they need the `mesh` to resolve.

    Every name resolves a bfloat16 `dtype` as it resolves float32: the
    G-stream operators (#1 / #2, #6, #11), the corner mode on a box, a
    mapped box or a prismatic import, hex8 and hex27 (#3 and #6c), and the
    staged engine (#7-#10) each have a bfloat16 form, and so do their
    plain versions."""
    if impl == "mm":
        return "mm"
    if impl in (EXTRUDED_PLAIN_IMPL, "extruded_pallas"):
        if mesh is None or hasattr(mesh, "nc"):
            raise ValueError(f"stiffness_impl={impl!r} needs an imported "
                             "mesh: expected 'auto', 'pallas' or 'mm' on a "
                             "box mesh")
        if impl == EXTRUDED_PLAIN_IMPL and isinstance(mesh, ExtrudedHexMesh):
            return "mm"
    elif not (impl in ("auto", ENGINE_IMPL, INDEXED_IMPL, "pallas")
              or impl in CORNER_IMPLS):
        raise ValueError(f"stiffness_impl={impl!r}: expected 'auto', 'mm', "
                         f"{ENGINE_IMPL!r}, {INDEXED_IMPL!r}, one of "
                         f"{CORNER_IMPLS} or of the JAX package's "
                         f"{KERNEL_IMPLS + (EXTRUDED_PLAIN_IMPL,)}")
    return "cuda" if torch.device(device).type == "cuda" else "mm"


def bf16_name(kernel: str, G: torch.Tensor, lean: bool = True) -> str:
    """The launch counter of a kernel for operator data G (the G stream,
    or the corner channels): its bfloat16 form's on bfloat16 data
    (``cuda_stiffness.bf16_key``: `kernel`_bf16, or where a G-stream walk
    keeps the first bfloat16 walk, not `lean`, `kernel`_bf16_first_walk)."""
    if G.dtype != torch.bfloat16:
        return kernel
    return cs.bf16_key(kernel, lean)


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
        return bf16_name("stiffness_pair" if self.is_pair else "stiffness",
                         self.G, cs.lean_runs(self.D.shape[0] - 1,
                                              self.is_pair, self.G.dtype))

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
        self.nz, self.n2d, self.plan = op.nz, op.n2d, op.plan
        self.ndofs = op.ndofs
        self.is_pair = op.C is not None
        if impl == "cuda":
            for name in ("G", "D", "rows", "C"):
                self.register_buffer(name, getattr(op, name))
            if op.G.is_cuda:         # the schedule, at set-up
                op.plan.card(op.P, op.G.dtype, self.is_pair, op.G.device)
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
        return bf16_name("extruded_pair" if self.is_pair else "extruded",
                         self.G, ce.lean_runs(self.D.shape[0] - 1,
                                              self.G.dtype))

    @property
    def cell_op(self) -> ce.ExtrudedCellStiffness:
        return ce.ExtrudedCellStiffness(
            G=self.G, D=self.D, rows=self.rows, nz=self.nz, n2d=self.n2d,
            plan=self.plan, C=self.C)

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
    and return flat tensors (or grid-shaped ones on a box mesh, which the
    JAX package's ``stiffness_impl="indexed"`` also runs)."""

    def __init__(self, op: ci.IndexedCellStiffness, impl: str):
        super().__init__()
        self.impl = impl
        self.ndofs, self.plan = op.ndofs, op.plan
        self.is_pair = op.C is not None
        if impl == "cuda":
            for name in ("G", "D", "dofmap", "C"):
                self.register_buffer(name, getattr(op, name))
            if op.G.is_cuda:         # the chunk tables, at set-up
                op.plan.card(op.P, op.G.dtype, self.is_pair, op.G.device,
                             design=ci.design(op.P, self.is_pair, op.G.dtype))
        else:
            plain = ci.to_plain(op)
            for name in ci.PlainIndexed._fields:
                self.register_buffer(f"plain_{name}", getattr(plain, name))

    @property
    def kernel(self) -> str | None:
        """The launch counter that an apply moves (None for 'mm')."""
        if self.impl != "cuda":
            return None
        return bf16_name("indexed_pair" if self.is_pair else "indexed",
                         self.G, ci.lean_runs(self.D.shape[0] - 1,
                                              self.is_pair, self.G.dtype))

    @property
    def cell_op(self) -> ci.IndexedCellStiffness:
        return ci.IndexedCellStiffness(
            G=self.G, D=self.D, dofmap=self.dofmap, ndofs=self.ndofs,
            plan=self.plan, C=self.C)

    def scatter_summary(self) -> str:
        """The scatter design: on the card the chunk kernel's classes,
        chunks and grid; in the plain version (no kernel, no classes) the
        cells' colour classes of the class-launch design."""
        if self.impl == "cuda" and self.G.is_cuda:
            s = self.plan.card(self.P, self.G.dtype, self.is_pair,
                               self.G.device, design=ci.design(
                                   self.P, self.is_pair, self.G.dtype))[0]
            return (f"{len(s.classes)} colour classes of "
                    f"{len(s.chunks)} chunks of {s.cpb} cells (at most "
                    f"{int(s.classes[:, 1].max())} a class), {s.blocks} "
                    f"blocks ({s.blocks_per_sm} an SM)")
        return (f"{len(self.plan.classes[1]) - 1} colour classes over "
                f"{self.plan.cells} cells (the class-launch colouring)")

    @property
    def P(self) -> int:
        return (self.D if self.impl == "cuda" else self.plain_D).shape[0] - 1

    @property
    def plain_op(self) -> ci.PlainIndexed:
        return ci.PlainIndexed(*(getattr(self, f"plain_{name}")
                                 for name in ci.PlainIndexed._fields))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape, x = x.shape, x.reshape(-1)
        if self.impl == "cuda":
            return ci.indexed(self.cell_op, x).reshape(shape)
        p = self.plain_op
        return idx.stiffness_apply_indexed(x, p.G, None, p.dofmap, p.D,
                                           self.ndofs).reshape(shape)

    def pair(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        shape, x1, x2 = x1.shape, x1.reshape(-1), x2.reshape(-1)
        if self.impl == "cuda":
            return ci.indexed_pair(self.cell_op, x1, x2).reshape(shape)
        p = self.plain_op
        return idx.stiffness_apply_indexed_pair(
            x1, p.c1, x2, p.c2, p.G, p.dofmap, p.D, self.ndofs
        ).reshape(shape)


class CornerStiffness(nn.Module):
    """The corner-streamed operator (the capacity mode) of a box or an
    extruded mesh as buffers: the per-cell channels and what the kernel
    reads beside them, never a metric.  'cuda' runs the corner kernels
    (`cc.corner` on a box, `cc.extruded_corner` otherwise: the walk of box
    pencils or of stacks, its schedule built at set-up); 'mm' runs their
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
        self.plan = op.plan
        for name in ("T", "D", "Q", "rows", "cells", "C"):
            self.register_buffer(name, getattr(op, name))
        if impl == "cuda" and op.T.is_cuda:      # the schedule, at set-up
            cc.card_schedule(op, op.T, self.is_pair)

    @property
    def cell_op(self) -> cc.CornerCellStiffness:
        return cc.CornerCellStiffness(
            T=self.T, D=self.D, Q=self.Q, geom_deg=self.geom_deg, nc=self.nc,
            rows=self.rows, nz=self.nz, n2d=self.n2d, cells=self.cells,
            bounds=self.bounds, C=self.C, plan=self.plan)

    @property
    def kernel(self) -> str | None:
        """The launch counter that an apply moves (None for 'mm')."""
        if self.impl != "cuda":
            return None
        op = self.cell_op
        return bf16_name(op.kernel + ("_pair" if self.is_pair else ""),
                         self.T, cc.lean_runs(op, self.is_pair, self.T.dtype))

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


class EngineStiffness(nn.Module):
    """The staged engine as buffers in the layout its implementation
    reads: the kernel layout for 'cuda' (three launches per apply:
    `cen.engine`, `cen.engine_pair`), the plain layout of
    ``fustpu_torch.ops.engine`` for 'mm'.  ``EngineStiffness(op.cell_op,
    "mm")`` is the plain version of a kernel-layout operator `op`, with the
    same numbers.  `forward(x)` is the single-field apply (with the
    operator's per-cell coefficient, if any), `pair(x1, x2)` the two-field
    one; both take and return flat tensors."""

    def __init__(self, op: cen.EngineCellStiffness, impl: str):
        super().__init__()
        self.impl = impl
        self.ndofs = op.ndofs
        self.is_pair = op.C is not None
        if impl == "cuda":
            for name in cen.EngineCellStiffness._fields:
                if name != "ndofs":
                    self.register_buffer(name, getattr(op, name))
        else:
            plain = cen.to_plain(op)
            for name in cen.PlainEngine._fields:
                self.register_buffer(f"plain_{name}", getattr(plain, name))

    @property
    def kernel(self) -> str | None:
        """The name of the composed apply (None for 'mm'): 'engine', or
        'engine_bf16' on bfloat16 data; its three kernels count their own
        launches (`kernels`)."""
        return bf16_name("engine", self.G) if self.impl == "cuda" else None

    @property
    def kernels(self) -> tuple[str, ...]:
        """The launch counters that one apply moves (none for 'mm')."""
        if self.impl != "cuda":
            return ()
        return cen.kernels(self.G.dtype, self.is_pair)

    @property
    def cell_op(self) -> cen.EngineCellStiffness:
        return cen.EngineCellStiffness(
            G=self.G, D=self.D, dofmap=self.dofmap, ndofs=self.ndofs,
            pos=self.pos, ptr=self.ptr, coeff=self.coeff, C=self.C)

    @property
    def plain_op(self) -> cen.PlainEngine:
        return cen.PlainEngine(*(getattr(self, f"plain_{name}")
                                 for name in cen.PlainEngine._fields))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.impl == "cuda":
            return cen.engine(self.cell_op, x)
        p = self.plain_op
        return eng.stiffness_apply_engine(x, p.G6, p.coeff, p.g, p.D,
                                          self.ndofs)

    def pair(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        if self.impl == "cuda":
            return cen.engine_pair(self.cell_op, x1, x2)
        p = self.plain_op
        return eng.stiffness_apply_engine_pair(x1, p.c1, x2, p.c2, p.G6,
                                               p.g, p.D, self.ndofs)


def launch_counts() -> dict:
    """Every stiffness kernel's launch counter, by name (a copy)."""
    return {**cs.launches, **cs.bf16_launches, **ce.launches,
            **ce.class_launches, **ce.bf16_launches, **ci.launches,
            **ci.class_launches, **ci.bf16_launches, **cc.launches,
            **cc.class_launches, **cc.bf16_launches,
            **cen.launches, **cen.bf16_launches,
            **cen.comparison_launches}


def stiffness_module(op, impl: str) -> nn.Module:
    """The stiffness module for a kernel-layout operator of any mesh
    kind."""
    if isinstance(op, cc.CornerCellStiffness):
        return CornerStiffness(op, impl)
    if isinstance(op, cen.EngineCellStiffness):
        return EngineStiffness(op, impl)
    if isinstance(op, ce.ExtrudedCellStiffness):
        return ExtrudedStiffness(op, impl)
    if isinstance(op, ci.IndexedCellStiffness):
        return IndexedStiffness(op, impl)
    return StructuredStiffness(op, impl)
