"""Sharded wave models on imported meshes: one rank's part of a model on an
`ExtrudedHexMesh` (stacks of prisms) or on any other `UnstructuredHexMesh`.

The cells are partitioned by recursive coordinate bisection
(`rcb_partition`): the stacks of an extruded mesh by their 2D footprint
centroids, the cells of a general mesh by their centroids.  A rank holds
its part's rows (extruded: 2D rows, z structured along each) or DOFs in
ascending global order; rows or DOFs cut by the partition live on every
rank that touches them.  After the local stiffness apply, ONE
``all_reduce`` of a compact shared-entry buffer (slot per shared row or
DOF; each rank writes its own contributions, zeros elsewhere) sums them,
and every owner writes the sum back: the shared entries are then
consistent, so every diagonal term commutes with the exchange and is added
after it, one exchange per RK stage.

Counterpart of ``fustpu/parallel/extruded.py``.  A rank needs no common
shape with the others, so the JAX package's dead-id padding of stacks,
cells and rows is not ported.  Per rank the stiffness is the port's
extruded kernels (G stream or corner-streamed), the indexed kernel, or the
staged engine (``stiffness_impl="indexed_engine"``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fustpu_torch.mesh.extruded import ExtrudedHexMesh
from fustpu_torch.mesh.unstructured import UnstructuredHexMesh, UPointSampler
from fustpu_torch.models import timestepping
from fustpu_torch.models.discretization import (ENGINE_IMPL,
                                                EngineStiffness,
                                                stiffness_module)
from fustpu_torch.ops import corner as cn
from fustpu_torch.ops import cuda_corner as cc
from fustpu_torch.ops import cuda_engine as cen
from fustpu_torch.ops import cuda_extruded as ce
from fustpu_torch.ops import cuda_indexed as ci
from fustpu_torch.parallel import sharding as sh
from fustpu_torch.parallel.models import (Exchanged, RankPart,
                                          host_vectors, local_model,
                                          sharded_impl,
                                          stiffness_coefficients,
                                          wants_corner)


def rcb_partition(points: np.ndarray, k: int) -> np.ndarray:
    """Recursive coordinate bisection into k near-equal parts (any k):
    split along the widest axis at the proportional quantile."""
    points = np.asarray(points, np.float64)
    part = np.zeros(points.shape[0], np.int64)

    def rec(idx, k0, base):
        if k0 == 1:
            part[idx] = base
            return
        k1 = k0 // 2
        pts = points[idx]
        ax = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        order = np.argsort(pts[:, ax], kind="stable")
        cut = int(round(len(idx) * k1 / k0))
        rec(idx[order[:cut]], k1, base)
        rec(idx[order[cut:]], k0 - k1, base + k1)

    rec(np.arange(points.shape[0]), k, 0)
    return part


@dataclasses.dataclass(frozen=True)
class LocalRows:
    """What a rank's operator and local model read of its part of an
    imported mesh: the flat field size and, for an extruded part, its
    local row ids, layers and geometry nodes (None for hex8)."""

    ndofs: int
    rows2d: np.ndarray | None = None
    nz: int = 0
    n2d: int = 0
    geom_nodes: np.ndarray | None = None

    @property
    def grid_shape(self) -> tuple[int]:
        return (self.ndofs,)


class _ShardedUnstructured(RankPart):
    """What the extruded and the general sharded models share: the
    shared-entry exchange and the probes.  A subclass calls
    `_setup_exchange` with each rank's global ids (ascending: rows or
    DOFs) and sets `width` (values per id: gz or 1), `nglobal` (the number
    of ids) and `local`."""

    def _setup_exchange(self, ids: list[np.ndarray], nglobal: int) -> None:
        self.ids = ids
        counts = np.bincount(np.concatenate(ids), minlength=nglobal)
        shared = np.flatnonzero(counts > 1)
        self.num_shared = shared.size
        slot_of = np.full(nglobal, -1, np.int64)
        slot_of[shared] = np.arange(shared.size)
        slots = slot_of[ids[self.grid.rank]]
        own = np.flatnonzero(slots >= 0)
        dev = self.grid.device
        self._sh_local = torch.as_tensor(own, device=dev)
        self._sh_slot = torch.as_tensor(slots[own], device=dev)
        self.weights = torch.as_tensor(np.repeat(
            1.0 / counts[ids[self.grid.rank]], self.width), device=dev)

    @property
    def nloc(self) -> int:
        return self.ids[self.grid.rank].size

    def _entries(self, field: np.ndarray, rank: int) -> np.ndarray:
        return field.reshape(-1, self.width)[self.ids[rank]].reshape(-1)

    def _merge(self, blocks) -> np.ndarray:
        out = np.zeros((self.nglobal, self.width), blocks[0].dtype)
        for ids, b in zip(self.ids, blocks):
            out[ids] = b.reshape(-1, self.width)
        return out.reshape(-1)

    def exchange(self, y: torch.Tensor) -> torch.Tensor:
        """Sum the rank's shared rows or DOFs of a stiffness output across
        their owners, in place (one all_reduce)."""
        if self.num_shared == 0:
            return y
        y2 = y.view(self.nloc, self.width)
        buf = torch.zeros((self.num_shared, self.width), dtype=y.dtype,
                          device=y.device)
        buf[self._sh_slot] = y2[self._sh_local]
        self.grid.all_reduce(buf)
        y2[self._sh_local] = buf[self._sh_slot]
        return y

    def probe_fn(self, points):
        """A per-step sampler (UPointSampler semantics): each point lies in
        one cell, hence on at least one rank; the lowest rank holding all
        of its cell's entries contributes, and an all_reduce gives every
        rank the full trace."""
        smp = UPointSampler(self.mesh, points)
        gid, sub = np.divmod(smp._dofs.astype(np.int64), self.width)
        owner = np.full(gid.shape[0], -1, np.int64)
        for r in range(self.grid.size - 1, -1, -1):
            ids = self.ids[r]
            pos = np.minimum(np.searchsorted(ids, gid), ids.size - 1)
            owner[(ids[pos] == gid).all(axis=1)] = r
        if (owner < 0).any():
            raise ValueError("a probe point's cell lies on no single rank")
        ids = self.ids[self.grid.rank]
        pos = np.minimum(np.searchsorted(ids, gid), ids.size - 1)
        dev = self.grid.device
        ldofs = torch.as_tensor(pos * self.width + sub, device=dev)
        own = torch.as_tensor(owner == self.grid.rank, device=dev)
        w = torch.as_tensor(smp._w, device=dev)

        def probe(s: timestepping.RKState) -> torch.Tensor:
            f = s.u.reshape(-1)
            p = (f[ldofs] * w.to(f.dtype)).sum(dim=1)
            p = torch.where(own, p, torch.zeros_like(p))
            return self.grid.all_reduce(p)

        return probe


class ExtrudedShardedModel(_ShardedUnstructured):
    """One rank's part of a model on an ExtrudedHexMesh: an RCB partition
    of the stacks, the rank's 2D rows (z structured along each) and the
    extruded kernels per rank (the G stream, or the corner-streamed kernels
    when the model runs them or `stiffness_impl="pallas_corner"`)."""

    def __init__(self, model, grid: sh.RankGrid, stiffness_impl=None):
        mesh = model.mesh
        if not isinstance(mesh, ExtrudedHexMesh):
            raise TypeError("ExtrudedShardedModel needs an ExtrudedHexMesh "
                            "(IndexedShardedModel takes a general mesh)")
        self.model, self.grid, self.mesh = model, grid, mesh
        self.width, self.nglobal = mesh.gz, mesh.n2d
        tr = [a for a in range(3) if a != mesh.axis]
        cent = mesh.vertices[mesh.cells[mesh.stack_cells[:, 0]]][
            :, :, tr].mean(axis=1)
        part = rcb_partition(cent, grid.size)
        stacks_of = [np.flatnonzero(part == r) for r in range(grid.size)]
        if min(s.size for s in stacks_of) == 0:
            raise ValueError(f"empty partition with {grid.size} ranks")
        self._setup_exchange([np.unique(mesh.rows2d[s]) for s in stacks_of],
                             mesh.n2d)
        mine = stacks_of[grid.rank]
        rows_local = np.searchsorted(self.ids[grid.rank], mesh.rows2d[mine])
        part_mesh = LocalRows(ndofs=self.nloc * mesh.gz, rows2d=rows_local,
                              nz=mesh.nz, n2d=self.nloc,
                              geom_nodes=mesh.geom_nodes)
        cells = mesh.stack_cells[mine].reshape(-1)   # local stack order
        self.corner = wants_corner(model, stiffness_impl)
        coeff, pair = stiffness_coefficients(model)
        cell = lambda c: np.broadcast_to(np.asarray(c, np.float64).reshape(
            -1), (mesh.num_cells,))
        C = None if pair is None else np.stack(
            [cell(c)[cells] for c in pair], axis=1)
        dtype, dev = model.dtype, grid.device
        D = model.disc._D_host
        if self.corner:
            T = cn.corner_stream(mesh, None if coeff is None else cell(coeff))
            T = T[mine].reshape(-1, T.shape[2])
            op = cc.from_host_extruded(part_mesh, T, D, dtype, dev, C)
        else:
            G = np.moveaxis(model.disc._G_host[cells], 2, 1)
            if coeff is not None:
                G = G * cell(coeff)[cells][:, None, None]
            op = ce.from_host(part_mesh, np.ascontiguousarray(G), D, dtype,
                              dev, C)
        inner = stiffness_module(op, "cuda" if dev.type == "cuda" else "mm")
        vectors = {k: None if v is None else self.block(v)
                   for k, v in host_vectors(model).items()}
        self.local = local_model(model, part_mesh,
                                 Exchanged(inner, self.exchange), vectors,
                                 dev)


class IndexedShardedModel(_ShardedUnstructured):
    """One rank's part of a model on any imported mesh through an explicit
    local dofmap: an RCB partition of the cells, the rank's DOFs, and per
    rank the indexed kernel (`stiffness_impl` 'auto' or 'indexed') or the
    staged engine ('indexed_engine')."""

    def __init__(self, model, grid: sh.RankGrid, stiffness_impl: str = "auto"):
        mesh = model.mesh
        if not isinstance(mesh, UnstructuredHexMesh):
            raise TypeError("IndexedShardedModel needs an imported mesh (use "
                            "ShardedModel for box meshes)")
        stiffness_impl = sharded_impl(stiffness_impl)
        if stiffness_impl not in ("auto", "indexed", ENGINE_IMPL):
            raise ValueError(f"stiffness_impl={stiffness_impl!r}: expected "
                             f"'auto', 'indexed' or {ENGINE_IMPL!r}")
        self.model, self.grid, self.mesh = model, grid, mesh
        self.width, self.nglobal = 1, mesh.ndofs
        self.engine = stiffness_impl == ENGINE_IMPL
        cells_of, ids = indexed_parts(mesh, grid.size)
        self._setup_exchange(ids, mesh.ndofs)
        cells = cells_of[grid.rank]
        coeff, pair = stiffness_coefficients(model)
        cell = lambda c: np.broadcast_to(np.asarray(c, np.float64).reshape(
            -1), (mesh.num_cells,))[cells]
        coeff = None if coeff is None else cell(coeff)
        C = None if pair is None else np.stack([cell(c) for c in pair], 1)
        dev = grid.device
        op = part_operator(mesh, model.disc._G_host, model.disc._D_host,
                           cells, ids[grid.rank], model.dtype, dev,
                           self.engine, coeff, C)
        inner = stiffness_module(op, "cuda" if dev.type == "cuda" else "mm")
        vectors = {k: None if v is None else self.block(v)
                   for k, v in host_vectors(model).items()}
        self.local = local_model(model, LocalRows(ndofs=self.nloc),
                                 Exchanged(inner, self.exchange), vectors,
                                 dev)


def indexed_parts(mesh, k: int) -> tuple[list, list]:
    """(cells, DOFs) of each of the k parts of a general mesh: an RCB
    partition of the cell centroids, and each part's global DOFs in
    ascending order (its local numbering)."""
    part = rcb_partition(mesh.cell_corners_flat.mean(axis=1), k)
    cells_of = [np.flatnonzero(part == r) for r in range(k)]
    if min(c.size for c in cells_of) == 0:
        raise ValueError(f"empty partition with {k} ranks")
    return cells_of, [np.unique(mesh.dofmap[c]) for c in cells_of]


def part_operator(mesh, G_host: np.ndarray, D: np.ndarray,
                  cells: np.ndarray, ids: np.ndarray, dtype: torch.dtype,
                  device, engine: bool = False, coeff=None, C=None):
    """The stiffness operator of one part (`cells`, its DOFs `ids`) on its
    own local dofmap, with the part's own chunk plan or inverse map: the
    staged engine's (`engine`; `coeff` stays a per-cell coefficient) or
    the indexed kernel's (`coeff` folded into G); `C` (cells, 2) the pair
    coefficients."""
    ldm = np.searchsorted(ids, mesh.dofmap[cells])
    G = np.moveaxis(G_host[cells], 2, 1)
    if engine:
        return cen.from_host(ldm, ids.size, np.ascontiguousarray(G), D,
                             dtype, device, coeff=coeff, C=C)
    if coeff is not None:
        G = G * coeff[:, None, None]
    return ci.from_host(ldm, ids.size, np.ascontiguousarray(G), D, dtype,
                        device, C)


def shard_unstructured(model, grid: sh.RankGrid,
                       stiffness_impl: str = "auto"):
    """One rank's part of a model on any imported mesh: the extruded
    sharding for a prismatic mesh on its extruded (or corner) kernels, the
    indexed sharding otherwise, or when the staged engine or the indexed
    kernel is asked for or the model runs the engine.  The JAX package's
    kernel names ('pallas', 'extruded_pallas') are 'auto'."""
    stiffness_impl = sharded_impl(stiffness_impl)
    if (isinstance(model.mesh, ExtrudedHexMesh) and stiffness_impl == "auto"
            and not isinstance(model.stiffness, EngineStiffness)):
        return ExtrudedShardedModel(model, grid)
    if stiffness_impl == "auto" and isinstance(model.stiffness,
                                               EngineStiffness):
        stiffness_impl = ENGINE_IMPL
    return IndexedShardedModel(model, grid, stiffness_impl=stiffness_impl)
