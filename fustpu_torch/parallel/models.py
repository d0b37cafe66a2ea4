"""Sharded wave models on a box mesh: one rank's part of a LinearWaveModel
or WesterveltModel, stepped in lockstep with the other ranks.

Each rank builds, from the full host model (every rank holds it, as every
MPI rank of the reference holds its set-up), a model of the same class on
its block: the block's stiffness operator on the rank's device and the
block's slices of the globally assembled diagonal vectors.  Its stiffness
module applies the local operator and then the exchange (`Exchanged`), so
the physics RHS of the one-rank model runs unchanged on the block.

Communication per RK stage: ONE exchange (`sharding.halo_sum`, one
``all_reduce`` per partitioned axis) right after the stiffness apply — only
the stiffness couples neighbouring cells.  Every mass-type term (unsteady
LHS, v^2 term, sources, absorbing boundary) is a diagonal multiply by a
vector that is consistent across owners, so it commutes with the exchange
and is added after it; adding it before would count shared nodes twice.

Counterpart of ``fustpu/parallel/models.py`` (`ShardedModel`).  Not ported:
the y-slab split (`PallasStiffnessSplit`, `pick_y_parts`, `force_y_parts`)
and the `mm` expanded-coefficient route, which are TPU VMEM limits, and the
zero-coefficient ghost cells of a non-divisible box: ranks may hold blocks
of different sizes.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from fustpu_torch.mesh.box import BoxMesh
from fustpu_torch.models import timestepping
from fustpu_torch.models.discretization import (KERNEL_IMPLS,
                                                CornerStiffness,
                                                stiffness_module)
from fustpu_torch.models.westervelt import WesterveltModel
from fustpu_torch.ops import cuda_corner as cc
from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.parallel import sharding as sh
from fustpu_torch.utils.eval import PointSampler
from fustpu_torch.utils.io import to_host

# The attributes of a one-rank model that its coefficients and RHS read.
_SCALARS = ("material", "source", "dtype", "uniform", "c_src", "c2_scalar",
            "c3_scalar", "c4_scalar", "_delta", "_pair_coeffs")


class Exchanged(nn.Module):
    """A rank's stiffness module followed by the exchange of its shared
    entries: `forward(x)` and `pair(x1, x2)` apply the local operator, then
    `exchange(y)` sums the shared entries across ranks in place."""

    def __init__(self, inner: nn.Module, exchange):
        super().__init__()
        self.inner = inner
        self.exchange = exchange

    @property
    def kernel(self) -> str | None:
        return self.inner.kernel

    @property
    def is_pair(self) -> bool:
        return self.inner.is_pair

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.exchange(self.inner(x))

    def pair(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        return self.exchange(self.inner.pair(x1, x2))


def local_model(model, mesh, stiffness: nn.Module, vectors: dict, device):
    """A model of `model`'s class on a rank's part: `mesh` gives its field
    shape (`grid_shape`), `stiffness` its (exchanged) operator, `vectors`
    its flat host slices of the global diagonal vectors; coefficients and
    source as `model`'s."""
    cls = type(model)
    local = cls.__new__(cls)
    nn.Module.__init__(local)
    for name in _SCALARS:
        if hasattr(model, name):
            setattr(local, name, getattr(model, name))
    local.mesh = mesh
    # the exchange (a gloo all_reduce) cannot be captured: eager solves
    local.capture = False
    local.device = torch.device(device)
    local.impl = "cuda" if local.device.type == "cuda" else "mm"
    local.stiffness = stiffness
    local._load_vectors(vectors)
    return local


def host_vectors(model) -> dict:
    """The one-rank model's diagonal vectors as flat host arrays (None
    where it has no such term): in its dtype, a bfloat16 model's as
    float32 (exact: numpy has no bfloat16), which `_load_vectors` casts
    back at upload."""
    return {name: (None if getattr(model, name) is None else
                   to_host(getattr(model, name)).reshape(-1))
            for name in model.VECTORS}


def stiffness_coefficients(model):
    """(coeff, pair) of the one-rank model's stiffness operator: the linear
    model's per-cell -1/rho in a heterogeneous medium, the Westervelt
    model's two per-cell coefficients in one, else None."""
    if model.uniform:
        return None, None
    if isinstance(model, WesterveltModel):
        return None, model._pair_coeffs
    return -1.0 / model.material.cell_fields(model.cell_shape)[1], None


def sharded_impl(stiffness_impl):
    """The sharded models' stiffness_impl: the JAX package's kernel names
    ('pallas', 'extruded_pallas') are its 'auto' (the kernels on the card,
    the plain versions on the CPU)."""
    return "auto" if stiffness_impl in KERNEL_IMPLS else stiffness_impl


def wants_corner(model, stiffness_impl) -> bool:
    """The corner-streamed mode: asked for, or the model's own choice."""
    if stiffness_impl is None:
        return isinstance(model.stiffness, CornerStiffness)
    stiffness_impl = sharded_impl(stiffness_impl)
    if stiffness_impl not in ("auto", "pallas_corner"):
        raise ValueError(f"stiffness_impl={stiffness_impl!r}: expected "
                         "None, 'auto', 'pallas_corner' or one of "
                         f"{KERNEL_IMPLS}")
    return stiffness_impl == "pallas_corner"


class RankPart:
    """What every sharded model shares.  A subclass sets `model` (the full
    model), `grid`, `mesh` (the global mesh), `local` (the rank's model),
    `weights` (the 1 / multiplicity of each local entry, shaped like a
    local field) and defines `_entries(field, rank)` (that rank's entries
    of a global host field, in its local layout) and `_merge(blocks)` (the
    global host field of every rank's entries; on an entry several ranks
    hold, the last writer wins)."""

    # ---------------- data movement -------------------------------------
    def block(self, field) -> np.ndarray:
        """This rank's entries of a global host field."""
        return np.ascontiguousarray(self._entries(np.asarray(field),
                                                  self.grid.rank))

    def blocks(self, field: torch.Tensor) -> list[np.ndarray]:
        """Every rank's part of a distributed field, in rank order (on
        every rank; a bfloat16 field's as float32, exactly)."""
        return self.grid.all_gather(to_host(field))

    def collect(self, field: torch.Tensor) -> np.ndarray:
        """A distributed field -> the global numpy array, on every rank."""
        return self._merge(self.blocks(field))

    def consistent(self, field: torch.Tensor) -> bool:
        """Whether every owner of every shared entry holds the same
        bits."""
        blocks = self.blocks(field)
        full = self._merge(blocks)
        return all(np.array_equal(b.reshape(-1),
                                  self._entries(full, r).reshape(-1))
                   for r, b in enumerate(blocks))

    # ---------------- public API ------------------------------------------
    def init_state(self, t0: float = 0.0, u0=None, v0=None
                   ) -> timestepping.RKState:
        """The rank's state from global initial fields (zero if None)."""
        b = lambda f: None if f is None else self.block(f)
        return self.local.init_state(t0, u0=b(u0), v0=b(v0))

    def split_state(self, host) -> timestepping.RKState:
        """The rank's state from a global host state (u, v, ku, kv, t)."""
        t = lambda f: torch.as_tensor(
            self.block(np.asarray(f, np.float64)), dtype=self.model.dtype,
            device=self.grid.device)
        u, v, ku, kv, t0 = host
        return timestepping.RKState(t(u), t(v), t(ku), t(kv), float(t0))

    def solve(self, state, dt: float, num_steps: int, tf=None, probe=None):
        """`num_steps` RK4 steps of the rank's part in lockstep with the
        other ranks; the one-rank models' API (a probe from `probe_fn` or
        `norm_probe` returns the full trace on every rank)."""
        return self.local.solve(state, dt, num_steps, tf=tf, probe=probe)

    def step(self, state, dt: float, tf=None) -> timestepping.RKState:
        return self.local.step(state, dt, tf=tf)

    def cfl_dt(self, cfl: float | None = None) -> tuple[float, int]:
        return self.model.cfl_dt(cfl)

    @property
    def device(self) -> torch.device:
        return self.grid.device

    def global_dot(self, x: torch.Tensor, y: torch.Tensor) -> float:
        """Distributed dot product: the multiplicity-weighted local sum,
        summed over the ranks."""
        return sh.weighted_dot(x, y, self.weights, self.grid)

    def global_norm(self, x: torch.Tensor) -> float:
        return float(np.sqrt(self.global_dot(x, x)))

    def norm_probe(self):
        """A per-step probe (for `solve(probe=...)`) of the global l2 norm
        of u, the same value on every rank."""

        def probe(s: timestepping.RKState) -> torch.Tensor:
            p = torch.sum(s.u * s.u * self.weights.to(s.u.dtype)).reshape(1)
            return torch.sqrt(self.grid.all_reduce(p))

        return probe


class ShardedModel(RankPart):
    """One rank's part of a model on a box mesh, distributed over `grid`.
    `model`: the full model, on any device (its host metric and diagonal
    vectors are read).  `stiffness_impl`: None (the model's choice), 'auto'
    (the G stream; the JAX package's 'pallas' too) or 'pallas_corner'
    (the corner-streamed kernels).  The rank's tensors live on
    ``grid.device``: the CUDA kernels there, their plain versions on the
    CPU.  Same `init_state` / `solve` / `step` API as the one-rank models,
    on the rank's block (`RankPart`); `collect` gathers a field into the
    global (gx, gy, gz) grid."""

    def __init__(self, model, grid: sh.RankGrid, stiffness_impl=None):
        mesh = model.mesh
        if not isinstance(mesh, BoxMesh):
            raise TypeError("ShardedModel needs a box mesh (use "
                            "shard_unstructured for imported meshes)")
        self.model, self.grid, self.mesh = model, grid, mesh
        self.kind = ("westervelt" if isinstance(model, WesterveltModel)
                     else "linear")
        S, P = grid.shape, mesh.degree
        n = P + 1
        ranges = sh.block_cells(mesh.nc, S)
        self.extents = tuple((r[0][1] - r[0][0]) * P + 1 for r in ranges)
        self.node_sl = sh.node_slices(mesh.nc, S, P, grid.coords)
        cell_sl = sh.cell_slices(mesh.nc, S, grid.coords)
        self.lnc = tuple(s.stop - s.start for s in cell_sl)
        vert_sl = tuple(slice(s.start, s.stop + 1) for s in cell_sl)
        local_mesh = BoxMesh(degree=P, nc=self.lnc, lo=mesh.lo, hi=mesh.hi,
                             vertex_coords=np.ascontiguousarray(
                                 mesh.vertex_coords[vert_sl]))
        self.corner = wants_corner(model, stiffness_impl)
        coeff, pair = stiffness_coefficients(model)
        cells = lambda c: np.ascontiguousarray(np.broadcast_to(
            np.asarray(c, np.float64), mesh.nc)[cell_sl])
        coeff = None if coeff is None else cells(coeff)
        pair = None if pair is None else tuple(cells(c) for c in pair)
        dtype, dev = model.dtype, grid.device
        D = model.disc._D_host
        if self.corner:
            op = cc.build_box(local_mesh, D, dtype, dev, coeff=coeff,
                              pair=pair)
        else:
            G = model.disc._G_host.reshape(*mesh.nc, n ** 3, 6)[cell_sl]
            t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
            op = cs.CellStiffness(
                G=t(cs.pack_G(G.reshape(-1, n ** 3, 6), coeff)), D=t(D),
                nc=self.lnc,
                C=None if pair is None else t(np.stack(
                    [c.reshape(-1) for c in pair], axis=1)))
        inner = stiffness_module(op, "cuda" if dev.type == "cuda" else "mm")
        vectors = {k: None if v is None else self.block(v).reshape(-1)
                   for k, v in host_vectors(model).items()}
        self.local = local_model(model, local_mesh,
                                 Exchanged(inner, self.exchange), vectors,
                                 dev)
        self.weights = sh.ownership_weights(local_mesh.grid_shape, grid)

    def _entries(self, field: np.ndarray, rank: int) -> np.ndarray:
        f = field.reshape(self.mesh.grid_shape)
        return f[sh.node_slices(self.mesh.nc, self.grid.shape,
                                self.mesh.degree, self.grid.coords_of(rank))]

    def _merge(self, blocks) -> np.ndarray:
        out = np.empty(self.mesh.grid_shape, blocks[0].dtype)
        for r, b in enumerate(blocks):
            out[sh.node_slices(self.mesh.nc, self.grid.shape,
                               self.mesh.degree, self.grid.coords_of(r))] = b
        return out

    def exchange(self, y: torch.Tensor) -> torch.Tensor:
        """Sum the shared planes of the rank's stiffness output in place
        (one all_reduce per partitioned axis)."""
        return sh.halo_sum(y.reshape(self.local.mesh.grid_shape), self.grid,
                           self.extents)

    def probe_fn(self, points):
        """A per-step sampler for `solve(probe=...)`: each point's (n, n, n)
        interpolation window lies in one cell, hence in one block; the rank
        owning it contributes, the others zero, and an all_reduce gives
        every rank the full trace."""
        smp = PointSampler(self.mesh, points)
        mine = np.ones(len(smp._w), bool)
        local = []
        for idx, sl in zip((smp._I, smp._J, smp._K), self.node_sl):
            # a point belongs to the block holding its window's first node
            # and its last (shared planes belong to both blocks)
            mine &= (idx[:, 0] >= sl.start) & (idx[:, -1] < sl.stop)
            local.append(np.clip(idx - sl.start, 0, sl.stop - sl.start - 1))
        first = self.grid.all_gather(mine)
        owner = np.argmax(np.stack(first), axis=0)
        if not np.stack(first).any(axis=0).all():
            raise ValueError("a probe point lies in no rank's block")
        own = torch.as_tensor(owner == self.grid.rank, device=self.grid.device)
        dev = self.grid.device
        Il, Jl, Kl = (torch.as_tensor(a, device=dev) for a in local)
        w = torch.as_tensor(smp._w, device=dev)

        def probe(s: timestepping.RKState) -> torch.Tensor:
            f = s.u
            vals = f[Il[:, :, None, None], Jl[:, None, :, None],
                     Kl[:, None, None, :]]
            p = torch.einsum("pijk,pijk->p", vals, w.to(f.dtype))
            p = torch.where(own, p, torch.zeros_like(p))
            return self.grid.all_reduce(p)

        return probe
