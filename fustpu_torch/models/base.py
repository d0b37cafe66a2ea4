"""Shared model machinery: buffers, state handling, the RK4 step/solve
loop and CFL step selection used by both physics models.

The physics subclasses provide `_source_coeffs(t)` (the source terms'
coefficients at time t, host floats) and `_rhs_stage(c, u, v) -> kv` on
flat vectors, the coefficients c given as floats or as a tensor on the
card; `_rhs(t, u, v)` is the two together.  The grid-shaped public API
(`rhs`, `solve`) reshapes views around them.  A model is an `nn.Module`
whose buffers are the operator data: the diagonal vectors (flat, in the
model dtype) and the `stiffness` submodule.  Counterpart of
``fustpu/models/base.py``.

`solve` goes through ``timestepping.make_solver``'s solvers, cached by the
JAX package's key (num_steps, tf is not None, probe): on the card they
replay captured CUDA graphs, on the CPU they run the same steps eagerly.
A graph holds the model's buffers and modules as they were at its
capture: assigning an attribute of the model (a new stiffness module, a
buffer) or moving it drops its solvers.  The sharded models' rank parts
(``parallel.models.local_model``) set `capture` False and solve with
``timestepping.solve``'s eager loop.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch
from torch import nn

from fustpu_torch.mesh.unstructured import UnstructuredHexMesh
from fustpu_torch.models import timestepping
from fustpu_torch.models.discretization import resolve_stiffness_impl


class WaveModelBase(nn.Module):
    """Subclasses set their coefficients in `_coefficients`, build the
    `stiffness` submodule and vectors, and implement `_source_coeffs(t)`
    and `_rhs_stage(c, u, v)`."""

    DEFAULT_CFL = 0.65
    VECTORS: tuple = ()        # names of the flat diagonal-vector buffers
    capture = True             # solve through make_solver's solvers

    def __setattr__(self, name, value) -> None:
        # the captured graphs hold the old attribute's buffers
        if name != "_solvers":
            self.__dict__.pop("_solvers", None)
        super().__setattr__(name, value)

    def _apply(self, fn, *args, **kwargs):
        self.__dict__.pop("_solvers", None)
        return super()._apply(fn, *args, **kwargs)

    def __getstate__(self):
        # a pickled model (a spawned rank's) leaves its solvers behind:
        # their graphs and closures belong to this process
        state = super().__getstate__()
        state.pop("_solvers", None)
        return state

    def _setup(self, mesh, material, source, source_facets,
               dtype: torch.dtype, device, stiffness_impl: str,
               setup_device=None) -> None:
        """Configuration shared by every way of building a model: no
        assembly happens here.  `mesh`: a BoxMesh (structured kernels), an
        ExtrudedHexMesh (extruded kernels) or any other
        UnstructuredHexMesh (the indexed kernels).  `setup_device`: where
        the geometry, facet and diagonal set-up runs (`Discretization`):
        the model's device when None, or 'cpu' for the host's float64
        numpy (the set-up kernels' plain versions), uploaded."""
        if not (hasattr(mesh, "nc") or isinstance(mesh, UnstructuredHexMesh)):
            raise TypeError(
                f"mesh of type {type(mesh).__name__}: expected a BoxMesh or "
                "an UnstructuredHexMesh (an imported .msh mesh)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r}: no CUDA device is available (the "
                "models run on the card by default; pass device='cpu' for "
                "the plain torch path)")
        self.setup_device = torch.device(
            self.device if setup_device is None else setup_device)
        if self.setup_device.type not in ("cpu", self.device.type):
            raise ValueError(f"setup_device={setup_device!r}: expected None "
                             f"or 'cpu' for a model on {self.device}")
        self.mesh = mesh
        self.material = material
        self.source = source
        self.dtype = dtype
        self.impl = resolve_stiffness_impl(stiffness_impl, self.device,
                                           mesh, dtype)
        self.uniform = material.is_uniform
        # shape of per-cell fields: the cell grid, or the cell list
        self.cell_shape = (mesh.nc if hasattr(mesh, "nc")
                           else (mesh.num_cells,))
        c = material.cell_fields(self.cell_shape)[0].reshape(-1)
        cells = np.asarray(source_facets).reshape(-1, 2)[:, 0]
        # scalar sound speed at the source (enters the source amplitude)
        self.c_src = float(np.mean(c[cells])) if cells.size \
            else float(np.max(c))
        self._coefficients()

    def _coefficients(self) -> None:
        raise NotImplementedError

    @property
    def stiffness_kernel(self) -> str | None:
        """The launch counter of the CUDA kernel that the model's stiffness
        applies run (e.g. 'corner_pair' or 'extruded'), None for the plain
        version."""
        return self.stiffness.kernel

    def _load_vectors(self, vectors: dict) -> None:
        """Register every name of VECTORS as a flat buffer in the model
        dtype (None where the model has no such term), from float64 host
        arrays or tensors (the set-up on the card)."""
        for name in self.VECTORS:
            a = vectors.get(name)
            if isinstance(a, torch.Tensor):
                a = a.reshape(-1).to(dtype=self.dtype, device=self.device)
            elif a is not None:
                a = torch.tensor(np.asarray(a).reshape(-1), dtype=self.dtype,
                                 device=self.device)
            self.register_buffer(name, a)

    # ------------------------------------------------------------------
    def init_state(self, t0: float = 0.0, u0=None, v0=None
                   ) -> timestepping.RKState:
        g = self.mesh.grid_shape

        def field(a):
            if a is None:
                return torch.zeros(g, dtype=self.dtype, device=self.device)
            return torch.as_tensor(a, dtype=self.dtype,
                                   device=self.device).reshape(g).clone()

        return timestepping.init_state(field(u0), field(v0), t0)

    def _flat_state(self, s):
        r = lambda a: a.reshape(-1)
        return timestepping.RKState(r(s.u), r(s.v), r(s.ku), r(s.kv), s.t)

    def _grid_state(self, s):
        g = self.mesh.grid_shape
        r = lambda a: a.reshape(g)
        return timestepping.RKState(r(s.u), r(s.v), r(s.ku), r(s.kv), s.t)

    def _source_coeffs(self, t: float) -> tuple:
        raise NotImplementedError

    def _rhs_stage(self, c, u: torch.Tensor, v: torch.Tensor
                   ) -> torch.Tensor:
        raise NotImplementedError

    def _rhs(self, t: float, u: torch.Tensor, v: torch.Tensor
             ) -> torch.Tensor:
        """kv = M^{-1} b(t, u, v) on flat vectors."""
        return self._rhs_stage(self._source_coeffs(t), u, v)

    @property
    def stage_rhs(self) -> timestepping.StageRHS:
        return timestepping.StageRHS(self._source_coeffs, self._rhs_stage)

    def rhs(self, t: float, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Grid-shaped public entry point."""
        kv = self._rhs(float(t), u.reshape(-1), v.reshape(-1))
        return kv.reshape(self.mesh.grid_shape)

    @torch.no_grad()
    def step(self, state, dt: float, tf: float | None = None):
        """One RK4 step; it is clamped onto `tf` if given (a step past `tf`
        does nothing)."""
        out = timestepping.rk4_step(self._rhs, self._flat_state(state),
                                    float(dt),
                                    None if tf is None else float(tf))
        return self._grid_state(out)

    def solver(self, num_steps: int, clamp_tf: bool = False, probe=None
               ) -> timestepping.Solver:
        """The solver of `num_steps` steps (``timestepping.make_solver``),
        made at its first use and cached by the JAX package's key
        (num_steps, clamp_tf, probe)."""
        cache = self.__dict__.get("_solvers")
        if cache is None:
            cache = self._solvers = timestepping.SolverCache()
        key = (num_steps, clamp_tf, probe)
        if key not in cache:
            # the model holds its solvers: they reach it by a weak
            # reference, so that a deleted model frees its memory at once
            me = weakref.ref(self)
            rhs = timestepping.StageRHS(
                lambda t: me()._source_coeffs(t),
                lambda c, u, v: me()._rhs_stage(c, u, v))
            wrapped = (None if probe is None
                       else (lambda s: probe(me()._grid_state(s))))
            cache[key] = timestepping.make_solver(
                rhs, num_steps, wrapped, clamp_tf=clamp_tf, cache=cache)
        return cache[key]

    @torch.no_grad()
    def solve(self, state, dt: float, num_steps: int,
              tf: float | None = None, probe=None):
        """`num_steps` RK4 steps; the last is clamped onto `tf` if given.
        State fields are grid-shaped at the API; the loop runs on flat
        views.  Returns (state, ys), as the JAX package does: ys is None
        without a `probe` (grid-shaped state -> (npts,) tensor), else
        (num_steps, npts) on the model's device, the probe read after
        every step.  On the card the steps replay captured CUDA graphs
        (`solver`)."""
        tf = None if tf is None else float(tf)
        if not self.capture:
            wrapped = (None if probe is None
                       else (lambda s: probe(self._grid_state(s))))
            out = timestepping.solve(self._rhs, self._flat_state(state),
                                     float(dt), num_steps, tf,
                                     probe=wrapped)
            out, ys = (out, None) if probe is None else out
        else:
            out, ys = self.solver(num_steps, tf is not None, probe)(
                self._flat_state(state), float(dt), tf)
        return self._grid_state(out), ys

    @torch.no_grad()
    def solve_eager(self, state, dt: float, num_steps: int,
                    tf: float | None = None, probe=None):
        """The steps of `solve` as eager launches, without a graph (what
        `solve` runs on the CPU): on the card, the comparison of the
        captured solve."""
        tf = None if tf is None else float(tf)
        out, ys = self.solver(num_steps, tf is not None, probe).eager(
            self._flat_state(state), float(dt), tf)
        return self._grid_state(out), ys

    def cfl_dt(self, cfl: float | None = None) -> tuple[float, int]:
        """dt = CFL h / (c P^2), snapped to an integer number of steps per
        source period."""
        cfl = self.DEFAULT_CFL if cfl is None else cfl
        c_max = float(np.max(self.material.sound_speed))
        # h_cfl is the diameter on cube cells, but binds on the thin
        # direction of anisotropic cells, where the diameter convention
        # overestimates the stable dt by the aspect ratio
        h = self.mesh.h_cfl()
        dt = cfl * h / (c_max * self.mesh.degree**2)
        spp = int(self.source.period / dt) + 1
        return self.source.period / spp, spp
