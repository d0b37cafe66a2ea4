"""Explicit RK4 time integration: the eager step and loop, and
`make_solver`, which runs `num_steps` steps as replays of a captured CUDA
graph on the card.

The slope convention is the reference's:
    ku = f0(t, u, v) = v
    kv = f1(t, u, v) = M(u)^{-1} b(t, u, v)
with ku/kv carried across steps (stage 0 has a = 0, so the carried value is
never used).  Butcher arrays are the classic RK4 tableau
(fustpu_torch.config.RK4_*).  Counterpart of
``fustpu/models/timestepping.py``.

`rk4_step` and `solve` take the time as a Python float (float64 on the
host) and pass every coefficient to the updates as a Python float.  The
sharded models (``fustpu_torch.parallel``) run them: their exchange is a
gloo ``all_reduce``, which a CUDA graph cannot capture.  The JAX package's
sharded models do not use its `make_solver` either.

`make_solver` is the counterpart of the JAX package's `make_solver`, which
runs the steps as one jitted ``lax.scan``.  Its step, `rk4_step_table`,
reads every coefficient that changes from step to step from a table on the
fields' device: each stage's a_i dt and b_i dt (dt clamped onto tf) and
the source terms' coefficients at the stage time (`coefficient_table`,
filled on the host in float64 exactly as `solve` computes them, then cast
to the type in which the updates apply a coefficient: float32 for float32
and bfloat16 fields, float64 for float64).  The updates with such a
coefficient run ``ops/cuda_vector``'s kernel, which computes what
PyTorch's add with a Python float computes.

On the card a `Solver` replays a graph of `chunk` steps (CHUNK_STEPS, or
all of them if fewer) `num_steps // chunk` times and a graph of the
remaining steps once:

- the first call captures them, after one warm-up step on a side stream
  that runs every first-use cache of the step (the kernel library's load,
  the occupancy answers, host copies, schedules); a failed capture raises,
  nothing falls back to eager launches;
- the graphs read the state from static buffers and leave it there, so
  that one replay chains into the next; a call copies the state in and
  out once, and the chunk's rows of the coefficient table (one copy of the
  whole table to the card a call, then one copy on the card before each
  replay) into a static table; a probe writes its rows into a static
  (chunk, npts) buffer in the graph, copied out after each replay;
- the launch counters of the kernels (``ops/launch.counter_dicts``) count
  launches on the card: each replay adds the launches that its graph
  holds; the warm-up step and the capture leave the counters as they
  were.

On the CPU, and in `Solver.eager`, the same step function runs as eager
launches (on the CPU its updates are the plain ``torch.add``): that is the
plain version that the tests hold against the JAX package.
"""

from __future__ import annotations

import gc
from typing import Callable, NamedTuple

import numpy as np
import torch

from fustpu_torch.config import RK4_A, RK4_B, RK4_C
from fustpu_torch.ops import cuda_vector
from fustpu_torch.ops import launch
from fustpu_torch.ops import vector as vec

# Steps a captured graph holds (PERF.md: ms a step, capture and instantiate
# time against the chunk on an H100).
CHUNK_STEPS = 50


class RKState(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    ku: torch.Tensor
    kv: torch.Tensor
    t: float


def init_state(u0: torch.Tensor, v0: torch.Tensor, t0: float) -> RKState:
    return RKState(u=u0, v=v0, ku=torch.zeros_like(u0),
                   kv=torch.zeros_like(v0), t=float(t0))


def rk4_step(rhs: Callable, state: RKState, dt: float,
             tf: float | None = None) -> RKState:
    """One RK4 step.  `rhs(t, u, v) -> kv`.  If `tf` is given the step is
    clamped to land on tf; steps past tf become no-ops (dt = 0) rather than
    integrating backwards."""
    u0, v0, ku, kv, t = state
    if tf is not None:
        dt = min(max(tf - t, 0.0), dt)
    u = u0.clone()                       # accumulators, updated in place
    v = v0.clone()
    for a, b, c in zip(RK4_A, RK4_B, RK4_C):
        a, b, c = float(a), float(b), float(c)
        un = u0 if a == 0.0 else vec.axpy(a * dt, ku, u0)
        vn = v0 if a == 0.0 else vec.axpy(a * dt, kv, v0)
        ku = vn                          # f0: ku = v (vn is never written)
        kv = rhs(t + c * dt, un, vn)
        vec.axpy_(b * dt, ku, u)
        vec.axpy_(b * dt, kv, v)
    return RKState(u=u, v=v, ku=ku, kv=kv, t=t + dt)


def step_times(t0: float, dt: float, num_steps: int,
               tf: float | None = None) -> list[tuple[float, float]]:
    """(t, dt) of each step: t = t0 + k dt from the integer step index
    (not accumulated as t += dt, so that rounding does not grow with the
    step count: in float32 the accumulated form drifts the source phase),
    and with `tf` t = min(t, tf) and dt clamped onto tf (0 past it)."""
    out = []
    for k in range(num_steps):
        t, h = t0 + k * dt, dt
        if tf is not None:
            t = min(t, tf)               # no-op steps past tf stay at tf
            h = min(max(tf - t, 0.0), dt)
        out.append((t, h))
    return out


def solve(rhs: Callable, state: RKState, dt: float, num_steps: int,
          tf: float | None = None, probe: Callable | None = None):
    """Run `num_steps` RK4 steps of `rk4_step`.  Returns the final state,
    or, with a `probe` (state -> (npts,) tensor), (state, ys) with ys
    (num_steps, npts) holding the probe after every step (step times:
    `step_times`)."""
    ys = []
    for t, _ in step_times(state.t, dt, num_steps, tf):
        state = rk4_step(rhs, state._replace(t=t), dt, tf)
        if probe is not None:
            ys.append(probe(state))
    return state if probe is None else (state, torch.stack(ys))


# ---------------------------------------------------------------------------
# The table-driven step and the captured solve
# ---------------------------------------------------------------------------

class StageRHS(NamedTuple):
    """A right-hand side split where the host's part ends: `coeffs(t)`
    gives the source terms' coefficients at time t (a tuple of Python
    floats, float64); `apply(c, u, v) -> kv` computes the right-hand side
    with those coefficients given as c, a tuple of floats or a (W,) tensor
    on the fields' device whose entries the updates read there."""

    coeffs: Callable[[float], tuple]
    apply: Callable


def coefficient_table(coeffs: Callable[[float], tuple], t0: float,
                      dt: float, num_steps: int, tf: float | None = None
                      ) -> tuple[np.ndarray, float]:
    """(table, t after the last step): table (num_steps, 4, 2 + W) float64,
    row k, stage i = (a_i dt_k, b_i dt_k, *coeffs(t_k + c_i dt_k)), with
    (t_k, dt_k) from `step_times` and W = len(coeffs(t0)): the numbers
    that `rk4_step` computes on the host, in its expressions."""
    times = step_times(t0, dt, num_steps, tf)
    width = 2 + len(coeffs(t0))
    table = np.empty((num_steps, len(RK4_A), width))
    for k, (t, h) in enumerate(times):
        for i, (a, b, c) in enumerate(zip(RK4_A, RK4_B, RK4_C)):
            a, b, c = float(a), float(b), float(c)
            table[k, i] = (a * h, b * h, *coeffs(t + c * h))
    t_end = times[-1][0] + times[-1][1] if times else t0
    return table, t_end


def rk4_step_table(apply: Callable, u0: torch.Tensor, v0: torch.Tensor,
                   row: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """One RK4 step from (u0, v0), its coefficients read from `row`
    (4, 2 + W) on the fields' device (`coefficient_table`); returns (u, v,
    ku, kv).  u0 and v0 are never written; the carried ku, kv are never
    read (stage 0 has a = 0)."""
    u = u0.clone()                       # accumulators, updated in place
    v = v0.clone()
    ku = kv = None
    for i, a in enumerate(RK4_A):
        un = u0 if float(a) == 0.0 else vec.axpy(row[i, 0], ku, u0)
        vn = v0 if float(a) == 0.0 else vec.axpy(row[i, 0], kv, v0)
        ku = vn                          # f0: ku = v (vn is never written)
        kv = apply(row[i, 2:], un, vn)
        vec.axpy_(row[i, 1], ku, u)
        vec.axpy_(row[i, 1], kv, v)
    return u, v, ku, kv


class SolverCache(dict):
    """A model's solvers by the JAX package's key (num_steps, tf is not
    None, probe), and the memory pool that their graphs share (made at the
    first capture)."""

    pool = None


def _counts() -> list[dict]:
    return [dict(d) for d in launch.counter_dicts()]


class _Static(NamedTuple):
    """A solver's buffers on the card, which its graphs read and write."""

    u: torch.Tensor
    v: torch.Tensor
    ku: torch.Tensor
    kv: torch.Tensor
    table: torch.Tensor              # (chunk, 4, 2 + W) coefficient rows
    ys: torch.Tensor | None          # (chunk, npts) probe rows


class Solver:
    """`num_steps` RK4 steps of `rhs` (a `StageRHS`): ``solver(state, dt,
    tf) -> (state, ys)``, ys None without a probe, else (num_steps, npts).
    On the card the steps replay captured graphs of `chunk` steps; on the
    CPU they run eagerly (`eager`)."""

    def __init__(self, rhs: StageRHS, num_steps: int,
                 probe: Callable[[RKState], torch.Tensor] | None = None,
                 clamp_tf: bool = False, chunk: int | None = None,
                 cache: SolverCache | None = None):
        if num_steps < 0:
            raise ValueError(f"num_steps={num_steps}: expected >= 0")
        self.rhs, self.num_steps, self.probe = rhs, num_steps, probe
        self.clamp_tf = clamp_tf
        self.chunk = max(1, min(CHUNK_STEPS if chunk is None else chunk,
                                num_steps))
        self.cache = SolverCache() if cache is None else cache
        self.graphs: dict = {}      # steps -> (CUDAGraph, launches held)
        self._static: _Static | None = None

    # -- the table ---------------------------------------------------------
    def table(self, state: RKState, dt: float, tf: float | None
              ) -> tuple[torch.Tensor, float]:
        """(the coefficient table on the state's device in the updates'
        coefficient type, t after the last step)."""
        if self.clamp_tf and tf is None:
            raise ValueError("a solver made with clamp_tf=True needs tf")
        host, t_end = coefficient_table(
            self.rhs.coeffs, float(state.t), float(dt), self.num_steps,
            float(tf) if self.clamp_tf else None)
        tab = torch.from_numpy(host).to(
            cuda_vector.coefficient_dtype(state.u.dtype))
        if state.u.device.type == "cuda":
            tab = tab.pin_memory().to(state.u.device, non_blocking=True)
        return tab, t_end

    def __call__(self, state: RKState, dt: float, tf: float | None = None):
        if state.u.device.type != "cuda" or self.num_steps == 0:
            return self.eager(state, dt, tf)
        return self._replay(state, dt, tf)

    # -- eager launches ------------------------------------------------------
    def eager(self, state: RKState, dt: float, tf: float | None = None):
        """The same steps as eager launches (the plain path on the CPU; on
        the card the comparison of the replayed graphs)."""
        tab, t_end = self.table(state, dt, tf)
        times = step_times(float(state.t), float(dt), self.num_steps,
                           float(tf) if self.clamp_tf else None)
        u, v, ku, kv = state.u, state.v, state.ku, state.kv
        ys = []
        for k, (t, h) in enumerate(times):
            u, v, ku, kv = rk4_step_table(self.rhs.apply, u, v, tab[k])
            if self.probe is not None:
                ys.append(self.probe(RKState(u, v, ku, kv, t + h)))
        out = RKState(u, v, ku, kv, t_end)
        if self.probe is None:
            return out, None
        return out, (torch.stack(ys) if ys else torch.empty(0))

    # -- captured graphs -----------------------------------------------------
    def _buffers(self, state: RKState) -> _Static:
        s = self._static
        if s is None:
            width = 2 + len(self.rhs.coeffs(float(state.t)))
            z = lambda: torch.zeros_like(state.u)
            ys = None
            if self.probe is not None:
                y0 = self.probe(state)
                ys = y0.new_zeros((self.chunk, *y0.shape))
            s = self._static = _Static(
                z(), z(), z(), z(), torch.zeros(
                    (self.chunk, len(RK4_A), width), device=state.u.device,
                    dtype=cuda_vector.coefficient_dtype(state.u.dtype)), ys)
        if (s.u.shape, s.u.dtype, s.u.device) != (
                state.u.shape, state.u.dtype, state.u.device):
            raise ValueError(
                f"a solver captured for {tuple(s.u.shape)} {s.u.dtype} "
                f"fields on {s.u.device}, given {tuple(state.u.shape)} "
                f"{state.u.dtype} on {state.u.device}")
        return s

    def _body(self, steps: int) -> None:
        """`steps` steps from the static state back into it, the
        coefficients from the static table's rows, the probe into its
        rows."""
        s = self._static
        u, v = s.u, s.v
        for k in range(steps):
            u, v, ku, kv = rk4_step_table(self.rhs.apply, u, v, s.table[k])
            if self.probe is not None:
                s.ys[k].copy_(self.probe(RKState(u, v, ku, kv,
                                                 float("nan"))))
        for dst, src in zip(s, (u, v, ku, kv)):
            dst.copy_(src)

    def _graph(self, steps: int, device: torch.device) -> tuple:
        """The graph of `steps` steps and the launches it holds, captured
        at the first use (after one warm-up step on a side stream)."""
        got = self.graphs.get(steps)
        if got is not None:
            return got
        before = _counts()
        try:
            if not self.graphs:
                side = torch.cuda.Stream(device)
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side):
                    self._body(1)
                torch.cuda.current_stream(device).wait_stream(side)
            warm = _counts()
            if self.cache.pool is None:
                self.cache.pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            # thread_local: a Checkpointer's writer thread may copy a saved
            # state to the host on its own stream meanwhile.  No collection
            # of garbage (in any thread) while capturing: a CUDA object it
            # frees could call the runtime in the middle of the capture
            # (torch.cuda.graph collects just before it begins)
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self.cache.pool,
                                      capture_error_mode="thread_local"):
                    self._body(steps)
            finally:
                if collecting:
                    gc.enable()
            held = [{k: n - w[k] for k, n in d.items() if n != w[k]}
                    for d, w in zip(_counts(), warm)]
        finally:
            for d, b in zip(launch.counter_dicts(), before):
                d.update(b)
        self.graphs[steps] = got = (graph, held)
        return got

    def _replay(self, state: RKState, dt: float, tf: float | None):
        dev = state.u.device
        s = self._buffers(state)
        q, r = divmod(self.num_steps, self.chunk)
        plan = [(self.chunk, *self._graph(self.chunk, dev))] * q
        if r:
            plan.append((r, *self._graph(r, dev)))
        tab, t_end = self.table(state, dt, tf)
        s.u.copy_(state.u)
        s.v.copy_(state.v)
        ys = None
        if self.probe is not None:
            ys = s.ys.new_empty((self.num_steps, *s.ys.shape[1:]))
        done = 0
        for steps, graph, held in plan:
            s.table[:steps].copy_(tab[done:done + steps])
            graph.replay()
            if ys is not None:
                ys[done:done + steps].copy_(s.ys[:steps])
            for d, h in zip(launch.counter_dicts(), held):
                for k, n in h.items():
                    d[k] += n
            done += steps
        out = RKState(s.u.clone(), s.v.clone(), s.ku.clone(), s.kv.clone(),
                      t_end)
        return out, ys


def make_solver(rhs: StageRHS, num_steps: int,
                probe: Callable[[RKState], torch.Tensor] | None = None,
                clamp_tf: bool = False, chunk: int | None = None,
                cache: SolverCache | None = None) -> Solver:
    """A solver ``fn(state, dt, tf=None) -> (state, ys)`` running
    `num_steps` RK4 steps of `rhs` (a `StageRHS`): replays of captured CUDA
    graphs of `chunk` steps on the card, eager launches on the CPU.  With
    `clamp_tf` the last step is clamped onto tf (steps past it do
    nothing); ys is None without a `probe` (state -> (npts,) tensor),
    else (num_steps, npts), the probe after every step.  `cache`: the
    model's `SolverCache`, whose memory pool the graphs share."""
    return Solver(rhs, num_steps, probe, clamp_tf, chunk, cache)
