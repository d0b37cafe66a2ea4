"""Explicit RK4 time integration as a Python loop of eager torch ops.

The slope convention is the reference's:
    ku = f0(t, u, v) = v
    kv = f1(t, u, v) = M(u)^{-1} b(t, u, v)
with ku/kv carried across steps (stage 0 has a = 0, so the carried value is
never used).  Butcher arrays are the classic RK4 tableau
(fustpu_torch.config.RK4_*).  Counterpart of
``fustpu/models/timestepping.py``; eager PyTorch compiles nothing per run
length, so the solver needs no scan-length padding.

The time t is a Python float (float64 on the host).  In-place updates: the
step's u/v accumulators are fresh clones updated with `add_`; the stage
inputs and the state passed in are never written.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from fustpu_torch.config import RK4_A, RK4_B, RK4_C
from fustpu_torch.ops import vector as vec


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


def solve(rhs: Callable, state: RKState, dt: float, num_steps: int,
          tf: float | None = None, probe: Callable | None = None):
    """Run `num_steps` RK4 steps.  Returns the final state, or, with a
    `probe` (state -> (npts,) tensor), (state, ys) with ys
    (num_steps, npts) holding the probe after every step.

    The step time is recomputed as t = t0 + k*dt from the integer step
    index instead of being accumulated as t += dt, so rounding does not
    grow with the step count (in float32 the accumulated form drifts the
    source phase)."""
    t0 = state.t
    ys = []
    for k in range(num_steps):
        t = t0 + k * dt
        if tf is not None:
            t = min(t, tf)               # no-op steps past tf stay at tf
        state = rk4_step(rhs, state._replace(t=t), dt, tf)
        if probe is not None:
            ys.append(probe(state))
    return state if probe is None else (state, torch.stack(ys))
