"""The captured RK4 solve (``timestepping.make_solver``: replays of CUDA
graphs of a chunk of steps) against the same steps launched eagerly and
against the eager loop of Python-float coefficients
(``timestepping.solve``), on one of the `nonlinear_bowl` demo's models.

    python -m fustpu_torch.demos.exp_solver [--steps 50] [--turns 2]
        [--chunks 10 25 50 100] [--memory] [bowl demo arguments ...]

For the model (default the flagship: --elements 64 --degree 4):

- each chunk of `--chunks`: a solver of `--steps` steps, the seconds of
  its first call (one warm-up step, the captures of a chunk's graph and
  the remainder's, and the replays), then ms per step of a second call
  (CUDA events), and the graph's launches;
- ms per step in turns (python-float, eager, captured, captured, eager,
  python-float, `--turns` times), CUDA events over `--steps` steps;
- device busy and idle share of the span for the captured and the eager
  steps from torch.profiler's trace (``tools.profile_step``);
- the replayed steps against the eager ones (bitwise) and against the
  python-float loop (rel-l2);
- with `--memory`, the peak device memory that an eager solve and a
  first captured solve (its capture included) add to what is allocated
  and to what is reserved (a graph's private pool shows in the latter).

On the CPU there is no graph: the captured and the eager form are the
same eager steps, and the times are host-clock CPU times.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import torch

from fustpu_torch.demos import nonlinear_bowl
from fustpu_torch.demos.common import rel_l2
from fustpu_torch.models import timestepping as ts
from fustpu_torch.ops import launch
from fustpu_torch.tools.profile_step import summarize_trace


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("--chunks", type=int, nargs="*", default=[])
    p.add_argument("--memory", action="store_true")
    return p


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ms_per_step(fn, steps: int, device) -> float:
    """ms a step of fn() (`steps` steps): CUDA events on the card, the
    host clock on the CPU."""
    _sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3 / steps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def _profile(fn, steps: int) -> dict:
    """Device busy and span a step of fn() under torch.profiler."""
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace))
        s = summarize_trace(json.loads(trace.read_text())["traceEvents"])
    if s["span_us"] == 0.0:
        return {"busy_ms": None, "span_ms": None, "idle": None,
                "kernels_per_step": 0.0}
    return {"busy_ms": s["busy_us"] / 1e3 / steps,
            "span_ms": s["span_us"] / 1e3 / steps,
            "idle": 1.0 - s["busy_us"] / s["span_us"],
            "kernels_per_step": (s["stiffness"][1] + s["elementwise"][1])
            / steps}


def _peak(fn, device) -> tuple[int, int]:
    """Device bytes that fn() adds at its peak to what is allocated and to
    what is reserved (a graph's private pool shows in the latter)."""
    _sync(device)
    torch.cuda.empty_cache()
    base = (torch.cuda.memory_allocated(device),
            torch.cuda.memory_reserved(device))
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    _sync(device)
    return (torch.cuda.max_memory_allocated(device) - base[0],
            torch.cuda.max_memory_reserved(device) - base[1])


def run(model, dt: float, steps: int = 50, turns: int = 2, chunks=(),
        memory: bool = False) -> dict:
    """The measurements above on `model` from 10 steps past rest; returns
    them as a dict."""
    device = model.device
    card = device.type == "cuda"
    state, _ = model.solve(model.init_state(), dt, 10)
    flat = model._flat_state(state)
    out = {"chunks": {}}
    for k in chunks:
        solver = ts.make_solver(model.stage_rhs, steps, chunk=k)
        _sync(device)
        t0 = time.perf_counter()
        solver(flat, dt)
        _sync(device)
        first = time.perf_counter() - t0
        ms = _ms_per_step(lambda: solver(flat, dt), steps, device)
        held = {n: c for h in (solver.graphs.get(k, (None, ()))[1])
                for n, c in h.items()}
        out["chunks"][k] = {"first_call_s": first, "ms_per_step": ms,
                            "launches_in_chunk_graph": sum(held.values())}
        print(f"   chunk {k:4d}: first call {first:.3f} s (capture, "
              f"instantiate, replay), then {ms:.4f} ms/step; "
              f"{sum(held.values())} counted launches in the chunk's graph",
              flush=True)
        del solver
    solver = model.solver(steps)
    forms = {
        "python-float": lambda: ts.solve(model._rhs, flat, dt, steps),
        "eager": lambda: solver.eager(flat, dt),
        "captured": lambda: solver(flat, dt)}
    forms["captured"]()                  # the capture, outside the turns
    times = {f: [] for f in forms}
    for name in ("python-float", "eager", "captured", "captured", "eager",
                 "python-float") * turns:
        times[name].append(_ms_per_step(forms[name], steps, device))
    out["ms_per_step"] = times
    print("   ms/step in turns: " + "; ".join(
        f"{f} " + " / ".join(f"{t:.4f}" for t in ts_)
        for f, ts_ in times.items()), flush=True)
    cap, eag = forms["captured"]()[0], forms["eager"]()[0]
    old = forms["python-float"]()
    out["bitwise_captured_eager"] = all(
        torch.equal(a, b) for a, b in zip(cap[:4], eag[:4]))
    out["rel_l2_captured_python_float"] = rel_l2(cap.u, old.u)
    print(f"   {steps} steps captured vs eager bitwise: "
          f"{out['bitwise_captured_eager']}; vs python-float rel-l2(u) "
          f"{out['rel_l2_captured_python_float']:.3e}", flush=True)
    if card:
        for f in ("eager", "captured"):
            out[f"profile_{f}"] = p = _profile(forms[f], steps)
            if p["busy_ms"] is None:
                print(f"   {f}: the profiler recorded no device interval",
                      flush=True)
            else:
                print(f"   {f} under the profiler: device busy "
                      f"{p['busy_ms']:.4f} ms/step of a span of "
                      f"{p['span_ms']:.4f}, idle {p['idle']:.4%} of the "
                      f"span, {p['kernels_per_step']:.1f} kernels a step",
                      flush=True)
    if card and memory:
        del solver
        for form, fn in (("eager", model.solve_eager),
                         ("captured", model.solve)):
            model.__dict__.pop("_solvers", None)
            out[f"peak_{form}_bytes"] = a, r = _peak(
                lambda: fn(state, dt, steps), device)
            print(f"   {form}: a solve adds at its peak {a / 1e9:.4f} GB "
                  f"allocated, {r / 1e9:.4f} GB reserved"
                  + (" (its capture included)" if form == "captured"
                     else ""), flush=True)
        model.__dict__.pop("_solvers", None)
    out["launches"] = {k: v for d in launch.counter_dicts()
                       for k, v in d.items() if v}
    return out


def main(argv=None) -> dict:
    args, rest = parser().parse_known_args(argv)
    # the flagship unless the bowl arguments say otherwise (the last wins)
    bowl = nonlinear_bowl.parser().parse_args(
        ["--elements", "64", "--degree", "4", *rest])
    model, dt, _, _ = nonlinear_bowl.build(bowl)
    print(f"{type(model).__name__}, {model.mesh.ndofs} dofs, "
          f"{model.dtype}, stiffness {model.stiffness_kernel}", flush=True)
    return run(model, dt, args.steps, args.turns, args.chunks, args.memory)


if __name__ == "__main__":
    main()
