"""Where the time of one RK4 step goes on the card, for the flagship bowl.

    python -m fustpu_torch.tools.profile_step [--only WORD ...] [--eager]

For the uniform and the two-layer Westervelt bowl runs at the flagship
size (the `nonlinear_bowl` demo's models, --elements 64 --degree 4,
float32), on the conformal mesh, on its .msh round trip (--geometry
unstructured, the extruded kernels) and on the non-prismatic bodyfit
bowl's round trip (--geometry bodyfit, the indexed kernels), for the
conformal and imported bowls again in the corner-streamed capacity mode
(--stiffness-impl pallas_corner, the corner kernels) and once more in
bfloat16 (--dtype bf16, the corner kernels' bf16 forms), and for the
bodyfit bowls on the staged engine (--stiffness-impl indexed_engine, three
kernels an apply), in float32 and in bfloat16, it prints, for the model's
solve (replays of captured CUDA graphs) or, with --eager, for the same
steps launched one by one:
  - ms per step without the profiler (CUDA events over STEPS steps);
  - ms per step under torch.profiler, and the device time per step split
    into the stiffness kernels, the other (elementwise) kernels and the
    device copies, with launches per step;
  - the device's busy time (the union of the kernel and copy intervals)
    and its idle share, of the device span and of the host wall time;
  - the stiffness kernel's bytes per apply (G or the corner channels,
    coefficients, index arrays and inputs read once, output written once,
    each in its stored type: 2 bytes a value in bfloat16) and the rate
    that gives at the measured time; on the staged engine also each of
    its three kernels' least bytes (u2 and y2 each written once and read
    once, in the fields' stored type).
Before that, a streaming copy of COPY_GIB GiB (float32, read + write)
gives the card's achievable memory rate to hold those against.  --only
keeps the runs whose demo arguments hold every word given (for instance
`--only indexed_engine bf16`: the two bf16 engine bowls).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from fustpu_torch.demos import nonlinear_bowl
from fustpu_torch.models.discretization import EngineStiffness

FLAGSHIP = ["--elements", "64", "--degree", "4"]
CORNER = ["--stiffness-impl", "pallas_corner"]
BF16 = ["--dtype", "bf16"]
ENGINE = ["--geometry", "bodyfit", "--stiffness-impl", "indexed_engine"]
STEPS = 50
COPY_GIB = 2.0


def summarize_trace(events: list[dict]) -> dict:
    """Device time by group from a Chrome trace's event list (torch.profiler
    `export_chrome_trace`): 'stiffness' (the CUDA stiffness kernels),
    'copies' (device memcpy / memset) and 'elementwise' (every other
    kernel); 'stiffness' holds the structured and extruded (the z-pencil
    kernel on box pencils and on stacks, its corner_kernel form of the
    corner walk, and the parity-class and the corner stiffness_kernel, the
    class-launch extruded_kernel), indexed
    (the chunk kernel, the class-launch indexed_kernel) kernels and the
    staged engine's three (in bfloat16 its contraction and scatter are
    contract_ring and scatter_runs).  Returns {group: (microseconds,
    launches)} plus 'busy_us' (the union of all device intervals) and
    'span_us' (first start to last end)."""
    groups = {"stiffness": [0.0, 0], "elementwise": [0.0, 0],
              "copies": [0.0, 0]}
    intervals = []
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") != "X" or cat not in ("kernel", "gpu_memcpy",
                                             "gpu_memset"):
            continue
        t0, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat != "kernel":
            g = "copies"
        elif any(k in e.get("name", "") for k in ("stiffness_kernel",
                                                  "pencil_kernel",
                                                  "corner_kernel",
                                                  "extruded_kernel",
                                                  "indexed_kernel",
                                                  "chunk_kernel",
                                                  "engine_gather",
                                                  "engine_contract",
                                                  "engine_scatter",
                                                  "contract_ring",
                                                  "scatter_runs")):
            g = "stiffness"
        else:
            g = "elementwise"
        groups[g][0] += dur
        groups[g][1] += 1
        intervals.append((t0, t0 + dur))
    intervals.sort()
    busy, end = 0.0, float("-inf")
    for a, b in intervals:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    out = {g: (us, n) for g, (us, n) in groups.items()}
    out["busy_us"] = busy
    out["span_us"] = (intervals[-1][1] - intervals[0][0]) if intervals \
        else 0.0
    return out


def _ms_per_step(solve, state, dt, steps) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    solve(state, dt, steps)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def _stiffness_bytes(stiff, ndofs: int) -> int:
    """Bytes one apply must move at least: the geometry (G, or the corner
    channels T), C and the index arrays (the extruded row ids, or the
    dofmap) once, the input field(s) once, the output written once."""
    op = stiff.cell_op
    geo = getattr(op, "G", None)
    geo = op.T if geo is None else geo
    field = ndofs * geo.element_size()
    n_in = 2 if stiff.is_pair else 1
    nbytes = lambda t: 0 if t is None else t.numel() * t.element_size()
    index = getattr(op, "rows", getattr(op, "dofmap", None))
    return nbytes(geo) + nbytes(op.C) + nbytes(index) + (n_in + 1) * field


def engine_bytes(op) -> tuple[int, int, int]:
    """The least bytes of the staged engine's gather (gather2 for a pair),
    contraction and scatter on the operator `op`, each input read once and
    each output written once in its stored type: the gather's dofmap,
    field(s) and u2; the contraction's u2, G, coeff or C and y2; the
    scatter's y2, inverse map and y."""
    b = op.G.element_size()
    N, cells, ndofs = op.dofmap.numel(), op.dofmap.shape[0], op.ndofs
    fields = 2 if op.C is not None else 1
    y2 = N * b
    per_cell = 0 if op.mode == "plain" else (2 if fields == 2 else 1)
    gather = N * 4 + fields * (ndofs + N) * b
    contract = fields * N * b + op.G.numel() * b + per_cell * cells * b + y2
    scatter = y2 + N * 4 + (ndofs + 1) * 4 + ndofs * b
    return gather, contract, scatter


def streaming_copy(gib: float) -> tuple[float, float]:
    """(ms, TB/s read + write) of one float32 device-to-device copy."""
    n = int(gib * 2**30) // 4
    x = torch.ones(n, device="cuda")
    y = torch.empty_like(x)
    y.copy_(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 10
    start.record()
    for _ in range(reps):
        y.copy_(x)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    del x, y
    torch.cuda.empty_cache()
    return ms, 2 * n * 4 / (ms * 1e-3) / 1e12


def profile(argv: list[str], steps: int, trace_dir: Path,
            eager: bool = False) -> dict:
    """The run of the demo arguments `argv`: the model's solve (replays of
    captured graphs), or with `eager` the same steps launched eagerly
    (`Model.solve_eager`)."""
    args = nonlinear_bowl.parser().parse_args(argv)
    model, dt, _, _ = nonlinear_bowl.build(args)
    solve = model.solve_eager if eager else model.solve
    state, _ = solve(model.init_state(), dt, 10)   # warm-up
    solve(state, dt, 2)
    solve(state, dt, steps)                        # the captures
    torch.cuda.synchronize()
    plain_ms = _ms_per_step(solve, state, dt, steps)

    mode = {"pallas_corner": " corner", "indexed_engine": " engine"}
    config = (f"{args.geometry} "
              f"{'two-layer' if args.two_layer else 'uniform'}"
              f"{mode.get(args.stiffness_impl, '')}"
              f"{' bf16' if args.dtype == 'bf16' else ''}"
              f"{' eager' if eager else ''}")
    trace = trace_dir / f"trace_{config.replace(' ', '_')}.json"
    # one warm-up step of the profiler (two RK4 steps), then the active one
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                             repeat=1),
            on_trace_ready=lambda pr: pr.export_chrome_trace(str(trace))
            ) as prof:
        solve(state, dt, 2)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        solve(state, dt, steps)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        prof.step()
    events = json.loads(trace.read_text())["traceEvents"]
    s = summarize_trace(events)
    if s["busy_us"] == 0.0:
        raise SystemExit("torch.profiler recorded no device activity")
    stiff_ms_apply = s["stiffness"][0] / 1e3 / (4 * steps)
    nbytes = _stiffness_bytes(model.stiffness, model.mesh.ndofs)
    out = {
        "config": config,
        "ms_per_step": plain_ms,
        "profiled_ms_per_step": host_s * 1e3 / steps,
        "busy_ms_per_step": s["busy_us"] / 1e3 / steps,
        "span_ms_per_step": s["span_us"] / 1e3 / steps,
        "idle_share_of_span": 1.0 - s["busy_us"] / s["span_us"],
        "idle_share_of_host_wall": 1.0 - s["busy_us"] / (host_s * 1e6),
        "groups": {g: {"ms_per_step": s[g][0] / 1e3 / steps,
                       "launches_per_step": s[g][1] / steps,
                       "us_each": s[g][0] / max(s[g][1], 1)}
                   for g in ("stiffness", "elementwise", "copies")},
        "stiffness_bytes_per_apply": nbytes,
        "stiffness_ms_per_apply": stiff_ms_apply,
        "stiffness_TBps": nbytes / (stiff_ms_apply * 1e-3) / 1e12,
    }
    if isinstance(model.stiffness, EngineStiffness):
        out["engine_kernel_bytes"] = engine_bytes(model.stiffness.cell_op)
    del model, state
    torch.cuda.empty_cache()
    return out


CONFIGS = ([], ["--two-layer"],
           ["--geometry", "unstructured"],
           ["--geometry", "unstructured", "--two-layer"],
           ["--geometry", "bodyfit"],
           ["--geometry", "bodyfit", "--two-layer"],
           CORNER, CORNER + ["--two-layer"],
           CORNER + ["--geometry", "unstructured"],
           CORNER + ["--geometry", "unstructured", "--two-layer"],
           CORNER + BF16, CORNER + BF16 + ["--two-layer"],
           CORNER + BF16 + ["--geometry", "unstructured"],
           ENGINE, ENGINE + ["--two-layer"],
           ENGINE + BF16, ENGINE + BF16 + ["--two-layer"])


def selected(only: list[str]) -> list[list[str]]:
    """The runs' extra demo arguments whose words include every one of
    `only` (all runs for none)."""
    return [c for c in CONFIGS if all(w in c for w in only)]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--only", nargs="*", default=[],
                   help="keep the runs whose demo arguments hold each word")
    p.add_argument("--eager", action="store_true",
                   help="the same steps launched eagerly, not replayed")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    ms, tbps = streaming_copy(COPY_GIB)
    print(f"streaming copy of {COPY_GIB} GiB float32: {ms:.4f} ms, "
          f"{tbps:.4f} TB/s read + write", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for extra in selected(args.only):
            r = profile(FLAGSHIP + extra, STEPS, Path(tmp), args.eager)
            print(json.dumps(r), flush=True)
            print(f"{r['config']}: {r['ms_per_step']:.4f} ms/step "
                  f"unprofiled, {r['profiled_ms_per_step']:.4f} profiled; "
                  f"device busy {r['busy_ms_per_step']:.4f} ms/step, idle "
                  f"{r['idle_share_of_span']:.4f} of span, "
                  f"{r['idle_share_of_host_wall']:.4f} of host wall")
            for g, v in r["groups"].items():
                print(f"   {g:12s} {v['ms_per_step']:.4f} ms/step "
                      f"{v['launches_per_step']:.1f} launches/step "
                      f"{v['us_each']:.2f} us each")
            print(f"   stiffness: {r['stiffness_bytes_per_apply']} B per "
                  f"apply, {r['stiffness_ms_per_apply']:.4f} ms, "
                  f"{r['stiffness_TBps']:.4f} TB/s ({smi})", flush=True)
            if "engine_kernel_bytes" in r:
                print("   engine kernels' least bytes (gather, contract, "
                      "scatter): " + ", ".join(
                          map(str, r["engine_kernel_bytes"])), flush=True)


if __name__ == "__main__":
    main()
