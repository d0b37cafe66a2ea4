"""Shared demo runner: argument parser and a chunked solve with progress
prints and per-step timing (CUDA events on the card, the host clock on the
CPU).  Counterpart of ``demos/common.py`` for single-device models."""

from __future__ import annotations

import argparse
import time

import torch


def add_device_args(p: argparse.ArgumentParser,
                    dtype: str = "f32") -> argparse.ArgumentParser:
    """--dtype and --device, shared by every demo."""
    p.add_argument("--dtype", choices=["f32", "f64"], default=dtype)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda = the H100 path (CUDA kernels); cpu = the "
                        "plain torch path (small verification runs)")
    return p


def demo_argparser(**defaults) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--elements", type=int,
                   default=defaults.get("elements", 0),
                   help="elements per axis (0 = reference default: "
                        "2 per wavelength)")
    p.add_argument("--degree", type=int, default=defaults.get("degree", 4))
    p.add_argument("--periods", type=float,
                   default=defaults.get("periods", 2.0),
                   help="extra periods after first transit")
    p.add_argument("--progress-every", type=int, default=100)
    return add_device_args(p, defaults.get("dtype", "f32"))


def pick_dtype(name: str) -> torch.dtype:
    return {"f32": torch.float32, "f64": torch.float64}[name]


def check_device(args) -> None:
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(use --device cpu for the plain torch path)")


class Timer:
    """Elapsed seconds of a chunk: CUDA events on the card, the host clock
    otherwise."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            self.seconds = self.start.elapsed_time(self.end) / 1e3
        else:
            self.seconds = time.perf_counter() - self.t0


def run_demo(model, dt: float, num_steps: int, args, name: str,
             probe=None):
    """Chunked solve, `args.progress_every` steps per chunk, progress
    printed in between.  The last step is clamped onto tf = num_steps*dt.
    Returns the final state, or (state, ys) with the per-step probe
    values ys (num_steps, npts) when a `probe` is given."""
    state = model.init_state()
    chunk = max(args.progress_every, 1)
    tf = float(num_steps) * dt
    done = 0
    walls, ys = [], []
    while done < num_steps:
        k = min(chunk, num_steps - done)
        with Timer(model.device) as tm:
            if probe is None:
                state = model.solve(state, dt, k, tf=tf)
            else:
                state, y = model.solve(state, dt, k, tf=tf, probe=probe)
                ys.append(y)
        walls.append((tm.seconds, k))
        done += k
        print(f"t: {state.t:.5e}, steps: {done}/{num_steps}, "
              f"u[0] = {float(state.u.reshape(-1)[0]):.6e}", flush=True)
    wall = sum(w for w, _ in walls)
    print(f"Solve time: {wall:.3f}")
    print(f"Solve time per step: {wall / max(num_steps, 1):.6f}")
    if len(walls) > 1:
        sw = sum(w for w, _ in walls[1:])
        sk = sum(k for _, k in walls[1:])
        print(f"Solve time per step (steady): {sw / sk:.6f}")
    return state if probe is None else (state, torch.cat(ys))
