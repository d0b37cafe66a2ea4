"""Shared demo runner: argument parser and a chunked solve with progress
prints and per-step timing (CUDA events on the card, the host clock on the
CPU), on one rank or on several (`add_rank_args`, `run_ranks`: the host
model is built once, saved, and every spawned rank builds its part of it
and runs the same chunked solve through ``parallel.multihost.solve_cases``).
Counterpart of ``demos/common.py``."""

from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import numpy as np
import torch


def add_device_args(p: argparse.ArgumentParser,
                    dtype: str = "f32") -> argparse.ArgumentParser:
    """--dtype and --device, shared by every demo."""
    p.add_argument("--dtype", choices=["f32", "f64"], default=dtype)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda = the H100 path (CUDA kernels); cpu = the "
                        "plain torch path (small verification runs)")
    return p


def add_rank_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """--ranks and --backend: the sharded run over spawned ranks."""
    p.add_argument("--ranks", type=int, default=1,
                   help="> 1: domain decomposition over this many spawned "
                        "ranks of torch.distributed")
    p.add_argument("--backend", choices=["gloo", "nccl"], default="gloo",
                   help="gloo: CPU ranks, or ranks that share a card; "
                        "nccl: one card per rank")
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


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """Relative l2 distance of a from b, in float64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def clock(device) -> str:
    """What times a run on `device`: CUDA events on the named card, the
    host clock on the CPU (a CPU number, never a device one)."""
    device = torch.device(device)
    if device.type == "cuda":
        return f"CUDA events on {torch.cuda.get_device_name(device)}"
    return "host clock on the CPU"


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
             probe=None, state=None):
    """Chunked solve from `state` (rest when None), `args.progress_every`
    steps per chunk, progress printed in between.  The last step is
    clamped onto tf = t0 + num_steps*dt.  Returns the final state, or
    (state, ys) with the per-step probe values ys (num_steps, npts) when a
    `probe` is given."""
    state = model.init_state() if state is None else state
    chunk = max(args.progress_every, 1)
    tf = state.t + float(num_steps) * dt
    done = 0
    walls, ys = [], []
    while done < num_steps:
        k = min(chunk, num_steps - done)
        with Timer(model.device) as tm:
            state, y = model.solve(state, dt, k, tf=tf, probe=probe)
            if probe is not None:
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


def run_ranks(model, args, dt: float, num_steps: int, grid=None,
              points=None, timeout: float = 3600.0) -> list[dict]:
    """A demo over `args.ranks` spawned ranks (`args.backend`, ranks on
    `args.device`): the one-rank host `model` is saved once to a temporary
    file that every rank loads and shards as the model runs (its stiffness
    mode), `grid` is the box's rank grid (None for (ranks, 1, 1), or an
    imported mesh).  Every rank runs the chunked solve of `run_demo` (rank
    0 prints the progress).  Returns every rank's result of
    ``parallel.multihost.solve_cases`` (rank 0's holds the collected u and
    the probe trace `ys`)."""
    from fustpu_torch.parallel import multihost

    case = dict(steps=num_steps, dt=dt, grid=grid,
                progress_every=args.progress_every)
    if points is not None:
        case["probe"] = np.asarray(points)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "model.pt"
        torch.save(model, path)
        res = multihost.spawn(
            multihost.solve_cases, args.ranks, args.backend, args.device,
            timeout, args=([dict(case, model=str(path))],))
    return [r[0] for r in res]


def box_rank_grid(ranks: int) -> tuple[int, int, int]:
    """The JAX package's rank grid for a box over `ranks` ranks: (k, 1, 1)
    halved along x into y while it stays even (4 -> (2, 2, 1))."""
    S = [ranks, 1, 1]
    for f in (2, 2):
        if S[0] % f == 0 and S[0] > f:
            S = [S[0] // f, S[1] * f, S[2]]
    return tuple(S)
