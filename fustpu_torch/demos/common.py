"""Shared demo runner: argument parser and a chunked solve with progress
prints, named timings (CUDA events on the card, the host clock on the
CPU), checkpoints, snapshots, probe traces and the final VTK file, on one
rank or on several (`add_rank_args`, `run_ranks`: the host model is built
once, saved, and every spawned rank builds its part of it and runs the
same chunked solve through ``parallel.multihost.solve_cases``).
Counterpart of ``demos/common.py``.
"""

from __future__ import annotations

import argparse
import math
import tempfile
from pathlib import Path

import numpy as np
import torch

from fustpu_torch.utils import io as fio
from fustpu_torch.utils import timing


# the JAX package's --dtype names
DTYPES = ["f32", "f64", "bf16"]


def add_device_args(p: argparse.ArgumentParser,
                    dtype: str = "f32") -> argparse.ArgumentParser:
    """--dtype and --device, shared by every demo.  bf16 stores the state,
    G (or the corner channels) and the diagonals in bfloat16 and runs the
    bfloat16 forms of the G-stream kernels (#1 / #2, #6, #11), of the
    corner walk (#3, #6c) and of the staged engine (#7-#10)."""
    p.add_argument("--dtype", choices=DTYPES, default=dtype)
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


# the options of `add_output_args` that a run over ranks hands every rank
OUTPUT_KEYS = ("output", "checkpoint", "checkpoint_every", "snapshot_every",
               "dist_output")


def add_output_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """--output, --checkpoint, --checkpoint-every, --snapshot-every,
    --dist-output and --probe: what a run writes."""
    p.add_argument("--output", default="",
                   help="output path prefix: the final VTK file, probe "
                        "traces and plane snapshots ('' = no output)")
    p.add_argument("--checkpoint", default="",
                   help="checkpoint path prefix ('' = off): "
                        "<prefix>_<step>.npz every --checkpoint-every "
                        "steps (a sharded run: rank 0 writes the "
                        "collected state)")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--snapshot-every", type=int, default=0,
                   help="every N steps: a pressure-plane point cloud "
                        "with --output, per-rank field files with "
                        "--dist-output")
    p.add_argument("--dist-output", default="",
                   help="sharded runs: directory of per-rank snapshots of "
                        "u every --snapshot-every steps, with no gather; "
                        "reassemble with fustpu_torch.utils.dist_io"
                        ".assemble_snapshot")
    p.add_argument("--probe", type=float, nargs=3, action="append",
                   default=None, metavar=("X", "Y", "Z"),
                   help="record u at a point every step (a hydrophone "
                        "trace; repeatable), written with --output")
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
    add_output_args(p)
    return add_device_args(p, defaults.get("dtype", "f32"))


def pick_dtype(name: str) -> torch.dtype:
    return {"f32": torch.float32, "f64": torch.float64,
            "bf16": torch.bfloat16}[name]


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


def _gcd_chunk(args) -> int:
    """Steps a chunk: one that hits every requested cadence exactly."""
    chunk = max(args.progress_every, 1)
    snaps = args.output or args.dist_output
    for c in (args.checkpoint_every if args.checkpoint else 0,
              args.snapshot_every if snaps else 0):
        if c:
            chunk = math.gcd(chunk, c)
    return max(chunk, 1)


def output_args(args) -> argparse.Namespace:
    """`args` with every option of `add_output_args` (absent ones at
    their defaults): a caller may hand run_demo a namespace of its own."""
    ns = add_output_args(argparse.ArgumentParser()).parse_args([])
    ns.progress_every = 100
    ns.__dict__.update(vars(args))
    return ns


def _point_sampler(mesh, points):
    from fustpu_torch.mesh.unstructured import UPointSampler
    from fustpu_torch.utils.eval import PointSampler

    return (PointSampler if hasattr(mesh, "nc") else UPointSampler)(
        mesh, np.asarray(points, np.float64))


class _PlaneSnapshot:
    """The snapshots' 179 x 179 plane through the middle z of the mesh's
    bounding box: points outside a curved domain (the bowl's cap) read
    NaN."""

    def __init__(self, mesh):
        from fustpu_torch.utils import eval as fev

        zc = (mesh.lo[2] + mesh.hi[2]) / 2
        self.points = fev.plane_points(mesh, axis=2, coord=zc, n0=179,
                                       n1=179)
        self.inside = (fev.locate(mesh, self.points)[2]
                       if hasattr(mesh, "nc") else
                       mesh.locate(self.points)[2])
        self.sampler = _point_sampler(mesh, self.points[self.inside])

    def sample(self, u) -> np.ndarray:
        out = np.full(len(self.points), np.nan)
        out[self.inside] = self.sampler.sample(u)
        return out


def run_demo(model, dt: float, num_steps: int, args, name: str,
             probe=None, state=None):
    """Chunked solve from `state` (rest when None), the last step clamped
    onto tf = t0 + num_steps dt; a one-rank model or one rank's part of a
    sharded one (every rank runs this; rank 0 writes what the ranks
    collect).  A chunk is the gcd of `args.progress_every` and the
    cadences asked for (`_gcd_chunk`).  Between chunks, at their steps:
    progress prints, npz checkpoints (`--checkpoint`), plane point clouds
    (`--output` with `--snapshot-every`; NaN outside the domain) and
    per-rank snapshots (`--dist-output`); none of them counts in the
    solve time, which the chunks' "~ solve chunk" timings give.  After
    the run: the `--probe` trace and the final VTK file (structured on a
    box, full-GLL unstructured on an imported mesh) with `--output`, then
    the timing table.  Returns the final state, or (state, ys) with the per-step
    values ys (num_steps, npts) of the caller's `probe`."""
    args = output_args(args)
    sharded = hasattr(model, "collect")
    writer = not sharded or model.grid.rank == 0
    host = model.collect if sharded else fio.to_host
    state = model.init_state() if state is None else state
    probes = [] if probe is None else [probe]
    if args.probe:
        pts = np.asarray(args.probe, np.float64)
        pfn = (model.probe_fn(pts) if sharded else
               _point_sampler(model.mesh, pts).torch_probe(model.device))
        probes.append(pfn if sharded else (lambda s: pfn(s.u)))
    both = None if not probes else (
        lambda s: torch.cat([p(s).reshape(-1) for p in probes]))
    chunk = _gcd_chunk(args)
    every = max(args.progress_every, 1)
    t0 = state.t
    tf = t0 + float(num_steps) * dt
    done = 0
    walls, ys = [], []
    sampler = dist_writer = None
    while done < num_steps:
        k = min(chunk, num_steps - done)
        with timing.timer("~ solve chunk", model.device) as tm:
            state, y = model.solve(state, dt, k, tf=tf, probe=both)
        if both is not None:
            ys.append(y)
        walls.append((tm, k))
        done += k
        if done % every == 0 or done >= num_steps:
            print(f"t: {state.t:.5e}, steps: {done}/{num_steps}, "
                  f"u[0] = {float(state.u.reshape(-1)[0]):.6e}", flush=True)
        if args.checkpoint and args.checkpoint_every and \
                done % args.checkpoint_every == 0:
            with timing.timer("~ checkpoint"):
                fields = [host(f) for f in state[:4]]
                if writer:
                    fio.save_checkpoint(f"{args.checkpoint}_{done}",
                                        (*fields, state.t), done)
        snap = args.snapshot_every and done % args.snapshot_every == 0
        if snap and args.dist_output and sharded:
            with timing.timer("~ snapshot (per-rank)"):
                if dist_writer is None:
                    from fustpu_torch.utils.dist_io import \
                        ShardSnapshotWriter

                    dist_writer = ShardSnapshotWriter(args.dist_output,
                                                      model)
                dist_writer.write(f"u_{done:06d}", state.u)
        if snap and args.output:
            with timing.timer("~ snapshot (plane eval)"):
                if sampler is None:
                    sampler = _PlaneSnapshot(model.mesh)
                u = host(state.u)
                if writer:
                    fio.save_point_cloud(
                        f"{args.output}_{name}_snap_{done}.txt",
                        sampler.points, sampler.sample(u), cols=(0, 1))
    wall = sum(tm.seconds for tm, _ in walls)
    print(f"Solve time: {wall:.3f}")
    print(f"Solve time per step: {wall / max(num_steps, 1):.6f}")
    if len(walls) > 1:
        sw = sum(tm.seconds for tm, _ in walls[1:])
        sk = sum(k for _, k in walls[1:])
        print(f"Solve time per step (steady): {sw / sk:.6f}")
    trace = None if both is None else torch.cat(ys)
    if args.probe and args.output and writer:
        npts = len(args.probe)
        ts = t0 + np.arange(1, num_steps + 1)[:, None] * dt
        path = f"{args.output}_{name}_probe.txt"
        np.savetxt(path, np.hstack(
            [np.minimum(ts, tf), fio.to_host(trace[:, -npts:]).astype(
                np.float64)]), delimiter=",",
            header="t, p(probe_0), p(probe_1), ...")
        print(f"wrote {path}")
    if args.output:
        with timing.timer("~ output (vtk)"):
            fields = {"u": host(state.u), "v": host(state.v)}
            if writer:
                path = fio.write_vtk(f"{args.output}_{name}", model.mesh,
                                     fields)
        if writer:
            print(f"wrote {path}")
    timing.list_timings()
    if probe is None:
        return state
    return state, trace[:, :trace.shape[1] - (len(args.probe or ()))]


def run_ranks(model, args, dt: float, num_steps: int, grid=None,
              points=None, timeout: float = 3600.0) -> list[dict]:
    """A demo over `args.ranks` spawned ranks (`args.backend`, ranks on
    `args.device`): the one-rank host `model` is saved once to a temporary
    file that every rank loads and shards as the model runs (its stiffness
    mode), `grid` is the box's rank grid (None for (ranks, 1, 1), or an
    imported mesh).  Every rank runs the chunked solve of `run_demo` (rank
    0 prints the progress), with the output options of `args`: each rank
    writes its own `--dist-output` files, rank 0 the checkpoints and
    `--output` files of the collected fields.  Returns every rank's result of
    ``parallel.multihost.solve_cases`` (rank 0's holds the collected u and
    the probe trace `ys`)."""
    from fustpu_torch.parallel import multihost

    case = dict(steps=num_steps, dt=dt, grid=grid,
                progress_every=args.progress_every)
    out = output_args(args)
    case.update({k: getattr(out, k) for k in OUTPUT_KEYS if getattr(out, k)})
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
