"""Processes and process groups for the sharded models: one process per
rank over ``torch.distributed``.

`spawn(fn, nprocs, backend, device, timeout, args)` starts `nprocs` ranks
with the ``spawn`` start method (CUDA cannot be used in a forked child),
joins them into one process group and returns `fn(ctx, *args)` of every
rank, in rank order.  The rendezvous is a file in a fresh temporary
directory, never a fixed port.  A rank that raises fails the call with its
traceback; one that hangs past `timeout` (the process group's timeout as
well) is killed and fails it too.

Backends, with no silent switch: `gloo` for ranks on the CPU, `nccl` with
one card per rank (it refuses more ranks than cards), and `gloo` on CUDA
tensors for ranks that share a card.

Counterpart of ``fustpu/parallel/multihost.py``: `initialize`,
`rank_table` / `rank_grid` (the rank order of `dcn_device_grid`: the ranks
of one host innermost), the self-spawned `run_multiprocess_check` and the
separately launched ranks of `run_separate_check`:

    python -m fustpu_torch.parallel.multihost [--nprocs 2] [--grid 2,1,1]
        [--device cuda|cpu] [--separate tcp|env]

checks that a sharded Westervelt solve on k gloo ranks (sharing the card,
or on the CPU) matches the one-rank solve on the same device: spawned
ranks, or with `--separate` k processes launched on their own that join
over ``tcp://127.0.0.1:<free port>`` or ``env://``.  One such rank, on this
host or another (multi-node):

    python -m fustpu_torch.parallel.multihost --init-method tcp://HOST:PORT
        --world-size k --rank r [--device cuda|cpu] [--backend gloo|nccl]
        [--grid 2,1,1]
    torchrun --nnodes N --node-rank R --nproc-per-node m --master-addr HOST
        --master-port PORT -m fustpu_torch.parallel.multihost
        --init-method env:// --backend nccl --grid k,1,1

(``env://`` reads MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE as
torchrun sets them; with nccl a rank takes the card LOCAL_RANK.)  Each rank
builds the check's model and runs its share of the sharded solve; rank 0
holds the collected field against its own one-rank solve.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import os
import queue
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from fustpu_torch.parallel.sharding import RankGrid

BACKENDS = ("gloo", "nccl")


def initialize(init_method: str, world_size: int, rank: int,
               backend: str = "gloo", timeout: float = 600.0) -> None:
    """Join the process group (`init_method`: ``file://...`` or
    ``tcp://host:port``)."""
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))


def rank_table(shape, dcn_axis: int = 0) -> np.ndarray:
    """The (Sx, Sy, Sz) array of the rank holding each block, with the
    ranks of one host innermost: ranks fill the grid in order with
    `dcn_axis` (the axis that crosses hosts) slowest, as the JAX package's
    `dcn_device_grid` orders its devices."""
    order = [dcn_axis] + [a for a in range(3) if a != dcn_axis]
    n = int(np.prod(shape))
    return np.moveaxis(np.arange(n).reshape([shape[a] for a in order]),
                       [0, 1, 2], order)


def rank_grid(shape, device, dcn_axis: int = 0, group=None) -> RankGrid:
    """The calling rank's RankGrid over `rank_table(shape, dcn_axis)`."""
    n = int(np.prod(shape))
    grid = RankGrid(shape=tuple(shape), rank=dist.get_rank(group),
                    device=device, group=group,
                    ranks=rank_table(shape, dcn_axis))
    if dist.get_world_size(group) != n:
        raise ValueError(f"rank grid {tuple(shape)} needs {n} ranks, the "
                         f"process group has {dist.get_world_size(group)}")
    return grid


def rank_device(backend: str, device: str, rank: int,
                nprocs: int) -> torch.device:
    """The device of `rank`: the CPU, its own card (nccl), or a card shared
    round-robin (gloo on CUDA).  Raises where the backend cannot serve."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if device == "cpu":
        if backend != "gloo":
            raise ValueError("ranks on the CPU need the gloo backend")
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device {device!r}: expected 'cpu' or 'cuda'")
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda': no CUDA device is available")
    cards = torch.cuda.device_count()
    if backend == "nccl" and nprocs > cards:
        raise ValueError(f"nccl needs one card per rank: {nprocs} ranks, "
                         f"{cards} card(s) (gloo runs ranks that share a "
                         "card)")
    return torch.device("cuda", rank % cards)


def _worker(rank, nprocs, backend, device, init_method, timeout, fn, args,
            results) -> None:
    torch.set_num_threads(1)
    try:
        dev = rank_device(backend, device, rank, nprocs)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        initialize(init_method, nprocs, rank, backend, timeout)
        try:
            out = fn(SimpleNamespace(rank=rank, size=nprocs, device=dev,
                                     backend=backend), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, nprocs: int, backend: str = "gloo", device: str = "cuda",
          timeout: float = 600.0, args: tuple = ()) -> list:
    """Run `fn(ctx, *args)` on `nprocs` spawned ranks of one process group
    and return each rank's result, in rank order.  `fn` must be importable
    from this package (a child imports only torch and fustpu_torch); `ctx`
    has `rank`, `size`, `device` and `backend`.  The ranks run on the card
    unless `device` is "cpu".  Raises if a rank fails, if the backend
    cannot serve the device (no card, before any rank starts), or after
    `timeout` seconds."""
    for r in range(nprocs):
        rank_device(backend, device, r, nprocs)     # refuse before starting
    if device == "cuda":
        from fustpu_torch import _build

        _build.load()          # build once here, not once per rank
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{Path(tmp) / 'rendezvous'}"
        procs = [ctx.Process(target=_worker, daemon=True, args=(
            r, nprocs, backend, device, init, timeout, fn, args, results))
            for r in range(nprocs)]
        for p in procs:
            p.start()
        out, deadline = {}, time.monotonic() + timeout
        try:
            while len(out) < nprocs:
                left = deadline - time.monotonic()
                if left <= 0:
                    late = sorted(set(range(nprocs)) - set(out))
                    raise TimeoutError(f"ranks {late} did not finish within "
                                       f"{timeout} s")
                try:
                    r, ok, val = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        codes = [procs[r].exitcode for r in dead]
                        raise RuntimeError(f"rank(s) {dead} exited without a "
                                           f"result (exit codes {codes})")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {r} of {nprocs} failed:\n{val}")
                out[r] = val
        finally:
            for p in procs:
                p.join(timeout=0 if len(out) < nprocs else 60)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(nprocs)]


# ---------------------------------------------------------------------------
# Sharded runs of given models (each rank builds its part)
# ---------------------------------------------------------------------------

def sharded_model(model, ctx, grid=None, stiffness_impl=None):
    """This rank's sharded model of `model`: `ShardedModel` on the
    (Sx, Sy, Sz) `grid` for a box mesh, `shard_unstructured` over all ranks
    for an imported one."""
    from fustpu_torch.parallel.extruded import shard_unstructured
    from fustpu_torch.parallel.models import ShardedModel

    if hasattr(model.mesh, "nc"):
        return ShardedModel(model, rank_grid(grid or (ctx.size, 1, 1),
                                             ctx.device),
                            stiffness_impl=stiffness_impl)
    return shard_unstructured(model, rank_grid((ctx.size, 1, 1), ctx.device),
                              stiffness_impl=stiffness_impl or "auto")


def _load(model):
    """A model given directly, or the path of a file `torch.save` wrote
    (loaded onto the CPU: a rank reads only host data from it)."""
    if isinstance(model, (str, Path)):
        return torch.load(model, map_location="cpu", weights_only=False)
    return model


def solve_cases(ctx, cases: list[dict]) -> list[dict]:
    """Runs on every rank.  Each case: `model` (a one-rank model, or the
    path of its saved copy), `steps`, `dt`, and optionally `grid` (box),
    `impl` (the sharded model's stiffness_impl), `state` (a global host
    state (u, v, ku, kv, t) to start from; zero fields otherwise), `probe`
    (points), `norms` (record the global norm of u each step),
    `exchange_reps` (time that many exchanges), `exchange` (False: the
    rank's stiffness module skips the sum of shared entries for this case,
    `Exchanged.exchange` swapped for the identity; the field then differs
    from the one-rank run, and the time is the step's without its
    communication) and `progress_every` (solve
    in chunks of that many steps, the last one clamped onto t0 + steps *
    dt, as the demos do, with rank 0 printing the progress), and the output
    keys of ``demos.common.add_output_args`` (`OUTPUT_KEYS`: each rank
    writes its own per-rank snapshots of u, rank 0 the checkpoints and
    output files of the collected fields; with `progress_every` at their
    cadences, else once, after the timed solve, at its last step).  One
    untimed step runs first.  Each result: the launch counts of the timed
    solve on this rank, ms per step (host clock around the solve), the
    stiffness module and kernel and, on rank 0, the collected final u, v,
    kv, whether each is consistent across owners, the probe and norm
    traces, the weighted global norm of u and ms per exchange."""
    from fustpu_torch.models.discretization import launch_counts
    from fustpu_torch.ops import (cuda_corner, cuda_engine, cuda_extruded,
                                  cuda_indexed, cuda_stiffness)
    from fustpu_torch.utils.io import to_host

    out = []
    for case in cases:
        model = _load(case["model"])
        sm = sharded_model(model, ctx, case.get("grid"), case.get("impl"))
        del model
        if not case.get("exchange", True):
            sm.local.stiffness.exchange = _no_exchange
        state = (sm.split_state(case["state"]) if "state" in case
                 else sm.init_state())
        probes = []
        if "probe" in case:
            probes.append(sm.probe_fn(np.asarray(case["probe"])))
        if case.get("norms"):
            probes.append(sm.norm_probe())
        probe = None if not probes else (
            lambda s: torch.cat([p(s).reshape(-1) for p in probes]))
        sync = (torch.cuda.synchronize if ctx.device.type == "cuda"
                else (lambda: None))
        # one untimed step first: the first collectives and kernel loads
        sm.solve(state, case["dt"], 1, probe=probe)
        for mod in (cuda_stiffness, cuda_extruded, cuda_indexed, cuda_corner,
                    cuda_engine):
            mod.reset_launches()
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        if case.get("progress_every"):
            final, ys = _progress_solve(ctx, sm, state, case, probe)
        else:
            final, ys = sm.solve(state, case["dt"], case["steps"],
                                 probe=probe)
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / max(case["steps"], 1)
        if not case.get("progress_every"):
            _final_writes(sm, final, case)
        launches = {k: v for k, v in launch_counts().items() if v}
        r = {"launches": launches, "ms_per_step": ms,
             "stiffness": type(sm.local.stiffness.inner).__name__,
             "kernel": sm.local.stiffness.kernel,
             "shape": tuple(final.u.shape)}
        reps = case.get("exchange_reps", 0)
        if reps:
            y = torch.ones_like(final.u)
            sm.exchange(y)
            sync()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(reps):
                sm.exchange(y)
            sync()
            r["exchange_ms"] = (time.perf_counter() - t0) * 1e3 / reps
        fields = {name: (sm.collect(getattr(final, name)),
                         sm.consistent(getattr(final, name)))
                  for name in ("u", "v", "kv")}
        norm = sm.global_norm(final.u)
        if ctx.rank == 0:
            for name, (full, ok) in fields.items():
                r[name], r[f"{name}_consistent"] = full, ok
            r["t"] = final.t
            r["norm"] = norm
            if ys is not None:
                r["ys"] = to_host(ys)
        out.append(r)
    return out


def _no_exchange(y: torch.Tensor) -> torch.Tensor:
    """The exchange of a case run without one: the local operator's
    output as it is."""
    return y


def _final_writes(sm, final, case) -> None:
    """A case's per-rank snapshot (`dist_output`) and rank-0 checkpoint
    (`checkpoint`) of its final state, at its last step."""
    from fustpu_torch.utils import io as fio
    from fustpu_torch.utils.dist_io import ShardSnapshotWriter

    step = case["steps"]
    if case.get("dist_output"):
        ShardSnapshotWriter(case["dist_output"], sm).write(
            f"u_{step:06d}", final.u)
    if case.get("checkpoint"):
        fields = [sm.collect(f) for f in final[:4]]
        if sm.grid.rank == 0:
            fio.save_checkpoint(f"{case['checkpoint']}_{step}",
                                (*fields, final.t), step)


def _progress_solve(ctx, sm, state, case, probe):
    """The demos' chunked solve (``demos.common.run_demo``) of a case on
    this rank, (state, ys) as `solve` returns them; rank 0 prints, the
    other ranks run the same loop quietly."""
    from fustpu_torch.demos.common import OUTPUT_KEYS, run_demo

    quiet = contextlib.redirect_stdout(io.StringIO())
    with quiet if ctx.rank else contextlib.nullcontext():
        print(f"rank 0 of {ctx.size} on {ctx.device} ({ctx.backend}): "
              f"stiffness {type(sm.local.stiffness.inner).__name__}, "
              f"kernel {sm.local.stiffness.kernel}", flush=True)
        res = run_demo(sm, case["dt"], case["steps"],
                       SimpleNamespace(**{k: case[k] for k in OUTPUT_KEYS
                                          if k in case},
                                       progress_every=case["progress_every"]),
                       "ranks", probe=probe, state=state)
    return res if probe is not None else (res, None)


def imported_modules(ctx) -> list[str]:
    """The names of the modules a rank has imported (a rank imports only
    torch and fustpu_torch)."""
    return sorted(sys.modules)


# ---------------------------------------------------------------------------
# Self-contained multi-process check
# ---------------------------------------------------------------------------

def _check_model(device: str):
    """A small float64 Westervelt box model on `device`."""
    from fustpu_torch.config import Material, Source
    from fustpu_torch.mesh.box import build_box_mesh
    from fustpu_torch.models.westervelt import WesterveltModel

    mat = Material(sound_speed=1480.0, density=1000.0, nonlinearity=3.5,
                   attenuation_dB=0.2)
    src = Source(frequency=1.1e6, amplitude=1.0e5)
    mesh = build_box_mesh((6, 4, 2), 3, hi=(0.006, 0.006, 0.006))
    return WesterveltModel(mesh, mat, src, mesh.boundary_facets("x-"),
                           mesh.all_boundary_facets(), dtype=torch.float64,
                           device=device)


def run_multiprocess_check(nprocs: int = 2, grid_shape=(2, 1, 1),
                           steps: int = 4, timeout: float = 300.0,
                           device: str = "cuda") -> float:
    """Spawn `nprocs` gloo ranks on `device` (ranks on the card share it)
    and check that the sharded solve of a small Westervelt box equals the
    one-rank solve on the same device (rel-l2 <= 1e-12) with shared planes
    bitwise consistent — the `mpirun -n k` check of the reference, without
    MPI.  Returns the relative error."""
    model = _check_model(device)
    dt, _ = model.cfl_dt(0.4)
    ref = model.solve(model.init_state(), dt, steps)[0].u.cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "model.pt")       # the ranks load host data
        torch.save(model, path)
        res = spawn(solve_cases, nprocs, "gloo", device, timeout, args=(
            [dict(model=path, grid=tuple(grid_shape), steps=steps,
                  dt=dt)],))
    r = res[0][0]
    err = float(np.linalg.norm(r["u"] - ref) / np.linalg.norm(ref))
    if not (err <= 1e-12 and r["u_consistent"] and r["kv_consistent"]):
        raise RuntimeError(f"sharded vs one-rank rel-l2 {err:.3e}, "
                           f"consistent {r['u_consistent']}")
    return err


# ---------------------------------------------------------------------------
# Separately launched ranks (multi-node)
# ---------------------------------------------------------------------------

CHECK_TOL = 1e-12
ROOT = Path(__file__).resolve().parents[2]


def run_worker(init_method: str, world_size: int | None = None,
               rank: int | None = None, device: str = "cuda",
               backend: str = "gloo", grid_shape=None, steps: int = 4,
               timeout: float = 300.0) -> float | None:
    """One separately launched rank of the check: joins the process group
    at `init_method` (``tcp://HOST:PORT`` with `world_size` and `rank`, or
    ``env://`` with RANK and WORLD_SIZE from the environment), builds the
    check's model, runs its share of the sharded solve, and on rank 0
    holds the collected field against its own one-rank solve (rel-l2 <=
    CHECK_TOL, shared entries bitwise consistent).  Returns rank 0's
    relative error (None on the other ranks); raises if the check
    fails."""
    if init_method.startswith("env://"):
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                      else world_size)
    if rank is None or world_size is None:
        raise ValueError(f"{init_method}: give the world size and the rank")
    # this host's ranks share its cards as spawned ranks do (nccl: the card
    # LOCAL_RANK, refused past the host's cards)
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = rank_device(backend, device, local, local + 1)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.set_num_threads(1)
    model = _check_model(str(dev))
    dt, _ = model.cfl_dt(0.4)
    ref = model.solve(model.init_state(), dt, steps)[0].u.cpu().numpy()
    initialize(init_method, world_size, rank, backend, timeout)
    try:
        ctx = SimpleNamespace(rank=rank, size=world_size, device=dev,
                              backend=backend)
        r = solve_cases(ctx, [dict(model=model, grid=grid_shape or (
            world_size, 1, 1), steps=steps, dt=dt)])[0]
    finally:
        dist.destroy_process_group()
    if rank != 0:
        return None
    err = float(np.linalg.norm(r["u"] - ref) / np.linalg.norm(ref))
    if not (err <= CHECK_TOL and r["u_consistent"] and r["kv_consistent"]):
        raise RuntimeError(f"sharded vs one-rank rel-l2 {err:.3e}, "
                           f"consistent {r['u_consistent']}")
    return err


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_separate_check(nprocs: int = 2, grid_shape=(2, 1, 1),
                       device: str = "cuda", init: str = "tcp",
                       timeout: float = 300.0) -> float:
    """Launch `nprocs` gloo ranks as separate processes on 127.0.0.1 (the
    JAX package's separately launched form of the check, here
    ``python -m fustpu_torch.parallel.multihost --init-method ...``), over
    ``tcp://127.0.0.1:<free port>`` (`init` "tcp") or ``env://`` with the
    variables torchrun sets (`init` "env"), and return rank 0's relative
    error against the one-rank solve.  A rank that fails, or that has not
    finished after `timeout` seconds, fails the call with every rank's
    output; the others are killed."""
    if init not in ("tcp", "env"):
        raise ValueError(f"init {init!r}: expected 'tcp' or 'env'")
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
    base = [sys.executable, "-m", "fustpu_torch.parallel.multihost",
            "--device", device, "--backend", "gloo",
            "--grid", ",".join(map(str, grid_shape)),
            "--timeout", str(timeout)]
    procs, logs, failed = [], [], None
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for r in range(nprocs):
                if init == "tcp":
                    cmd = base + ["--init-method",
                                  f"tcp://127.0.0.1:{port}",
                                  "--world-size", str(nprocs),
                                  "--rank", str(r)]
                    renv = env
                else:
                    cmd = base + ["--init-method", "env://"]
                    renv = dict(env, MASTER_ADDR="127.0.0.1",
                                MASTER_PORT=str(port), RANK=str(r),
                                WORLD_SIZE=str(nprocs), LOCAL_RANK=str(r))
                logs.append(open(Path(tmp) / f"rank{r}.log", "w+"))
                procs.append(subprocess.Popen(
                    cmd, cwd=ROOT, env=renv, stdout=logs[-1],
                    stderr=subprocess.STDOUT, text=True))
            deadline = time.monotonic() + timeout
            while failed is None:
                bad = [r for r, p in enumerate(procs)
                       if p.poll() not in (None, 0)]
                if bad:
                    failed = f"rank(s) {bad} failed"
                elif all(p.returncode == 0 for p in procs):
                    break
                elif time.monotonic() > deadline:
                    failed = f"ranks not finished within {timeout} s"
                else:
                    time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            outs = []
            for f in logs:
                f.seek(0)
                outs.append(f.read())
                f.close()
    if failed:
        raise RuntimeError(f"{failed}:\n" + "\n".join(
            f"--- rank {r}:\n{o[-3000:]}" for r, o in enumerate(outs)))
    for r, out in enumerate(outs):
        if f"multihost rank {r}/{nprocs} OK" not in out:
            raise RuntimeError(f"rank {r} printed no result:\n{out[-3000:]}")
    return float(outs[0].split("rel-l2 ")[1].split()[0].rstrip(","))


def _main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--grid", default="2,1,1")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: gloo ranks sharing the card (nccl: a card "
                         "each); cpu: gloo ranks on the CPU")
    ap.add_argument("--separate", choices=["tcp", "env"], default=None,
                    help="launch the --nprocs ranks as separate processes "
                         "joining over tcp:// or env:// (not spawned)")
    ap.add_argument("--init-method", default=None,
                    help="run as one separately launched rank: "
                         "tcp://HOST:PORT (with --world-size, --rank) or "
                         "env:// (torchrun's variables)")
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--backend", choices=list(BACKENDS), default="gloo")
    ap.add_argument("--timeout", type=float, default=300.0)
    a = ap.parse_args(argv)
    grid = tuple(int(x) for x in a.grid.split(","))
    if a.init_method:
        err = run_worker(a.init_method, a.world_size, a.rank, a.device,
                         a.backend, grid, timeout=a.timeout)
        rank = int(os.environ.get("RANK", 0)) if a.rank is None else a.rank
        world = (int(os.environ.get("WORLD_SIZE", 0)) if a.world_size is None
                 else a.world_size)
        tail = ("" if err is None else
                f": sharded == one-rank, rel-l2 {err:.3e}, shared entries "
                "consistent")
        print(f"multihost rank {rank}/{world} OK ({a.backend} on "
              f"{a.device}){tail}", flush=True)
        return
    if a.separate:
        err = run_separate_check(a.nprocs, grid, a.device, a.separate,
                                 a.timeout)
        how = f"separately launched over {a.separate}://"
    else:
        err = run_multiprocess_check(a.nprocs, grid, device=a.device)
        how = "spawned"
    print(f"{a.nprocs} ranks on {a.device} ({how}): sharded == one-rank, "
          f"rel-l2 {err:.3e}")


if __name__ == "__main__":
    _main()
