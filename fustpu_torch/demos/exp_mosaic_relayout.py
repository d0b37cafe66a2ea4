"""Relayout probe: the cost of the pure permutations a fused engine
kernel would need, over 128 tiles of (8192, 1) float32: a reshape to
(64, 128), its reverse, a transpose to (128, 64) and a copy; then the
device bytes that a (2^20, 1) array takes against a (2^13, 128) one.
Counterpart of ``demos/exp_mosaic_relayout.py`` (a TPU sublane -> lane
relayout probe); runs on the card unless --device cpu is given (the plain
versions, a correctness run only).

    python -m fustpu_torch.demos.exp_mosaic_relayout [--turns]
    python -m fustpu_torch.demos.exp_mosaic_relayout --tiles 16384 \
        --turns --enqueues 0

Prints, for each permutation, the ms per call, the rate, whether it is
bitwise the plain version's result and whether it is a permutation
(sorted-ok), then the device bytes of the two shapes.  With --turns, on
the card: for the copy and the transpose, the first design's kernel
(old), the kernel (new) and the PyTorch call that computes the same
permutation (library: `clone`, `.transpose().contiguous()`) timed by CUDA
events in three rounds of turns (old, new, new, old, library), each
against the others bitwise; then, unless --enqueues is 0, the host clock per call over
--enqueues calls without a synchronise, and the device time per call from
torch.profiler's trace.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import torch

from fustpu_torch.demos.common import check_device, clock
from fustpu_torch.ops import probes
from fustpu_torch.utils.benchmarks import time_apply

LABELS = {"reshape": "reshape (8192,1)->(64,128)",
          "reverse": "reshape via (64,128)->(8192,1)",
          "transpose": "reshape+transpose ->(128,64)",
          "copy": "copy (8192,1)"}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tiles", type=int, default=128)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--chain", type=int, default=20)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--turns", action="store_true",
                   help="time old, new and the PyTorch call in turns")
    p.add_argument("--enqueues", type=int, default=10000,
                   help="calls of each variant on the host clock in the "
                        "--turns run (0: no host-clock or profiler run)")
    return p


# The variants of the --turns run: f(kind, x).
VARIANTS = {
    "old": lambda k, x: probes.relayout_flat(x, k),
    "new": lambda k, x: probes.relayout(x, k),
    "library": lambda k, x: x.clone() if k == "copy" else x.reshape(
        -1, probes.TM // probes.LANES, probes.LANES).transpose(1, 2)
    .contiguous(),
}
TURNS = ("old", "new", "new", "old", "library")
ROUNDS = 3                    # of TURNS, for the CUDA events' readings


def host_us(fn, calls: int) -> float:
    """Host clock per call over `calls` calls without a synchronise (after
    one call and a synchronise), in microseconds."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def device_us(fn, calls: int) -> dict:
    """Device time per call from torch.profiler's trace over `calls`
    calls: the kernels', copies' and memsets' durations summed, in
    microseconds, and the names of the device events."""
    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    return {"us": sum(float(e.get("dur", 0.0)) for e in dev) / calls
            if dev else None,
            "events": len(dev) / calls,
            "names": sorted({e.get("name", "")[:60] for e in dev})}


def in_turns(x: torch.Tensor, chain: int, reps: int, enqueues: int
             ) -> dict:
    """For the copy and the transpose of x: each variant's ms per call by
    CUDA events in ROUNDS rounds of turns (lists in TURNS order), checked
    bitwise against the new kernel's output; with `enqueues`, the
    host-clock microseconds per call in turns and the profiler's device
    microseconds per call."""
    out = {}
    for kind in ("copy", "transpose"):
        y = probes.relayout(x, kind)
        for name in ("old", "library"):
            if not torch.equal(VARIANTS[name](kind, x).reshape(y.shape), y):
                raise SystemExit(f"relayout {kind}: {name} not bitwise the "
                                 "kernel's")
        ms = {name: [] for name in VARIANTS}
        for name in TURNS * ROUNDS:
            ms[name].append(time_apply(VARIANTS[name], kind, x, chain=chain,
                                       reps=reps)[0] * 1e3)
        host = {name: [] for name in VARIANTS} if enqueues else {}
        device = {}
        if enqueues:
            for name in TURNS:
                host[name].append(host_us(
                    lambda f=VARIANTS[name]: f(kind, x), enqueues))
            for name, f in VARIANTS.items():
                device[name] = device_us(lambda: f(kind, x), 50)
        out[kind] = dict(ms=ms, host_us=host, device=device)
        print(f"{kind}, {ROUNDS} rounds in turns (old, new, new, old, "
              f"library), ms per call: "
              + "; ".join(f"{name} " + " ".join(f"{m:.4f}" for m in v)
                          for name, v in ms.items()), flush=True)
        for name in VARIANTS if enqueues else ():
            print(f"   {name}: host "
                  + " / ".join(f"{h:.3f}" for h in host[name])
                  + f" us per call over {enqueues} calls (in turns); device "
                  f"{device[name]['us']} us per call in "
                  f"{device[name]['events']:g} event(s) "
                  f"{device[name]['names']}", flush=True)
    return out


def device_bytes(shape, device) -> int | None:
    """Device bytes that allocating a float32 tensor of `shape` adds (None
    off the card)."""
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    a = torch.zeros(shape, dtype=torch.float32, device=device)
    torch.cuda.synchronize(device)
    used = torch.cuda.memory_allocated(device) - before
    del a
    return used


def main(argv=None) -> dict:
    """Returns the input, and by kind the output, the plain version's, and
    the (median, std) seconds per call; the device bytes of the two
    shapes of check 5; and with --turns the `in_turns` readings."""
    args = parser().parse_args(argv)
    check_device(args)
    dev = torch.device(args.device)
    n = args.tiles * probes.TM
    x = torch.arange(n, dtype=torch.float32, device=dev).reshape(-1, 1)
    outs, plains, times = {}, {}, {}
    for kind in probes.KINDS:
        outs[kind] = y = probes.relayout(x, kind)
        plains[kind] = probes.relayout_plain(x, kind)
        times[kind] = time_apply(lambda k, v: probes.relayout(v, k), kind,
                                 x, chain=args.chain, reps=args.reps)
        same = bool(torch.equal(y, plains[kind]))
        ok = bool(torch.equal(torch.sort(y.reshape(-1)).values,
                              x.reshape(-1)))
        dt = times[kind][0] * 1e3
        print(f"{LABELS[kind]:<40} {dt:8.4f} ms/call  ({n / 1e6:.1f}M "
              f"elems, {n / dt / 1e6:.0f} M/ms) bitwise-plain={same} "
              f"sorted-ok={ok}", flush=True)
    col = device_bytes((1 << 20, 1), dev)
    packed = device_bytes((1 << 13, 128), dev)
    if col is None:
        print("device bytes: not measured on the CPU")
    else:
        print(f"device bytes for (2^20, 1) f32: {col:,} (logical "
              f"{4 << 20:,}); for (2^13, 128): {packed:,}")
    print(f"   timed by {clock(dev)}")
    turns = None
    if args.turns:
        if dev.type != "cuda":
            raise SystemExit("--turns times the kernels: it needs the card")
        turns = in_turns(x, args.chain, args.reps, args.enqueues)
    return dict(x=x, outs=outs, plains=plains, times=times,
                bytes={"column": col, "packed": packed}, turns=turns)


if __name__ == "__main__":
    main()
