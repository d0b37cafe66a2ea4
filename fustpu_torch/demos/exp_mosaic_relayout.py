"""Relayout probe: the cost of the pure permutations a fused engine
kernel would need, over 128 tiles of (8192, 1) float32: a reshape to
(64, 128), its reverse, a transpose to (128, 64) and a copy; then the
device bytes that a (2^20, 1) array takes against a (2^13, 128) one.
Counterpart of ``demos/exp_mosaic_relayout.py`` (a TPU sublane -> lane
relayout probe); runs on the card unless --device cpu is given (the plain
versions, a correctness run only).

    python -m fustpu_torch.demos.exp_mosaic_relayout

Prints, for each permutation, the ms per call, the rate, whether it is
bitwise the plain version's result and whether it is a permutation
(sorted-ok), then the device bytes of the two shapes.
"""

from __future__ import annotations

import argparse

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
    return p


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
    the (median, std) seconds per call; and the device bytes of the two
    shapes of check 5."""
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
    return dict(x=x, outs=outs, plains=plains, times=times,
                bytes={"column": col, "packed": packed})


if __name__ == "__main__":
    main()
