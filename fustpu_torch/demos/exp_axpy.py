"""The RK4 update kernel (``csrc/vector.cu``, `cuda_vector.axpy`: out = y +
alpha x, alpha read from the card) against PyTorch's add with the
coefficient as a Python float, on the device alone: no host time in
either number.

    python -m fustpu_torch.demos.exp_axpy [--n 6661697] [--dtypes f32 bf16]
        [--launches 100] [--turns 2] [--device cpu]

For each dtype and each form, `out` (a new output) and `in place` (out is
y, as the captured solve calls it):

- the kernel against `torch.add(y, x, alpha=a)` (bitwise);
- `graph`: a CUDA graph of `--launches` launches of each, replayed and
  timed by CUDA events, ms a launch, in turns (kernel, add, add, kernel,
  `--turns` times).  The launches follow one another on the same arrays,
  so what the L2 keeps of them stays warm (at 6,661,697 values the
  float32 arrays, 80 MB, exceed the 50 MB L2; the bfloat16 ones, 40 MB,
  fit in it);
- `cold`: each launch after a 64 MiB fill that evicts the arrays, the
  kernels' own device intervals from torch.profiler's trace, in the
  same turns, us a launch (what a solve's update sees between stiffness
  applies); "not measured" where the trace holds no device interval;

beside the least time of the update, its bytes (x and y read, out
written once: 3 values a value) at 3.35 TB/s.  On the CPU there is no
graph and no device: the kernel's plain version against `torch.add`
(bitwise), and no time is printed.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np
import torch

from fustpu_torch.demos.common import check_device, clock
from fustpu_torch.ops import cuda_vector as cv

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
          "f64": torch.float64}
FLUSH_BYTES = 64 << 20           # larger than the H100's 50 MB L2


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=6_661_697)
    p.add_argument("--dtypes", nargs="+", default=["f32", "bf16"],
                   choices=list(DTYPES))
    p.add_argument("--launches", type=int, default=100)
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def _graph(fn, launches: int):
    """A CUDA graph of `launches` calls of fn(), captured on a side
    stream after one warm-up call there."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    return g


def _replay_ms(g, launches: int) -> float:
    """ms a launch of one replay of `g`, by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def _cold_us(fns: dict, launches: int, order) -> dict:
    """{name: [us a launch]}: for each name of `order` in turn,
    `launches` calls of fns[name] each after a fill of FLUSH_BYTES, under
    torch.profiler; the mean device interval of the kernels that are not
    the fill's.  None where the trace holds none."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    out = {name: [] for name in fns}
    for name in order:
        fn = fns[name]
        fn()
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            trace = Path(tmp) / "trace.json"
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(launches):
                    flush.zero_()
                    fn()
                torch.cuda.synchronize()
            prof.export_chrome_trace(str(trace))
            events = json.loads(trace.read_text())["traceEvents"]
        durs = [float(e.get("dur", 0.0)) for e in events
                if e.get("ph") == "X" and e.get("cat") == "kernel"
                and "Fill" not in e.get("name", "")
                and "fill" not in e.get("name", "")]
        out[name].append(sum(durs) / len(durs) if durs else None)
    return out


def run(n: int, device, dtypes=("f32", "bf16"), launches: int = 100,
        turns: int = 2, cold: bool = True) -> dict:
    """{(dtype name, form): {"bitwise", "graph": {kernel, add: [ms]},
    "cold": {kernel, add: [us or None]} (with `cold`), "bound_ms"}}."""
    card = torch.device(device).type == "cuda"
    rng = np.random.default_rng(35)
    print(f"{n:,} values; timed by {clock(device)}", flush=True)
    out = {}
    for name in dtypes:
        dtype = DTYPES[name]
        x0, y0 = (torch.as_tensor(rng.standard_normal(n), device=device)
                  .to(dtype) for _ in range(2))
        a = torch.tensor(0.37, device=device,
                         dtype=cv.coefficient_dtype(dtype))
        alpha = float(a)
        bound = 3 * n * x0.element_size() / PEAK_BYTES_PER_S * 1e3
        for form in ("out", "in place"):
            x, y = x0.clone(), y0.clone()
            o = y if form == "in place" else torch.empty_like(y)
            ref = (torch.add(y0, x, alpha=alpha) if card else
                   torch.add(y0.double(), x.double(), alpha=alpha).to(dtype))
            same = torch.equal(cv.axpy(a, x, y0.clone()), ref)
            row = {"bitwise": same, "bound_ms": bound}
            out[name, form] = row
            print(f"{name} {form}: the kernel bitwise torch.add: {same}",
                  flush=True)
            if not card:
                continue
            fns = {"kernel": lambda: cv.axpy(a, x, y, o),
                   "add": lambda: torch.add(y, x, alpha=alpha, out=o)}
            order = ("kernel", "add", "add", "kernel") * turns
            graphs = {k: _graph(f, launches) for k, f in fns.items()}
            row["graph"] = {k: [] for k in fns}
            for k in order:
                row["graph"][k].append(_replay_ms(graphs[k], launches))
            del graphs
            g = row["graph"]
            fmt = lambda v: "not measured" if v is None else f"{v:.2f}"
            text = ""
            if cold:
                c = row["cold"] = _cold_us(fns, launches, order)
                text = (f"; cold (after a {FLUSH_BYTES >> 20} MiB fill, the "
                        "profiler's kernel intervals), us a launch: kernel "
                        + " / ".join(fmt(v) for v in c["kernel"])
                        + ", torch.add "
                        + " / ".join(fmt(v) for v in c["add"]))
            print(f"{name} {form}: graph of {launches}, ms a launch in "
                  f"turns: kernel "
                  + " / ".join(f"{v:.4f}" for v in g["kernel"])
                  + ", torch.add " + " / ".join(f"{v:.4f}" for v in g["add"])
                  + text + f"; bound {bound:.4f} ms "
                  f"({3 * n * x0.element_size():,} B)", flush=True)
    return out


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    check_device(args)
    return run(args.n, torch.device(args.device), args.dtypes,
               args.launches, args.turns)


if __name__ == "__main__":
    main()
