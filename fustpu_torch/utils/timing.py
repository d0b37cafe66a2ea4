"""Named timing scopes and their aggregate table (the reference's DOLFINx
`common.Timer` scopes and `list_timings` wall / average table), a
`torch.profiler` trace scope writing a Chrome trace, and `annotate` for
named ranges inside host code.  Counterpart of ``fustpu/utils/timing.py``.

A scope on a CUDA device is timed with CUDA events recorded on the current
stream: entering and leaving it does not wait for the card, and the time
is read (the end event waited for) only when `seconds`, `get_timings` or
`list_timings` asks for it.  Any other scope is timed with the host clock
(a host number, never a device one).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import torch


class Scope:
    """One timed run of a named scope: CUDA events on a CUDA `device`, the
    host clock otherwise.  `seconds` is its elapsed time."""

    def __init__(self, device=None):
        device = None if device is None else torch.device(device)
        self.cuda = device is not None and device.type == "cuda"
        self._seconds = None

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
        else:
            self._seconds = time.perf_counter() - self.t0

    @property
    def seconds(self) -> float:
        if self._seconds is None:
            self.end.synchronize()
            self._seconds = self.start.elapsed_time(self.end) / 1e3
        return self._seconds


_records: dict[str, list[Scope]] = defaultdict(list)


@contextlib.contextmanager
def timer(name: str, device=None):
    """Accumulating named scope; yields its `Scope` (CUDA events when
    `device` is a CUDA device, the host clock otherwise)."""
    scope = Scope(device)
    try:
        with scope:
            yield scope
    finally:
        _records[name].append(scope)


def reset_timings() -> None:
    _records.clear()


def get_timings() -> dict[str, list[float]]:
    """Seconds of every run of every named scope."""
    return {k: [s.seconds for s in v] for k, v in _records.items()}


def list_timings(out=print) -> None:
    """Print the aggregate table (name, reps, total wall, average)."""
    out(f"{'section':<40} {'reps':>5} {'wall [s]':>10} {'avg [s]':>10}")
    for name, ts in sorted(get_timings().items()):
        out(f"{name:<40} {len(ts):>5} {sum(ts):>10.4f} "
            f"{sum(ts)/len(ts):>10.4f}")


@contextlib.contextmanager
def profile_trace(logdir: str):
    """`torch.profiler` scope (host, and the card when there is one);
    writes `<logdir>/trace.json`, a Chrome trace.  Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


annotate = torch.profiler.record_function   # named ranges in host code
