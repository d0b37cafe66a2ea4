"""Single-card capacity run: how large a Westervelt box fits one H100 when
the geometry is corner-streamed (``stiffness_impl="pallas_corner"``).

The G stream (6 values per node, 6.25 GB in float32 at the default 134.5M
DOF) is the largest device allocation of a G-stream model; the corner
stream holds 37 values per cell instead (0.31 GB here), and the kernel
evaluates the metric in registers.  Counterpart of
``demos/exp_capacity.py``, with the JAX package's defaults: 664 x 56 x 56
cells, P = 4, 1.1 MHz in water.

    python -m fustpu_torch.demos.capacity [--cells 664 56 56] [--degree 4]
        [--steps 10] [--impl pallas_corner|auto|mm] [--device cuda|cpu]
        [--dtype f32|f64]

Prints the stiffness operator and its kernel, the host set-up seconds, the
ms/step of a timed solve of --steps steps that follows a warm-up solve of
the same length (CUDA events on the card), the peak device memory and
max |u|.
"""

from __future__ import annotations

import argparse
import resource
import time

import torch

from fustpu_torch.config import Material, Source
from fustpu_torch.demos.common import (Timer, add_device_args, check_device,
                                       pick_dtype)
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.models.discretization import (CornerStiffness,
                                                launch_counts)
from fustpu_torch.models.westervelt import WesterveltModel

MATERIAL = dict(sound_speed=1480.0, density=1000.0, nonlinearity=3.5,
                attenuation_dB=0.2)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--cells", type=int, nargs=3, default=(664, 56, 56))
    p.add_argument("--degree", type=int, default=4)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--impl", default="pallas_corner",
                   choices=["pallas_corner", "auto", "mm"],
                   help="pallas_corner = the corner-streamed kernels; auto "
                        "= the G-stream kernels; mm = the plain version")
    return add_device_args(p)


def describe(model, t_setup: float) -> None:
    """Print the operator, its kernel and the host set-up seconds."""
    steps = ", ".join(f"{k} {v:.1f} s"
                      for k, v in model.disc.host_seconds.items())
    st = model.stiffness
    geo = st.T if isinstance(st, CornerStiffness) else st.G
    print(f"host set-up {t_setup:.1f} s ({steps or 'no geometry pass'}); "
          f"impl {model.impl}, {type(st).__name__}, kernel "
          f"{model.stiffness_kernel}, corner mode "
          f"{isinstance(st, CornerStiffness)}; geometry on the device "
          f"{geo.numel() * geo.element_size() / 1e9:.3f} GB", flush=True)


def timed_run(model, dt: float, steps: int):
    """A warm-up solve of `steps` steps, then a timed solve of the same
    length from its state.  Returns (state, ms per step, peak device
    bytes or None on the CPU, stiffness kernel launches in the timed
    solve)."""
    cuda = model.device.type == "cuda"
    state = model.solve(model.init_state(), dt, steps)
    kernel = model.stiffness_kernel
    before = launch_counts().get(kernel, 0)
    with Timer(model.device) as tm:
        state = model.solve(state, dt, steps)
    ms = tm.seconds / steps * 1e3
    launches = launch_counts().get(kernel, 0) - before
    peak = torch.cuda.max_memory_allocated(model.device) if cuda else None
    umax = float(state.u.abs().max())
    mem = "not measured (cpu)" if peak is None else f"{peak / 1e9:.3f} GB"
    host = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    print(f"{steps} steps after {steps} of warm-up: {ms:.3f} ms/step "
          f"({model.mesh.ndofs / (ms * 1e-3) / 1e9:.3f} GDOF-steps/s); "
          f"peak device memory {mem}; host peak resident "
          f"{host / 1e9:.3f} GB", flush=True)
    if kernel is not None:
        print(f"launches in the timed solve: {kernel} {launches}")
    print(f"|u| max (finite check): {umax:.6e}")
    return state, ms, peak, launches


def build(args):
    """(model, dt, host set-up seconds) for the parsed arguments."""
    nc = tuple(args.cells)
    mesh = build_box_mesh(nc, args.degree, hi=tuple(0.0005 * c for c in nc))
    print(f"cells {nc} P={args.degree}: {mesh.ndofs} DOF", flush=True)
    if args.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = WesterveltModel(mesh, Material(**MATERIAL),
                            Source(frequency=1.1e6, amplitude=1.0e5),
                            mesh.boundary_facets("x-"),
                            mesh.all_boundary_facets(),
                            dtype=pick_dtype(args.dtype), device=args.device,
                            stiffness_impl=args.impl)
    t_setup = time.perf_counter() - t0
    describe(model, t_setup)
    dt, _ = model.cfl_dt(0.4)
    return model, dt, t_setup


def main(argv=None):
    args = parser().parse_args(argv)
    check_device(args)
    model, dt, t_setup = build(args)
    state, ms, peak, launches = timed_run(model, dt, args.steps)
    return model, state, ms, peak, launches, t_setup


if __name__ == "__main__":
    main()
