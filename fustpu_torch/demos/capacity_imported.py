"""Single-card capacity run for an imported prismatic mesh: how large a
Westervelt cylinder fits one H100 with the corner-streamed extruded kernel
(``stiffness_impl="pallas_corner"``).

The G-stream extruded operator stores 6 values per node (4.1 GB in float32
at the default ~100M DOF); the corner stream stores 37 per cell instead.
Counterpart of ``demos/exp_capacity_imported.py``, with its defaults: the
butterfly O-grid cylinder (radius 35 mm, length 120 mm, piston radius
10 mm) at --m 48 --mr 24 --nr-ann 24 --nz 120, P = 4, 1 MHz in water.  The
mesh skips the .msh file round trip (minutes at this size): the tagged
quads are matched to (cell, facet) pairs directly, then the extrusion is
detected as on import.

    python -m fustpu_torch.demos.capacity_imported [--m 48] [--mr 24]
        [--nr-ann 24] [--nz 120] [--degree 4] [--steps 10]
        [--impl pallas_corner|auto|mm] [--device cuda|cpu]
        [--dtype f32|f64|bf16]

Prints what `fustpu_torch.demos.capacity` prints, after the mesh.
"""

from __future__ import annotations

import argparse
import time

import torch

from fustpu_torch.config import Material, Source
from fustpu_torch.demos.capacity import describe, timed_run
from fustpu_torch.demos.common import (add_device_args, check_device,
                                       pick_dtype)
from fustpu_torch.mesh.extruded import as_extruded
from fustpu_torch.mesh.msh_io import _facets_from_quads
from fustpu_torch.mesh.shapes import cylinder_mesh
from fustpu_torch.mesh.unstructured import UnstructuredHexMesh
from fustpu_torch.models.westervelt import WesterveltModel


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--m", type=int, default=48,
                   help="butterfly sectors (2D footprint resolution)")
    p.add_argument("--mr", type=int, default=24)
    p.add_argument("--nr-ann", type=int, default=24)
    p.add_argument("--nz", type=int, default=120, help="layers")
    p.add_argument("--degree", type=int, default=4)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--impl", default="pallas_corner",
                   choices=["pallas_corner", "auto", "mm"],
                   help="pallas_corner = the corner-streamed kernels; auto "
                        "= the G-stream kernels; mm = the plain version")
    p.add_argument("--radius", type=float, default=0.035)
    p.add_argument("--length", type=float, default=0.12)
    p.add_argument("--piston", type=float, default=0.01)
    return add_device_args(p)


def build(args):
    """(model, dt, host set-up seconds) for the parsed arguments; the
    set-up seconds cover the mesh, its extrusion detection and the
    model."""
    t0 = time.perf_counter()
    v, c, tagged = cylinder_mesh(args.radius, args.length, args.piston,
                                 m=args.m, mr=args.mr, nr_ann=args.nr_ann,
                                 nz=args.nz)
    um = UnstructuredHexMesh(degree=args.degree, vertices=v, cells=c,
                             facet_tag_map=_facets_from_quads(c, tagged))
    mesh = as_extruded(um)
    if mesh is None:
        raise SystemExit("the cylinder did not detect as an extrusion")
    t_mesh = time.perf_counter() - t0
    print(f"mesh: {mesh.num_cells} cells, {mesh.ndofs} DOF, {mesh.nstacks} "
          f"stacks, {mesh.nz} layers, n2d {mesh.n2d}, gz {mesh.gz} "
          f"[{t_mesh:.1f} s]", flush=True)
    if args.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    model = WesterveltModel(
        mesh, Material(sound_speed=1500.0, density=1000.0, nonlinearity=3.5,
                       attenuation_dB=0.3),
        Source(frequency=1.0e6, amplitude=1.0e5), mesh.boundary_facets(1),
        mesh.boundary_facets(2), dtype=pick_dtype(args.dtype),
        device=args.device, stiffness_impl=args.impl)
    t_setup = time.perf_counter() - t0
    describe(model, time.perf_counter() - t1)
    dt, _ = model.cfl_dt(0.35)
    return model, dt, t_setup


def main(argv=None):
    args = parser().parse_args(argv)
    check_device(args)
    model, dt, t_setup = build(args)
    print(f"host set-up with the mesh: {t_setup:.1f} s")
    state, ms, peak, launches = timed_run(model, dt, args.steps)
    return model, state, ms, peak, launches, t_setup


if __name__ == "__main__":
    main()
