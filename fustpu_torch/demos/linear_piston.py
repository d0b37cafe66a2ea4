"""Linear wave from a circular piston transducer with absorbing far field:
Benchmark 1 Source 2 of the inter-code focused-ultrasound benchmark suite.

The demo runs on an imported tagged mesh: a cylindrical water column with
the piston disk tagged 1 on the z=0 wall and the absorbing wall and far cap
tagged 2.  Pass --mesh to use your own Gmsh .msh file; otherwise a
conforming all-hex O-grid cylinder is generated, written to .msh and read
back through the same importer.  The mesh is prismatic, so the stiffness
runs on the extruded kernel.  The on-axis steady-state pressure amplitude
is compared against the O'Neil closed-form solution.

    python -m fustpu_torch.demos.linear_piston [--mesh file.msh]
        [--refine R] [--degree P] [--periods N] [--device cuda|cpu]
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np

from fustpu_torch.config import Material, Source
from fustpu_torch.demos.common import (check_device, demo_argparser,
                                       pick_dtype, run_demo)
from fustpu_torch.mesh import msh_io, shapes
from fustpu_torch.mesh.unstructured import UPointSampler
from fustpu_torch.models.linear import LinearWaveModel

RADIUS, LENGTH, PISTON_A = 0.015, 0.03, 0.01      # BM1 source-2 geometry [m]


def default_mesh_file(path: str, refine: int) -> str:
    """Generate the tagged O-grid cylinder and write it as .msh."""
    verts, cells, tagged = shapes.cylinder_mesh(
        RADIUS, LENGTH, PISTON_A,
        m=4 * refine, mr=2 * refine, nr_ann=2 * refine, nz=15 * refine)
    return msh_io.write_msh(path, verts, cells, tagged)


def parser():
    p = demo_argparser(degree=4, periods=3.0)
    p.add_argument("--mesh", default="", help=".msh file (generated if '')")
    p.add_argument("--refine", type=int, default=1,
                   help="refinement factor for the generated mesh")
    return p


def build(args, workdir: str):
    """(model, dt, number of steps, steps per period, probe points) for the
    parsed arguments; a generated mesh is written under `workdir`."""
    mat = Material(sound_speed=1500.0, density=1000.0)
    src = Source(frequency=0.5e6, amplitude=60000.0)
    mesh_file = args.mesh or default_mesh_file(
        str(Path(workdir) / "piston_cyl"), args.refine)
    mesh = msh_io.read_msh(mesh_file, degree=args.degree)
    print(f"mesh: {mesh_file} ({mesh.num_cells} hex cells)")
    print(f"Number of degrees-of-freedom: {mesh.ndofs}")
    piston = mesh.boundary_facets(1)
    absorbing = mesh.boundary_facets(2)
    print(f"piston facets: {len(piston)}, absorbing: {len(absorbing)}")
    model = LinearWaveModel(mesh, mat, src, piston, absorbing,
                            dtype=pick_dtype(args.dtype), device=args.device)
    print(f"stiffness impl: {model.impl} "
          f"({type(model.stiffness).__name__})")
    dt, spp = model.cfl_dt()
    tf = LENGTH / mat.sound_speed + args.periods / src.frequency
    nsteps = int(tf / dt) + 1
    print(f"Number of steps: {nsteps} (dt={dt:.3e}, {spp}/period)")
    zs = np.linspace(0.15, 0.75, 13) * LENGTH
    pts = np.stack([np.zeros_like(zs), np.zeros_like(zs), zs], axis=1)
    return model, dt, nsteps, spp, pts


def oneil_table(model, traces: np.ndarray, spp: int, pts: np.ndarray
                ) -> float:
    """Print the on-axis steady-state amplitude (the last source period of
    the per-step traces) against O'Neil; returns the largest deviation as
    a fraction of the peak analytic amplitude."""
    amp = np.abs(traces[-spp:]).max(axis=0)
    src, c = model.source, float(np.max(model.material.sound_speed))
    zs = pts[:, 2]
    ref = shapes.oneil_on_axis(zs, PISTON_A, src.frequency, c,
                               src.amplitude)
    print("\n  z [mm]   |p| sim [kPa]   O'Neil [kPa]   dev")
    devs = []
    for z, a, r in zip(zs, amp, ref):
        d = abs(a - r) / max(ref.max(), 1e-300)
        devs.append(d)
        print(f"  {z*1e3:6.2f}   {a/1e3:12.2f}   {r/1e3:11.2f}   {d:6.2%}")
    dev = max(devs)
    print(f"max on-axis deviation vs O'Neil: {dev:.2%} (of peak amplitude)")
    return dev


def main(argv=None):
    args = parser().parse_args(argv)
    check_device(args)
    with tempfile.TemporaryDirectory() as workdir:
        model, dt, nsteps, spp, pts = build(args, workdir)
    pfn = UPointSampler(model.mesh, pts).torch_probe(model.device)
    probe = lambda s: pfn(s.u)
    state, ys = run_demo(model, dt, nsteps, args, "linear_piston",
                         probe=probe)
    traces = ys.double().cpu().numpy()
    dev = oneil_table(model, traces, spp, pts)
    return model, state, dev, nsteps


if __name__ == "__main__":
    main()
