"""Linear wave, plane source, homogeneous water box: 0.5 MHz windowed
velocity source on the x- face, first-order absorbing boundary on x+, P=4
GLL hexes at 2 elements per wavelength, CFL 0.65 RK4.

    python -m fustpu_torch.demos.linear_box [--elements N] [--degree P]
                                            [--dtype f32] [--device cuda]
"""

from __future__ import annotations

from fustpu_torch.config import Material, Source, TimeConfig
from fustpu_torch.demos.common import (check_device, demo_argparser,
                                       pick_dtype, run_demo)
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.models.linear import LinearWaveModel


def build(args):
    """(model, dt, number of steps) for the parsed arguments."""
    mat = Material(sound_speed=1500.0, density=1000.0)
    src = Source(frequency=0.5e6, amplitude=60000.0)
    L = 0.03
    wavelength = mat.sound_speed / src.frequency
    ne = args.elements or int(2 * L / wavelength)
    print(f"mesh: {ne}^3 hex cells, degree {args.degree}")
    mesh = build_box_mesh((ne,) * 3, args.degree, hi=(L, L, L))
    print(f"Number of degrees-of-freedom: {mesh.ndofs}")
    model = LinearWaveModel(mesh, mat, src, mesh.boundary_facets("x-"),
                            mesh.boundary_facets("x+"),
                            dtype=pick_dtype(args.dtype), device=args.device)
    dt, _ = model.cfl_dt(TimeConfig(cfl=0.65).cfl)
    tf = L / mat.sound_speed + args.periods / src.frequency
    nsteps = int(tf / dt) + 1
    print(f"Number of steps: {nsteps}")
    return model, dt, nsteps


def main(argv=None):
    args = demo_argparser(degree=4).parse_args(argv)
    check_device(args)
    model, dt, nsteps = build(args)
    return model, run_demo(model, dt, nsteps, args, "linear_box")


if __name__ == "__main__":
    main()
