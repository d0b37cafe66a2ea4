"""Westervelt nonlinear wave in a box with a plane source (P=6, strong
nonlinearity and attenuation so harmonics develop over a short domain).
`--two-layer` makes the medium heterogeneous (water | tissue-like halves),
which runs the pair stiffness kernel.

    python -m fustpu_torch.demos.nonlinear_box [--elements N] [--degree P]
                                               [--two-layer] ...
"""

from __future__ import annotations

import numpy as np

from fustpu_torch.config import Material, Source
from fustpu_torch.demos.common import (check_device, demo_argparser,
                                       pick_dtype, run_demo)
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.models.westervelt import WesterveltModel


def build(args):
    """(model, dt, number of steps) for the parsed arguments."""
    # beta = 100, alpha = 50 dB/m exaggerate nonlinear/attenuation effects
    src = Source(frequency=0.5e6, amplitude=60000.0)
    L = 0.03
    c0 = 1500.0
    wavelength = c0 / src.frequency
    ne = args.elements or int(2 * L / wavelength)
    mesh = build_box_mesh((ne,) * 3, args.degree, hi=(L, L, L))
    if args.two_layer:
        cs = np.full(mesh.nc, c0)
        cs[mesh.nc[0] // 2:] = 1600.0
        rho = np.full(mesh.nc, 1000.0)
        rho[mesh.nc[0] // 2:] = 1060.0
        mat = Material(sound_speed=cs, density=rho, nonlinearity=100.0,
                       attenuation_dB=50.0)
    else:
        mat = Material(sound_speed=c0, density=1000.0,
                       nonlinearity=100.0, attenuation_dB=50.0)
    print(f"Number of degrees-of-freedom: {mesh.ndofs}")
    # x- source plane and x+ absorbing plane are disjoint
    model = WesterveltModel(mesh, mat, src, mesh.boundary_facets("x-"),
                            mesh.boundary_facets("x+"),
                            dtype=pick_dtype(args.dtype), device=args.device)
    if args.two_layer:
        print("two-layer medium; stiffness pair pass: "
              f"{model.stiffness.is_pair}")
    dt, _ = model.cfl_dt(0.4)
    tf = L / c0 + args.periods / src.frequency
    nsteps = int(tf / dt) + 1
    print(f"Number of steps: {nsteps}")
    return model, dt, nsteps


def main(argv=None):
    p = demo_argparser(degree=6)
    p.add_argument("--two-layer", action="store_true",
                   help="water | tissue-like half-spaces (per-cell "
                        "material fields; the heterogeneous stage runs "
                        "the one-pass pair kernel)")
    args = p.parse_args(argv)
    check_device(args)
    model, dt, nsteps = build(args)
    return model, run_demo(model, dt, nsteps, args, "nonlinear_box")


if __name__ == "__main__":
    main()
