"""Westervelt run over a box sharded across ranks of torch.distributed: the
analogue of the reference's `mpirun -n k python demo_nonlinear_box.py`
(domain decomposition over MPI ranks; here one spawned process per rank,
one all_reduce per partitioned axis per RK stage).  The host model is built
once and every rank builds its block of it; rank 0 prints the progress.

    python -m fustpu_torch.demos.sharded_box [--ranks 4] [--grid 2 2 1]
        [--backend gloo|nccl] [--device cuda|cpu] [--elements 16]
        [--degree 4] [--steps 50] [--dtype f32|f64] [--probe X Y Z]
        [--dist-output DIR --snapshot-every N] [--checkpoint PREFIX
        --checkpoint-every N] [--output PREFIX]

`--backend gloo --device cuda` runs ranks that share one card; `nccl`
needs one card per rank.  Counterpart of ``demos/demo_sharded_box.py``.
"""

from __future__ import annotations

import numpy as np

from fustpu_torch.config import Material, Source
from fustpu_torch.demos.common import (add_rank_args, check_device,
                                       demo_argparser, pick_dtype,
                                       run_ranks)
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.models.westervelt import WesterveltModel


def parser():
    p = add_rank_args(demo_argparser(degree=4, elements=16))
    p.set_defaults(ranks=4)
    p.add_argument("--grid", type=int, nargs=3, default=None,
                   help="rank grid (Sx Sy Sz); default (ranks, 1, 1)")
    p.add_argument("--steps", type=int, default=50)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    check_device(args)
    grid = tuple(args.grid) if args.grid else (args.ranks, 1, 1)
    if int(np.prod(grid)) != args.ranks:
        raise SystemExit(f"--grid {grid} needs {int(np.prod(grid))} ranks, "
                         f"--ranks is {args.ranks}")
    ne = args.elements or 16
    L = 0.01
    mesh = build_box_mesh((ne, ne, ne), args.degree, hi=(L, L, L))
    mat = Material(sound_speed=1480.0, density=1000.0, nonlinearity=3.5,
                   attenuation_dB=0.2)
    src = Source(frequency=1.1e6, amplitude=1480.0 * 1000.0 * 0.3856)
    model = WesterveltModel(mesh, mat, src, mesh.boundary_facets("x-"),
                            mesh.all_boundary_facets(),
                            dtype=pick_dtype(args.dtype), device="cpu")
    dt, _ = model.cfl_dt(0.4)
    print(f"rank grid {grid}, {args.ranks} ranks ({args.backend} on "
          f"{args.device}), dofs {mesh.ndofs}")
    points = None if not args.probe else np.array(args.probe)
    res = run_ranks(model, args, dt, args.steps, grid=grid, points=points)
    r0 = res[0]
    print(f"ms/step {r0['ms_per_step']:.4f}; max |u| "
          f"{float(np.abs(r0['u']).max()):.6e}; launches per rank "
          f"{[r['launches'] for r in res]}")
    for i, pt in enumerate(args.probe or ()):
        print(f"probe u at {pt}: {float(r0['ys'][-1, i]):.6e}")
    return model, res


if __name__ == "__main__":
    main()
