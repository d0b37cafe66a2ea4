"""The heterogeneous stiffness pair on a general mesh: one pair apply
against two single applies, on the staged engine and on the chunk kernel
#11.  The Westervelt heterogeneous stiffness term is
S(u; c1) + S(w; c2) with per-cell coefficients; the pair form gathers both
fields, folds them to c1 u + c2 w (the coefficients commute with the
in-cell contractions), contracts and scatters once.  Here w = 0.5 u + x2,
formed in each timed call.

    python -m fustpu_torch.demos.exp_indexed_pair [--small]
        [--device cpu] [--dtype f32|f64]

Counterpart of ``demos/exp_indexed_pair.py``: its 627k-DOF cylinder
(``shapes.cylinder_mesh(0.015, 0.03, 0.01, m=8, mr=4, nr_ann=4, nz=30)``,
in `locality_order`), or with --small the CPU size (m=2, mr=1, nr_ann=1,
nz=4).  Prints, for each route, the pair against the two singles (rel-l2)
and the times.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fustpu_torch.demos.common import (add_device_args, check_device, clock,
                                       pick_dtype, rel_l2)
from fustpu_torch.mesh import shapes
from fustpu_torch.mesh.unstructured import UnstructuredHexMesh, locality_order
from fustpu_torch.ops import cuda_engine as cen
from fustpu_torch.ops import cuda_indexed as ci
from fustpu_torch.utils.benchmarks import time_apply


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--small", action="store_true",
                   help="the CPU size of the cylinder")
    return add_device_args(p)


def cylinder(small: bool, degree: int = 4) -> UnstructuredHexMesh:
    """The JAX demos' engine-benchmark cylinder, in `locality_order`."""
    size = (dict(m=2, mr=1, nr_ann=1, nz=4) if small
            else dict(m=8, mr=4, nr_ann=4, nz=30))
    verts, cells, _ = shapes.cylinder_mesh(0.015, 0.03, 0.01, **size)
    return locality_order(UnstructuredHexMesh(
        degree=degree, vertices=verts, cells=cells, facet_tag_map={}))


def inputs(mesh) -> dict:
    """The demo's host inputs: per-cell c1, c2 in [0.5, 1.5), x and x2."""
    rng = np.random.default_rng(0)
    return dict(c1=rng.uniform(0.5, 1.5, mesh.num_cells),
                c2=rng.uniform(0.5, 1.5, mesh.num_cells),
                x=rng.standard_normal(mesh.ndofs),
                x2=rng.standard_normal(mesh.ndofs))


def routes(mesh, data: dict, dtype: torch.dtype, device) -> dict:
    """{route: (two(x), pair(x))} on the staged engine and on #11 on
    `mesh` with its `inputs` data: two single applies with the per-cell
    coefficients c1 and c2 against the pair apply, w = 0.5 x + x2 formed
    in the call.  The operators share their G, dofmap and tables where
    their form allows."""
    G, D = mesh.cell_metric, mesh.element.deriv_1d
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    c1, c2, x2 = t(data["c1"]), t(data["c2"]), t(data["x2"])
    C = torch.stack([c1, c2], dim=1)
    eop = cen.build(mesh, G, D, dtype, device)
    e1, e2 = eop._replace(coeff=c1), eop._replace(coeff=c2)
    ep = eop._replace(C=C)
    iop = ci.build(mesh, G, D, dtype, device, plan=mesh.chunk_plan)
    i1 = iop._replace(G=iop.G * c1[:, None, None])
    i2 = iop._replace(G=iop.G * c2[:, None, None])
    ip = iop._replace(C=C)
    w = lambda x: 0.5 * x + x2
    return {
        "engine": (lambda x: cen.engine(e1, x) + cen.engine(e2, w(x)),
                   lambda x: cen.engine_pair(ep, x, w(x))),
        "#11": (lambda x: ci.indexed(i1, x) + ci.indexed(i2, w(x)),
                lambda x: ci.indexed_pair(ip, x, w(x)))}


def run(mesh, dtype: torch.dtype, device) -> dict:
    """Both routes on `mesh` with its `inputs`: {route: {"two", "pair":
    output, "rel", "two_ms", "pair_ms"}}."""
    data = inputs(mesh)
    x = torch.as_tensor(data["x"], dtype=dtype, device=device)
    out = {}
    for route, (two, pair) in routes(mesh, data, dtype, device).items():
        r = dict(two=two(x), pair=pair(x))
        r["rel"] = rel_l2(r["pair"], r["two"])
        for form, f in (("two", two), ("pair", pair)):
            r[f"{form}_ms"] = time_apply(lambda _, v, f=f: f(v), None, x,
                                         chain=20, reps=5)[0] * 1e3
        print(f"{route}: pair vs two applies rel err: {r['rel']:.3e}; two "
              f"applies {r['two_ms']:7.4f} ms, fused pair "
              f"{r['pair_ms']:7.4f} ms ({r['two_ms'] / r['pair_ms']:4.2f}x)",
              flush=True)
        out[route] = r
    print(f"engine pair vs #11 pair rel-l2 "
          f"{rel_l2(out['engine']['pair'], out['#11']['pair']):.3e}; timed "
          f"by {clock(device)}", flush=True)
    return out


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    check_device(args)
    mesh = cylinder(args.small)
    print(f"{mesh.num_cells} cells, {mesh.ndofs} dofs")
    return run(mesh, pick_dtype(args.dtype), torch.device(args.device))


if __name__ == "__main__":
    main()
