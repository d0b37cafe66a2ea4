"""Per-part parity of the sharded general-mesh stiffness on ONE card: for k
parts of a recursive coordinate bisection, each part's local pair apply
(the whole stiffness work of a rank of ``parallel.extruded.
IndexedShardedModel`` in a stage, everything but its one all_reduce) runs
alone on the card, on the staged engine and on the chunk kernel #11; the
parts' results, scattered back through their global DOFs, are held
against the one-device pair apply, and the sum of the parts' times
against its time.

    python -m fustpu_torch.demos.exp_sharded_engine [k ...] [--small]
        [--device cpu] [--dtype f32|f64]          # default k: 2 4

Counterpart of ``demos/exp_sharded_engine.py``, on its cylinder
(``exp_indexed_pair.cylinder``).  The parts are the port's own
(`indexed_parts`, `part_operator`): each part's operator is built on its
own local dofmap, with its own chunk plan and inverse map, and no common
shape; the JAX demo's dead-id padding to one shape and its stacked plans
are TPU layouts and are not ported.  A k-card run would pay the slowest
part, one card pays their sum.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fustpu_torch.demos import exp_indexed_pair
from fustpu_torch.demos.common import (add_device_args, check_device, clock,
                                       pick_dtype, rel_l2)
from fustpu_torch.ops import cuda_engine as cen
from fustpu_torch.ops import cuda_indexed as ci
from fustpu_torch.parallel.extruded import indexed_parts, part_operator
from fustpu_torch.utils.benchmarks import time_apply

ROUTES = ("engine", "#11")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("ks", type=int, nargs="*", default=[2, 4])
    p.add_argument("--small", action="store_true",
                   help="the CPU size of the cylinder")
    return add_device_args(p)


def _pair(route: str, op, x, x2):
    w = 0.5 * x + x2
    if route == "engine":
        return cen.engine_pair(op, x, w)
    return ci.indexed_pair(op, x, w)


def _timed(route: str, op, x, x2) -> float:
    return time_apply(lambda _, v: _pair(route, op, v, x2), None, x,
                      chain=20, reps=5)[0] * 1e3


def run(mesh, ks, dtype: torch.dtype, device) -> dict:
    """The one-device pair on each route, then for each k each part's, on
    `exp_indexed_pair.inputs`; returns {"single": {route: (y, ms)}, k:
    {route: {"parts": [ms], "sum_ms", "y" (the scattered sum), "rel"}}}."""
    data = exp_indexed_pair.inputs(mesh)
    G, D = mesh.cell_metric, mesh.element.deriv_1d
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    C = np.stack([data["c1"], data["c2"]], axis=1)
    x, x2 = t(data["x"]), t(data["x2"])
    md = mesh.ndofs / 1e6
    out = {"single": {}}
    for route in ROUTES:
        op = (cen.build(mesh, G, D, dtype, device,
                        pair=(data["c1"], data["c2"])) if route == "engine"
              else ci.build(mesh, G, D, dtype, device,
                            pair=(data["c1"], data["c2"]),
                            plan=mesh.chunk_plan))
        ms = _timed(route, op, x, x2)
        out["single"][route] = (_pair(route, op, x, x2), ms)
        print(f"single-device {route} pair: {ms:7.4f} ms ({ms / md:.4f} "
              f"ms/MDOF)", flush=True)
        del op
    for k in ks:
        cells_of, ids = indexed_parts(mesh, k)
        out[k] = {}
        for route in ROUTES:
            y = torch.zeros(mesh.ndofs, dtype=dtype, device=device)
            parts = []
            for cells, gid in zip(cells_of, ids):
                op = part_operator(mesh, G, D, cells, gid, dtype, device,
                                   engine=route == "engine", C=C[cells])
                g = torch.as_tensor(gid, device=device)
                xl, x2l = x[g], x2[g]
                parts.append(_timed(route, op, xl, x2l))
                y.index_add_(0, g, _pair(route, op, xl, x2l))
                del op
            y1, ms1 = out["single"][route]
            r = dict(parts=parts, sum_ms=sum(parts), y=y, rel=rel_l2(y, y1))
            out[k][route] = r
            for d, (ms, cells, gid) in enumerate(zip(parts, cells_of, ids)):
                print(f"  k={k} {route} part {d}: {ms:7.4f} ms "
                      f"({cells.size} cells, {gid.size} dofs)")
            print(f"k={k} {route}: sum {r['sum_ms']:7.4f} ms "
                  f"({r['sum_ms'] / md:.4f} ms/MDOF, "
                  f"{r['sum_ms'] / ms1:4.2f}x the single-device pair); "
                  f"scattered sum vs the single-device pair rel-l2 "
                  f"{r['rel']:.3e}", flush=True)
    print(f"   timed by {clock(device)}")
    return out


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    check_device(args)
    mesh = exp_indexed_pair.cylinder(args.small)
    print(f"{mesh.num_cells} cells, {mesh.ndofs} dofs")
    return run(mesh, args.ks, pick_dtype(args.dtype),
               torch.device(args.device))


if __name__ == "__main__":
    main()
