"""What the staged engine and the chunk kernel cost on a given imported
general mesh: the engine gather #7, the engine scatter #10, the composed
engine apply (#7, #9, #10) and the fused chunk kernel #11, on the same
mesh and field, with `index_select` and `index_add_` (one PyTorch call
each for the gather's and the scatter's function) beside them.

    python -m fustpu_torch.demos.exp_engine_mesh mesh.msh [degree]
        [--device cpu] [--dtype f32|f64]

Counterpart of ``demos/exp_engine_mesh.py``.  `read_msh` returns a
general mesh in `locality_order`, as the JAX demo orders it; an extruded
mesh is refused (it runs the extruded kernels, not these).  The JAX demo's
plan statistics (window rows, windows, spills) describe the TPU's one-hot
engine and mean nothing on the card; the chunk kernel's plan (cells a
chunk, its unique-dof table) stands in their place.  Prints ms and ms per
million DOF of each, and the engine apply against #11 (rel-l2).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fustpu_torch.demos.common import (add_device_args, check_device, clock,
                                       pick_dtype, rel_l2)
from fustpu_torch.mesh import msh_io
from fustpu_torch.mesh.extruded import ExtrudedHexMesh
from fustpu_torch.ops import cuda_engine as cen
from fustpu_torch.ops import cuda_indexed as ci
from fustpu_torch.utils.benchmarks import time_apply


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path")
    p.add_argument("degree", nargs="?", type=int, default=4)
    return add_device_args(p)


def load(path: str, degree: int):
    """The general mesh of `path` (in `locality_order`); refuses an
    extruded one."""
    mesh = msh_io.read_msh(path, degree)
    if isinstance(mesh, ExtrudedHexMesh):
        raise SystemExit(f"{path}: an extruded mesh runs the extruded "
                         "kernels; this times the engine path of a general "
                         "mesh")
    return mesh


def plan_summary(op: ci.IndexedCellStiffness, x: torch.Tensor) -> str:
    """The chunk kernel's plan on x's card: cells a chunk, chunks, and the
    unique-dof table."""
    if not x.is_cuda:
        return "chunk plan: chosen on the card (the plain version here)"
    s = ci.card_schedule(op, x, False)
    tab = op.plan.tables(s.cpb)
    return (f"chunk plan: {s.cpb} cells a chunk, {len(tab.cell0)} chunks in "
            f"{len(s.classes)} classes, unique-dof table {tab.uniq.size:,} "
            f"entries ({tab.uniq.size / op.ndofs:.3f} a DOF, at most "
            f"{s.maxu} a chunk)")


def run(mesh, dtype: torch.dtype, device) -> dict:
    """Times the engine's kernels, its apply, #11 and the two PyTorch calls
    on `mesh`; returns {"ms": {name: ms}, "rel": engine vs #11, "ys":
    {"engine", "indexed"}}."""
    G, D = mesh.cell_metric, mesh.element.deriv_1d
    eop = cen.build(mesh, G, D, dtype, device)
    iop = ci.build(mesh, G, D, dtype, device, plan=mesh.chunk_plan)
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    x = t(rng.standard_normal(mesh.ndofs))
    vals = t(rng.standard_normal(eop.dofmap.shape))
    g = eop.dofmap.reshape(-1).long()
    calls = {
        "gather": lambda: cen.gather(eop, x),
        "scatter": lambda: cen.scatter(eop, vals),
        "engine": lambda: cen.engine(eop, x),
        "indexed": lambda: ci.indexed(iop, x),
        "index_select": lambda: x.index_select(0, g),
        "index_add_": lambda: torch.zeros_like(x).index_add_(
            0, g, vals.reshape(-1))}
    print(f"{mesh.num_cells} cells, {mesh.ndofs} dofs; {plan_summary(iop, x)}",
          flush=True)
    out = {"ms": {}}
    md = mesh.ndofs / 1e6
    for name, f in calls.items():
        ms = time_apply(lambda _, __, f=f: f(), None, x, chain=20,
                        reps=5)[0] * 1e3
        out["ms"][name] = ms
        print(f"{name:12s} {ms:8.4f} ms   ({ms / md:.4f} ms/MDOF)", flush=True)
    out["ys"] = {"engine": calls["engine"](), "indexed": calls["indexed"]()}
    out["rel"] = rel_l2(out["ys"]["engine"], out["ys"]["indexed"])
    print(f"engine vs #11 rel-l2 {out['rel']:.3e}; timed by {clock(device)}",
          flush=True)
    return out


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    check_device(args)
    return run(load(args.path, args.degree), pick_dtype(args.dtype),
               torch.device(args.device))


if __name__ == "__main__":
    main()
