"""The structured stiffness apply in four formulations on one box, timed
and held against each other, the analogue of the reference's
exp_kernel_speed (CLI dtype / degree / elements per wavelength; global
memory layout as a first-order performance knob):

  auto       what a model's `auto` runs: the z-pencil kernel #1 on the
             card (``ops.cuda_stiffness``), the plain version on the CPU
  mm         the matmul formulation (``ops.spectral_mm``), #1's plain
             version and the JAX package's production path
  windows    the expanded element-batch layout (``ops.operators``)
  indexed    the explicit-dofmap gather / contract / scatter
             (``ops.indexed``) on the box's dofmap

    python -m fustpu_torch.demos.exp_kernel_speed f32 4 2
        [dtype] [degree] [elements/wavelength] [--device cpu]

Counterpart of ``demos/exp_kernel_speed.py`` (bf16: `auto` is #1's
bfloat16 form, `mm` and `indexed` compute in float32 and round once, and
`windows` runs its einsums on bfloat16 tensors); the box is 10 wavelengths
a side, max(10 x epw, 4) cells.  Prints ms and GDOF/s of each and the rel-l2 of
each pair of formulations.
"""

from __future__ import annotations

import argparse
import itertools

import numpy as np
import torch

from fustpu_torch.demos.common import (DTYPES, check_device, clock,
                                       pick_dtype, rel_l2)
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.models.discretization import (Discretization,
                                                StructuredStiffness,
                                                resolve_stiffness_impl)
from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.ops import indexed
from fustpu_torch.ops import operators as ops
from fustpu_torch.ops import precompute as pre
from fustpu_torch.ops import spectral_mm as mm
from fustpu_torch.utils.benchmarks import time_apply


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("dtype", nargs="?", default="f32", choices=DTYPES)
    p.add_argument("degree", nargs="?", type=int, default=4)
    p.add_argument("epw", nargs="?", type=float, default=2.0,
                   help="elements per wavelength")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def formulations(mesh, dtype: torch.dtype, device) -> tuple:
    """(x, {name: apply()}) of the four formulations on `mesh`, and the
    launch counter `auto` moves (None for the plain version)."""
    disc = Discretization(mesh)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    op = disc.stiffness_op(dtype, device)
    auto = StructuredStiffness(op, resolve_stiffness_impl("auto", device,
                                                          mesh))
    mm_op = cs.to_mm(op)[0]
    G_s = t(pre.to_structured_layout(disc._G_host, mesh))
    G_idx = t(np.moveaxis(disc._G_host, 2, 0))
    D = t(disc._D_host)
    ones = torch.ones(mesh.nc, dtype=dtype, device=device)
    dofmap = torch.as_tensor(mesh.dofmap, device=device)
    x = t(np.random.default_rng(0).standard_normal(mesh.grid_shape))
    return x, auto.kernel, {
        "auto": lambda: auto(x),
        "mm": lambda: mm.stiffness_apply_mm(mm_op, x),
        "windows": lambda: ops.stiffness_apply(x, G_s, ones, D, mesh.degree),
        "indexed": lambda: indexed.stiffness_apply_indexed(
            x.reshape(-1), G_idx, None, dofmap, D,
            mesh.ndofs).reshape(mesh.grid_shape)}


def main(argv=None) -> dict:
    """Returns {"ms": {name: ms}, "rel": {(a, b): rel-l2}, "kernel": the
    launch counter `auto` moves (None on the CPU)}."""
    args = parser().parse_args(argv)
    check_device(args)
    dev, dtype = torch.device(args.device), pick_dtype(args.dtype)
    nc = max(int(10 * args.epw), 4)
    mesh = build_box_mesh((nc,) * 3, args.degree)
    print(f"mesh {nc}^3, degree {args.degree}, dofs {mesh.ndofs}")
    x, kernel, forms = formulations(mesh, dtype, dev)
    out = {"ms": {}, "rel": {}, "kernel": kernel}
    for name, f in forms.items():
        mean, std = time_apply(lambda _, __, f=f: f(), None, x, chain=20,
                               reps=5)
        out["ms"][name] = mean * 1e3
        print(f"{name:8s}: {mean*1e3:8.3f} ms/apply "
              f"(+-{std*1e3:.3f})  {mesh.ndofs/mean/1e9:6.2f} GDOF/s",
              flush=True)
    ys = {name: f() for name, f in forms.items()}
    for a, b in itertools.combinations(ys, 2):
        out["rel"][(a, b)] = rel_l2(ys[a], ys[b])
        print(f"{a} vs {b}: rel-l2 {out['rel'][(a, b)]:.3e}")
    print(f"   timed by {clock(dev)}")
    return out


if __name__ == "__main__":
    main()
