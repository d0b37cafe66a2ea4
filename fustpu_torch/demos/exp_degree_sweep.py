"""Degree sweep of the structured stiffness apply on the card, the P range
of the reference's quadrature table: the `auto` apply (the z-pencil kernel
#1 on the card) at P = Pmin..Pmax on a 16^3 box (12^3 at P = 10), each
against its plain version (``ops.spectral_mm``).

    python -m fustpu_torch.demos.exp_degree_sweep [Pmin Pmax]
        [--dtype f32|f64] [--device cpu]

Counterpart of ``demos/exp_degree_sweep.py``: ms, GDOF/s and the rate
implied over the apply's least bytes (`min_bytes`), as that demo prints
them; then the least bytes beside the card's L2 (at 16^3 and P = 2..6 they
fit in its 50 MB, so the applies repeated on one x run L2-warm and their
rate is no device-memory rate), the bound (the least bytes, with y read
and written, at 3.35 TB/s, or the operations at 67 TFLOP/s float32, the
H100's published peaks) and the share of it.  `oracle_check` holds the
apply in float64 on a 2^3 box against the dense assembled operator
(``fustpu_torch.oracle``).  The JAX demo's --align (ez padded to the
TPU's 128 lanes) is a TPU layout and is not ported.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fustpu_torch.demos.common import (add_device_args, check_device, clock,
                                       pick_dtype, rel_l2)
from fustpu_torch.demos.exp_imported import PEAK_BYTES_PER_S, PEAK_F32_PER_S
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.models.discretization import (Discretization,
                                                StructuredStiffness,
                                                resolve_stiffness_impl)
from fustpu_torch.oracle import assemble
from fustpu_torch.utils import benchmarks as B

ORACLE_BOX = (2, 2, 2)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("degrees", type=int, nargs="*", default=[2, 10],
                   help="Pmin Pmax (default 2 10)")
    return add_device_args(p)


def bound_ms(mesh, itemsize: int) -> float:
    """The least time of one apply at the published peaks: G and x read
    once, y written once (bytes), or 2 x 3 derivative sums of n products
    each way, 15 for the metric and 1 for the add a node (operations)."""
    n = mesh.degree + 1
    nbytes = (mesh.num_cells * n**3 * 6 + 2 * mesh.ndofs) * itemsize
    flops = mesh.num_cells * n**3 * (12 * n + 16)
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S) * 1e3


def stiffness(mesh, dtype: torch.dtype, device) -> StructuredStiffness:
    """The `auto` stiffness apply of a box mesh on `device`."""
    op = Discretization(mesh).stiffness_op(dtype, device)
    return StructuredStiffness(op, resolve_stiffness_impl("auto", device,
                                                          mesh))


def sweep_one(P: int, dtype: torch.dtype, device) -> dict:
    """One row of the sweep: the apply at degree P, timed, against its
    plain version."""
    nc = 16 if P <= 9 else 12
    mesh = build_box_mesh((nc, nc, nc), P)
    op = stiffness(mesh, dtype, device)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        mesh.grid_shape), dtype=dtype, device=device)
    t, _ = B.time_apply(lambda p, v: p(v), op, x, chain=30, reps=5)
    plain = StructuredStiffness(op.cell_op, "mm") if op.impl == "cuda" \
        else op
    mb = B.min_bytes("stiffness", mesh, dtype)
    b_ms = bound_ms(mesh, x.element_size())
    row = dict(P=P, nc=nc, ndofs=mesh.ndofs, impl=op.impl, ms=t * 1e3,
               gdof_s=mesh.ndofs / t / 1e9, gb_s=mb / t / 1e9,
               min_bytes=mb, warmth=B.warmth(mb, device), bound_ms=b_ms,
               rel=rel_l2(op(x), plain(x)))
    share = (f", bound {b_ms:.4f} ms ({b_ms / row['ms']:.1%})"
             if x.is_cuda else "")
    print(f"P={P} {nc}^3 dofs={mesh.ndofs:>8} impl={op.impl:<6} "
          f"{t*1e3:7.3f} ms  {mesh.ndofs/t/1e9:5.2f} GDOF/s  "
          f"{mb/t/1e9:6.1f} GB/s-implied  min {mb / 1e6:.1f} MB "
          f"({row['warmth']}){share}, vs plain rel-l2 {row['rel']:.2e}",
          flush=True)
    return row


def oracle_reference(P: int) -> tuple:
    """(x, y): a seeded field on the 2^3 box of degree P and y = K x
    through the dense assembled operator (``oracle.assemble``), on the
    host in float64.  At P = 10 this takes minutes of one core (explicit
    (n^3, n^3) element matrices), so a caller may compute it in a process
    of its own."""
    mesh = build_box_mesh(ORACLE_BOX, P)
    x = np.random.default_rng(P).standard_normal(mesh.ndofs)
    K = assemble.element_stiffness_matrices(mesh)
    return x, assemble.apply_elementwise(K, mesh.dofmap,
                                         np.ones(mesh.num_cells), x,
                                         mesh.ndofs)


def oracle_check(P: int, device, ref: tuple | None = None) -> float:
    """rel-l2 of the float64 `auto` apply at degree P on the 2^3 box
    against the dense oracle's (x, y) (`oracle_reference`, computed here
    unless given)."""
    x, y = oracle_reference(P) if ref is None else ref
    mesh = build_box_mesh(ORACLE_BOX, P)
    op = stiffness(mesh, torch.float64, device)
    yk = op(torch.as_tensor(x.reshape(mesh.grid_shape), device=device))
    return rel_l2(yk.reshape(-1), torch.as_tensor(y, device=device))


def main(argv=None) -> list[dict]:
    """Returns the sweep's rows."""
    args = parser().parse_args(argv)
    check_device(args)
    lo, hi = (args.degrees + [2, 10][len(args.degrees):])[:2]
    dev, dtype = torch.device(args.device), pick_dtype(args.dtype)
    rows = [sweep_one(P, dtype, dev) for P in range(lo, hi + 1)]
    print(f"   timed by {clock(dev)}; L2 {B.l2_bytes(dev)} B")
    return rows


if __name__ == "__main__":
    main()
