"""The staged engine's two-field gather (#8): four positions a thread on a
one-wave grid (`cen.gather2`, ``csrc/engine.cu`` `engine_gather2_quads`)
against its first design, one thread a position (`cen.gather2_flat`,
`engine_gather<T, 2>`), on the same buffers, in turns, in float32,
float64 and bfloat16.

    python -m fustpu_torch.demos.exp_gather2 [--nc 64 40 40] [--degree 4]
        [--turns 2] [--dtypes f32 f64 bf16] [--device cpu]

The mesh is a perturbed box of `--nc` cells read as a general mesh (64 x
40 x 40 at P = 4: the bodyfit bowl's 102,400 cells and 6,661,697 dofs), in
its cells' lexicographic order.  For each dtype: the two designs' outputs
compared (bitwise), then ms per call in turns (old, new, new, old,
`--turns` times) beside the least bytes the call must move at 3.35 TB/s
(``tools.profile_step.engine_bytes``: the dofmap, both fields and both
outputs once) and two `index_select` calls, the nearest PyTorch yardstick;
in bfloat16 also the pair apply (gather2, contraction, scatter) on each
gather.  On the CPU both designs are the plain version and the times are
host-clock CPU times, not device times.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fustpu_torch.demos.common import check_device, clock
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.mesh.unstructured import from_box
from fustpu_torch.models.discretization import Discretization
from fustpu_torch.ops import cuda_engine as cen
from fustpu_torch.tools.profile_step import engine_bytes
from fustpu_torch.utils.benchmarks import time_apply

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
DTYPES = {"f32": torch.float32, "f64": torch.float64,
          "bf16": torch.bfloat16}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nc", type=int, nargs=3, default=[64, 40, 40])
    p.add_argument("--degree", type=int, default=4)
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("--dtypes", nargs="+", default=list(DTYPES),
                   choices=list(DTYPES))
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def _ms(fn, x) -> float:
    return time_apply(lambda _, __: fn(), None, x, chain=20,
                      reps=1)[0] * 1e3


def run(nc, degree: int, device, turns: int = 2,
        dtypes=tuple(DTYPES)) -> dict:
    """{dtype name: {"old": [ms], "new": [ms], "library": [ms],
    "bound_ms", "bitwise"}, and "apply pair bf16" with old / new} on the
    box."""
    mesh = from_box(build_box_mesh(tuple(nc), degree, perturb=0.1, seed=0))
    disc = Discretization(mesh)
    rng = np.random.default_rng(0)
    c1 = rng.uniform(0.5, 2.0, mesh.num_cells)
    c2 = rng.uniform(-1.5, -0.5, mesh.num_cells)
    xs = [torch.as_tensor(rng.standard_normal(mesh.ndofs), device=device)
          for _ in range(2)]
    card = torch.device(device).type == "cuda"
    print(f"{mesh.num_cells} cells, {mesh.ndofs} dofs, P={degree}; timed "
          f"by {clock(device)}", flush=True)
    out = {}
    for name in dtypes:
        dtype = DTYPES[name]
        op = disc.stiffness_op(dtype, device, engine=True, pair=(c1, c2))
        x1, x2 = (x.to(dtype) for x in xs)
        g = op.dofmap.reshape(-1).long()
        new = lambda: cen.gather2(op, x1, x2)
        old = lambda: cen.gather2_flat(op, x1, x2)
        lib = lambda: (x1.index_select(0, g), x2.index_select(0, g))
        same = all(torch.equal(a, b) for a, b in zip(new(), old()))
        r = dict(old=[], new=[], library=[], bitwise=same,
                 bound_ms=engine_bytes(op)[0] / PEAK_BYTES_PER_S * 1e3)
        for which in ("old", "new", "new", "old") * turns + ("library",):
            r[which].append(_ms({"old": old, "new": new,
                                 "library": lib}[which], x1))
        out[name] = r
        share = (f" (new {r['bound_ms'] / min(r['new']):.1%}, old "
                 f"{r['bound_ms'] / min(r['old']):.1%})" if card else "")
        print(f"gather2 {name:5s} old " + " / ".join(
            f"{t:.4f}" for t in r["old"]) + "  new " + " / ".join(
            f"{t:.4f}" for t in r["new"]) + f" ms, two index_select "
            f"{r['library'][0]:.4f}; the card's bound {r['bound_ms']:.4f} "
            f"ms{share}; new bitwise old: {same}", flush=True)
        if dtype == torch.bfloat16:
            a = dict(old=[], new=[])
            for which in ("old", "new", "new", "old") * turns:
                gat = cen.gather2 if which == "new" else cen.gather2_flat
                a[which].append(_ms(lambda: cen.scatter(op, cen.contract(
                    op, *gat(op, x1, x2))), x1))
            out["apply pair bf16"] = a
            print("apply pair bf16 on the old gather " + " / ".join(
                f"{t:.4f}" for t in a["old"]) + ", on the new " + " / ".join(
                f"{t:.4f}" for t in a["new"]) + " ms", flush=True)
    return out


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    check_device(args)
    return run(args.nc, args.degree, torch.device(args.device), args.turns,
               args.dtypes)


if __name__ == "__main__":
    main()
