"""Drive the PyTorch / CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each prints its time; any failure exits non-zero):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels of fustpu_torch/csrc, from source;
  3. kernel vs plain: both stiffness kernels against the plain torch
     version at P = 2..10 on small odd meshes, float64 and float32;
  4. operator throughput at P = 4, 32^3 cells, float32 (kernel, plain and
     mass-multiply times, GDOF/s);
  5. the linear box demo at its default size, the full run;
  6. the flagship conformal-bowl Westervelt run (--elements 64 --degree 4,
     float32, 6,661,697 DOF): 10 steps kernel vs plain, then the whole
     solve on the kernel, with the focal pressure checked;
  7. the two-layer flagship, 50 steps through the pair kernel.
The main path (the two runs of 6 and 7) runs with the launch counters
reset just before it; the counts are read just after.  The line before the
last is the kernels' JSON summary; the last line is the result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PAIR_DEGREES = (2, 4, 6)
F64_TOL = 1e-12
# float32 kernel vs the float64 plain version: one apply rounds each of its
# ~3N products per node once, relative error ~1e-7 (measured) well inside
F32_TOL = 1e-5
# 10 RK4 steps (40 applies plus the float32 RK updates) of the kernel vs the
# plain float32 version: the two differ only in float32 summation order,
# ~1e-7 per apply, which the explicit, stable steps carry forward without
# amplification; 1e-5 leaves two orders of margin for the accumulation
TRAJ_TOL = 1e-5
FOCAL_BAND_PA = (-7.3e6, -6.0e6)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str):
    class _Phase:
        def __enter__(self):
            print(f"== {name}", flush=True)
            self.t0 = time.perf_counter()

        def __exit__(self, exc_type, *exc):
            if exc_type is None:
                print(f"   [{name}: {time.perf_counter() - self.t0:.1f} s]",
                      flush=True)
    return _Phase()


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def time_ms(fn, reps: int) -> float:
    """Mean device time of one call, CUDA events over `reps` calls after a
    warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an "
             "NVIDIA GPU")
    if not (ROOT / "fustpu_torch" / "csrc" / "stiffness.cu").exists():
        fail("run from a checkout of the repository (fustpu_torch/ is "
             "missing next to this script)")

    from fustpu_torch import _build
    from fustpu_torch.demos import linear_box, nonlinear_bowl
    from fustpu_torch.demos.common import run_demo
    from fustpu_torch.mesh.box import build_box_mesh
    from fustpu_torch.models.discretization import (Discretization,
                                                    StructuredStiffness)
    from fustpu_torch.ops import cuda_stiffness as cs
    from fustpu_torch.ops import precompute as pre
    from fustpu_torch.ops import spectral_mm as mm

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    with phase("1 device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"python {sys.version.split()[0]}, "
              f"{torch.cuda.get_device_name(0)}")

    with phase("2 build"):
        path, secs = _build.build()
        _build.load()
        print(f"built {path.relative_to(ROOT)} in {secs:.1f} s "
              f"(0 = reused)")

    with phase("3 kernel vs plain, P=2..10"):
        worst = {"f64": 0.0, "f32": 0.0}
        cs.reset_launches()
        for P in range(2, 11):
            nc = (5, 3, 7) if P <= 6 else (3, 3, 5)
            mesh = build_box_mesh(nc, P, hi=(1.0, 0.8, 1.3), perturb=0.15,
                                  seed=P)
            _, Gh = pre.cell_geometry_factors(mesh)
            D = mesh.element.deriv_1d
            coeff = rng.uniform(0.5, 2.0, nc)
            C = rng.uniform(-2.0, 2.0, (mesh.num_cells, 2))
            x1 = rng.standard_normal(mesh.grid_shape)
            x2 = rng.standard_normal(mesh.grid_shape)
            cases = [("single", cs.pack_G(Gh), None),
                     ("single+coeff", cs.pack_G(Gh, coeff), None)]
            if P in PAIR_DEGREES:
                cases.append(("pair", cs.pack_G(Gh), C))
            for label, G, Cp in cases:
                def op(dtype):
                    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
                    return cs.CellStiffness(G=t(G), D=t(D), nc=nc,
                                            C=None if Cp is None else t(Cp))

                def apply(o, plain):
                    t = lambda a: torch.as_tensor(a, dtype=o.G.dtype,
                                                  device=dev)
                    if Cp is None:
                        f = cs.stiffness_plain if plain else cs.stiffness
                        return f(o, t(x1))
                    f = cs.stiffness_pair_plain if plain \
                        else cs.stiffness_pair
                    return f(o, t(x1), t(x2))

                ref = apply(op(torch.float64), plain=True)
                e64 = rel_l2(apply(op(torch.float64), plain=False), ref)
                e32 = rel_l2(apply(op(torch.float32), plain=False), ref)
                torch.cuda.synchronize()
                print(f"   P={P:2d} {label:13s} f64 {e64:.3e}  "
                      f"f32 {e32:.3e}", flush=True)
                worst["f64"] = max(worst["f64"], e64)
                worst["f32"] = max(worst["f32"], e32)
                if not e64 <= F64_TOL:
                    fail(f"f64 kernel vs plain {e64:.3e} > {F64_TOL}")
                if not e32 <= F32_TOL:
                    fail(f"f32 kernel vs plain f64 {e32:.3e} > {F32_TOL}")
        print(f"   worst rel-l2: f64 {worst['f64']:.3e} (tol {F64_TOL}), "
              f"f32 {worst['f32']:.3e} (tol {F32_TOL}); launches "
              f"{dict(cs.launches)}")
        if cs.launches["stiffness"] == 0 or cs.launches["stiffness_pair"] == 0:
            fail("a kernel's launch counter did not move")

    with phase("4 operator throughput, P=4 32^3 f32"):
        mesh = build_box_mesh((32, 32, 32), 4)
        disc = Discretization(mesh)
        op = disc.stiffness_op(torch.float32, dev)
        plain_op = cs.to_mm(op)[0]
        diag = torch.as_tensor(disc.mass_diag_host(), dtype=torch.float32,
                               device=dev)
        x = torch.as_tensor(rng.standard_normal(mesh.grid_shape),
                            dtype=torch.float32, device=dev)
        t_k = time_ms(lambda: cs.stiffness(op, x), 50)
        t_p = time_ms(lambda: mm.stiffness_apply_mm(plain_op, x), 20)
        t_m = time_ms(lambda: x * diag, 200)
        err = rel_l2(cs.stiffness(op, x), mm.stiffness_apply_mm(plain_op, x))
        print(f"   {smi}: {mesh.ndofs} DOF: stiffness kernel {t_k:.4f} ms, "
              f"plain {t_p:.4f} ms, mass multiply {t_m:.4f} ms; "
              f"mass+stiffness {mesh.ndofs / ((t_k + t_m) * 1e-3) / 1e9:.4f}"
              f" GDOF/s (kernel vs plain rel-l2 {err:.2e})")
        if not err <= F32_TOL:
            fail(f"32^3 kernel vs plain {err:.3e} > {F32_TOL}")
        del op, plain_op, diag, x, disc

    with phase("5 linear box demo (default size)"):
        model, state = linear_box.main(["--device", "cuda"])
        u = state.u
        if not bool(torch.isfinite(u).all()) or float(u.abs().max()) == 0.0:
            fail("linear box field is not finite and non-zero")
        print(f"   max |u| = {float(u.abs().max()):.6e} Pa")
        del model, state, u

    kernels = {}
    with phase("6a flagship build + kernel vs plain"):
        args = nonlinear_bowl.parser().parse_args(
            ["--elements", "64", "--degree", "4"])
        t0 = time.perf_counter()
        bowl, dt, nsteps, focus = nonlinear_bowl.build(args)
        print(f"   host setup + upload {time.perf_counter() - t0:.1f} s")
        # the plain version: the same operator data in the matmul layout, as
        # a model built with stiffness_impl="mm" holds it
        kstiff = bowl.stiffness
        pstiff = StructuredStiffness(kstiff.cell_op, "mm")
        x = torch.as_tensor(rng.standard_normal(bowl.mesh.grid_shape),
                            dtype=torch.float32, device=dev)
        yk, yp = kstiff(x), pstiff(x)
        err = rel_l2(yk, yp)
        if not err <= F32_TOL:
            fail(f"flagship stiffness kernel vs plain {err:.3e} > {F32_TOL}")
        kernels["stiffness"] = dict(
            max_abs_err=float((yk - yp).abs().max()), rel_l2=err,
            ms=time_ms(lambda: kstiff(x), 20),
            plain_ms=time_ms(lambda: pstiff(x), 10))
        print(f"   {smi}: stiffness at {tuple(bowl.mesh.nc)} cells: "
              f"{kernels['stiffness']}")
        del yk, yp
        # 10 RK4 steps from the same state: kernel, then plain
        s0 = bowl.init_state()
        sk = bowl.solve(s0, dt, 10)
        bowl.stiffness = pstiff
        sp = bowl.solve(s0, dt, 10)
        bowl.stiffness = kstiff
        del pstiff
        traj = rel_l2(sk.u, sp.u)
        print(f"   10 steps kernel vs plain: rel-l2(u) {traj:.3e} "
              f"(tol {TRAJ_TOL}), max |u| {float(sk.u.abs().max()):.4e}")
        if not traj <= TRAJ_TOL:
            fail(f"10-step trajectory kernel vs plain {traj:.3e}")

    with phase("7a two-layer build + pair kernel vs plain"):
        args2 = nonlinear_bowl.parser().parse_args(
            ["--elements", "64", "--degree", "4", "--two-layer"])
        bowl2, dt2, _, _ = nonlinear_bowl.build(args2)
        if not bowl2.stiffness.is_pair:
            fail("two-layer model did not build the pair operator")
        kst2 = bowl2.stiffness
        pst2 = StructuredStiffness(kst2.cell_op, "mm")
        x2 = torch.as_tensor(rng.standard_normal(bowl2.mesh.grid_shape),
                             dtype=torch.float32, device=dev)
        yk, yp = kst2.pair(x, x2), pst2.pair(x, x2)
        err = rel_l2(yk, yp)
        if not err <= F32_TOL:
            fail(f"pair kernel vs plain {err:.3e} > {F32_TOL}")
        kernels["stiffness_pair"] = dict(
            max_abs_err=float((yk - yp).abs().max()), rel_l2=err,
            ms=time_ms(lambda: kst2.pair(x, x2), 20),
            plain_ms=time_ms(lambda: pst2.pair(x, x2), 10))
        print(f"   {smi}: pair at {tuple(bowl2.mesh.nc)} cells: "
              f"{kernels['stiffness_pair']}")
        del yk, yp, pst2, x, x2

    # ---- the main path: counters reset just before, read just after ----
    cs.reset_launches()
    with phase("6b flagship full solve (kernel)"):
        state = run_demo(bowl, dt, nsteps, args, "nonlinear_bowl")
        n_single = cs.launches["stiffness"]
        p_focus = nonlinear_bowl.focal_pressure(bowl, state, focus)
        print(f"pressure at focus: {p_focus:.1f} Pa")
        print(f"   stiffness launches {n_single} for {nsteps} steps")
        if n_single != 4 * nsteps:
            fail(f"stiffness launches {n_single} != 4 x {nsteps} steps")
        if not bool(torch.isfinite(state.u).all()):
            fail("flagship field is not finite")
        if not FOCAL_BAND_PA[0] <= p_focus <= FOCAL_BAND_PA[1]:
            fail(f"focal pressure {p_focus:.1f} Pa outside {FOCAL_BAND_PA}")
        del state
    with phase("7b two-layer flagship, 50 steps (pair kernel)"):
        s2 = bowl2.solve(bowl2.init_state(), dt2, 50)
        torch.cuda.synchronize()
        n_pair = cs.launches["stiffness_pair"]
        print(f"   pair launches {n_pair}, max |u| "
              f"{float(s2.u.abs().max()):.4e}")
        if n_pair != 4 * 50 or cs.launches["stiffness"] != n_single:
            fail(f"launches {dict(cs.launches)} after the two-layer run")
        if not bool(torch.isfinite(s2.u).all()) or \
                float(s2.u.abs().max()) == 0.0:
            fail("two-layer field is not finite and non-zero")
    launches = dict(cs.launches)

    replaces = {"stiffness": "fustpu/ops/pallas_stiffness.py:170",
                "stiffness_pair": "fustpu/ops/pallas_stiffness.py:726"}
    summary = {"kernels": [
        {"name": name, "route": "cuda",
         "source": "fustpu_torch/csrc/stiffness.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": kernels[name]["max_abs_err"],
         "ms": kernels[name]["ms"], "plain_ms": kernels[name]["plain_ms"]}
        for name in ("stiffness", "stiffness_pair")]}
    print(json.dumps(summary))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
