"""The port's measurement modules and experiment demos on the CPU, float64,
against the JAX package: `utils.benchmarks` (`min_bytes` equal, the same
`OpBenchResult.row()` text, `bench_operators` and `bench_rk4_step` at
nc = 3 with the stiffness they time against ``fustpu``'s at 1e-12, the
rooflines and `time_apply` at toy sizes); `exp_indexed_pair`'s pair and
two singles on the engine and on #11 against
``fustpu.ops.operators.stiffness_apply_indexed_pair`` (1e-12);
`exp_sharded_engine`'s parts, scattered back, against the one-device pair
(1e-12); `exp_isoparametric_bowl`'s two probe traces against the JAX
package's WesterveltModel built the same way (50 steps, 1e-10); and each
new demo's `main` at its smallest size.  The JAX package is imported
inside the fixture (it skips where JAX is missing).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fustpu_torch.demos import (exp_degree_sweep, exp_engine_mesh,
                                exp_indexed_pair, exp_isoparametric_bowl,
                                exp_kernel_speed, exp_sharded_engine,
                                time_halo, time_operators)
from fustpu_torch.mesh import msh_io, shapes
from fustpu_torch.mesh import unstructured as un
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.utils import benchmarks as B

torch.set_num_threads(1)

F64 = torch.float64
CPU = torch.device("cpu")
TOL = 1e-12           # operator gate, the reference's own f64 tolerance
MODEL_TOL = 1e-10     # 50 RK4 steps of the operator gate
SMALL = ["--device", "cpu", "--dtype", "f64"]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules; skips where JAX is missing."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from fustpu import config as f_config
    from fustpu.elements.hex import hex8_tabulate
    from fustpu.mesh import box as f_box
    from fustpu.mesh import extruded as f_ext
    from fustpu.mesh import shapes as f_shapes
    from fustpu.mesh import unstructured as f_un
    from fustpu.models.discretization import Discretization as FDisc
    from fustpu.models.westervelt import WesterveltModel as FWest
    from fustpu.ops import operators as f_ops
    from fustpu.ops import precompute as f_pre
    from fustpu.ops import spectral_mm as f_mm
    from fustpu.utils import benchmarks as f_bench

    return SimpleNamespace(jax=jax, jnp=jnp, config=f_config,
                           hex8_tabulate=hex8_tabulate, box=f_box,
                           ext=f_ext, shapes=f_shapes, un=f_un, FDisc=FDisc,
                           FWest=FWest, ops=f_ops, pre=f_pre, mm=f_mm,
                           bench=f_bench)


# ---------------------------------------------------------------------------
# utils.benchmarks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_min_bytes_equals_fustpus(ref, dtype):
    mesh = build_box_mesh((3, 2, 4), 3)
    fmesh = ref.box.build_box_mesh((3, 2, 4), 3)
    tdt = {"f32": torch.float32, "f64": F64}[dtype]
    jdt = {"f32": ref.jnp.float32, "f64": ref.jnp.float64}[dtype]
    for name in ("mass", "stiffness"):
        assert B.min_bytes(name, mesh, tdt) == \
            ref.bench.min_bytes(name, fmesh, jdt)


def test_op_bench_result_row_is_fustpus(ref):
    fields = dict(name="stiffness", degree=4, ncells=32768, ndofs=2146689,
                  mean_s=1.234e-4, std_s=5.6e-6, dof_per_s=1.7e10,
                  hbm_gb_s=2345.6)
    assert B.OpBenchResult(**fields).row() == \
        ref.bench.OpBenchResult(**fields).row()


def test_bench_operators_structure():
    res = B.bench_operators(nc=3, degree=2, dtype=F64, reps=2, chain=2,
                            device="cpu")
    mesh = build_box_mesh((3, 3, 3), 2)
    assert [r.name for r in res] == ["mass", "stiffness"]
    for r in res:
        assert (r.degree, r.ncells, r.ndofs) == (2, 27, mesh.ndofs)
        assert r.mean_s > 0 and r.std_s >= 0
        assert r.dof_per_s == pytest.approx(mesh.ndofs / r.mean_s)
        assert r.hbm_gb_s == pytest.approx(
            B.min_bytes(r.name, mesh, F64) / r.mean_s / 1e9)


def test_bench_operators_times_fustpus_operators(ref):
    """The mass and stiffness applies that bench_operators times, against
    the ones the JAX package's bench_operators times (its matmul form)."""
    P = 3
    mesh = build_box_mesh((3, 3, 3), P)
    x, benches = B.operator_benches(mesh, F64, CPU)
    (_, mass, diag), (_, stiff, op) = benches
    fmesh = ref.box.build_box_mesh((3, 3, 3), P)
    fdisc = ref.FDisc(fmesh, ref.jnp.float64)
    detJ, _ = ref.pre.cell_geometry_factors(fmesh)
    fdiag = ref.mm.mass_diagonal(fmesh.nc, P, detJ)
    xj = ref.jnp.asarray(x.numpy())
    assert rel(mass(diag, x), np.asarray(xj * fdiag)) <= TOL
    assert rel(stiff(op, x), np.asarray(ref.mm.stiffness_apply_mm(
        fdisc.mm_op, xj))) <= TOL
    # a caller's stiffness function is timed as given
    x2, benches2 = B.operator_benches(mesh, F64, CPU,
                                      stiffness_fn=lambda p, v: 2 * v)
    assert torch.equal(x2, x) and benches2[1][2] is None
    assert torch.equal(benches2[1][1](None, x), 2 * x)


@pytest.mark.parametrize("nonlinear", [True, False])
def test_bench_rk4_step_structure_and_operator(ref, nonlinear):
    sb = B.bench_rk4_step(nc=3, degree=2, dtype=F64, reps=2,
                          nonlinear=nonlinear, steps_per_call=2,
                          device="cpu")
    mesh = build_box_mesh((3, 3, 3), 2)
    assert sb.ndofs == mesh.ndofs and sb.steps == 6
    assert sb.mean_s > 0
    assert sb.state.u.shape == mesh.grid_shape
    assert bool(torch.isfinite(sb.state.u).all())
    assert float(sb.state.u.abs().max()) > 0
    model = B.rk4_model(3, 2, F64, nonlinear, "cpu")
    fmesh = ref.box.build_box_mesh((3, 3, 3), 2, hi=(0.01,) * 3)
    x = np.random.default_rng(4).standard_normal(mesh.grid_shape)
    want = ref.mm.stiffness_apply_mm(ref.FDisc(fmesh, ref.jnp.float64).mm_op,
                                     ref.jnp.asarray(x))
    assert rel(model.stiffness(torch.as_tensor(x)), want) <= TOL


def test_time_apply_and_rates_on_the_cpu():
    calls = []
    x = torch.zeros(4, dtype=F64)
    mean, std = B.time_apply(lambda p, v: calls.append(p), 7, x, chain=3,
                             reps=2)
    assert len(calls) == 1 + 3 * 2 and set(calls) == {7}
    assert mean > 0 and std >= 0
    assert B.measure_streaming_roofline(1, 2, "cpu") > 0
    for dtype in (torch.float32, torch.bfloat16):
        assert B.measure_matmul_roofline(16, 2, dtype, "cpu") > 0
    assert B.l2_bytes("cpu") is None and B.warmth(10, "cpu") == "host"


# ---------------------------------------------------------------------------
# The engine demos against the JAX package's pair operator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cylinder(ref):
    """The demos' --small cylinder in the port and in the JAX package (the
    same `locality_order`), and the JAX package's pair apply of the
    demos' inputs."""
    mesh = exp_indexed_pair.cylinder(small=True)
    v, c, _ = ref.shapes.cylinder_mesh(0.015, 0.03, 0.01, m=2, mr=1,
                                       nr_ann=1, nz=4)
    fmesh = ref.un.locality_order(ref.un.UnstructuredHexMesh(
        degree=4, vertices=v, cells=c, facet_tag_map={}))
    assert np.array_equal(mesh.dofmap, fmesh.dofmap)
    data = exp_indexed_pair.inputs(mesh)
    _, G = ref.pre.cell_geometry_factors(fmesh)
    j = ref.jnp.asarray
    x, x2 = j(data["x"]), j(data["x2"])
    want = ref.ops.stiffness_apply_indexed_pair(
        x, j(data["c1"]), 0.5 * x + x2, j(data["c2"]),
        j(np.moveaxis(G, 2, 0)), j(fmesh.dofmap),
        j(fmesh.element.deriv_1d), fmesh.ndofs)
    return SimpleNamespace(mesh=mesh, want=np.asarray(want))


def test_indexed_pair_matches_fustpu(cylinder):
    out = exp_indexed_pair.run(cylinder.mesh, F64, CPU)
    assert set(out) == {"engine", "#11"}
    for route, r in out.items():
        assert rel(r["pair"], cylinder.want) <= TOL, route
        assert rel(r["two"], cylinder.want) <= TOL, route
        assert r["rel"] <= TOL


def test_sharded_parts_match_the_one_device_pair(cylinder):
    out = exp_sharded_engine.run(cylinder.mesh, [2], F64, CPU)
    for route in exp_sharded_engine.ROUTES:
        assert rel(out["single"][route][0], cylinder.want) <= TOL
        r = out[2][route]
        assert len(r["parts"]) == 2
        assert r["rel"] <= TOL
        assert rel(r["y"], cylinder.want) <= TOL


# ---------------------------------------------------------------------------
# The isoparametric bowl against the JAX package's model
# ---------------------------------------------------------------------------

def test_isoparametric_bowl_matches_fustpu(ref):
    """50 steps of both geometries' focal probe against the JAX package's
    WesterveltModel, its meshes built as the JAX demo builds them."""
    from demos.demo_nonlinear_bowl import bowl_mapping

    E = exp_isoparametric_bowl
    args = E.parser().parse_args(["--elements", "6", "--periods", "0.2",
                                  "--device", "cpu", "--dtype", "f64"])
    cases = E.build(args)
    yc = zc = E.LT / 2
    nc = (6, 4, 4)
    mapping = bowl_mapping(E.FOCAL_LENGTH, E.APERTURE_RADIUS, yc, zc,
                           E.DOMAIN_LENGTH)
    hi = (E.DOMAIN_LENGTH, E.LT, E.LT)
    um_tri = ref.un.from_box(ref.box.build_mapped_mesh(nc, 4, mapping,
                                                       hi=hi))
    vals, _ = ref.hex8_tabulate(E._LAT)
    lat = np.einsum("qv,cvd->cqd", vals, ref.un.from_box(
        ref.box.build_box_mesh(nc, 4, hi=hi)).cell_corners_flat)
    geom = mapping(lat.reshape(-1, 3)).reshape(lat.shape)
    import dataclasses
    fmeshes = {"trilinear": um_tri,
               "hex27": dataclasses.replace(um_tri, geom_nodes=geom)}
    mat = ref.config.Material(sound_speed=1480.0, density=1000.0,
                              nonlinearity=3.5, attenuation_dB=0.2)
    src = ref.config.Source(frequency=0.3e6, amplitude=1000.0 * 1480.0
                            * 0.38557513826589934)
    pts = np.array([[E.FOCAL_LENGTH, yc, zc]])
    for name, case in cases.items():
        um = ref.ext.as_extruded(fmeshes[name])
        assert um is not None and type(case.model.mesh).__name__ == \
            type(um).__name__
        srcf, absf = E.facet_sets(um, 6)
        fmodel = ref.FWest(um, mat, src, srcf, absf, dtype=ref.jnp.float64)
        dt, _ = fmodel.cfl_dt(0.4)
        assert dt == pytest.approx(case.dt, rel=1e-14)
        probe = ref.un.UPointSampler(um, pts).jax_probe()
        _, ys = fmodel.solve(fmodel.init_state(), dt, 50,
                             probe=lambda s: probe(s.u))
        _, got = E.run(case, 50)
        assert got.shape == (50, 1)
        assert rel(got, np.asarray(ys)) <= MODEL_TOL, name


# ---------------------------------------------------------------------------
# Each new demo's main at its smallest size
# ---------------------------------------------------------------------------

def test_time_operators_main():
    out = time_operators.main(["--nc", "3", "--degrees", "2", "3", "--reps",
                               "2"] + SMALL)
    assert sorted(out) == [2, 3]
    for res, rel_, nbytes in out.values():
        assert [r.name for r in res] == ["mass", "stiffness"]
        assert rel_ == 0.0 and nbytes > 0


def test_exp_degree_sweep_main():
    rows = exp_degree_sweep.main(["2", "2"] + SMALL)
    assert [r["P"] for r in rows] == [2]
    assert rows[0]["nc"] == 16 and rows[0]["impl"] == "mm"
    assert rows[0]["rel"] == 0.0 and rows[0]["min_bytes"] > 0


@pytest.mark.parametrize("P", [2, 3])
def test_degree_sweep_oracle_check(P):
    """#1's f64 apply (its plain version on the CPU) on the 2^3 box
    against the dense oracle, with the reference computed apart, as
    `chip_smoke.py` computes it in processes of its own."""
    ref = exp_degree_sweep.oracle_reference(P)
    assert exp_degree_sweep.oracle_check(P, CPU, ref) <= TOL
    assert exp_degree_sweep.oracle_check(P, CPU) <= TOL


def test_exp_kernel_speed_main():
    out = exp_kernel_speed.main(["f64", "2", "0.4", "--device", "cpu"])
    assert set(out["ms"]) == {"auto", "mm", "windows", "indexed"}
    assert len(out["rel"]) == 6
    assert all(v <= TOL for v in out["rel"].values())


def test_time_halo_main():
    out = time_halo.main(["--ranks", "2", "--elements", "2", "--degree",
                          "2", "--steps", "2", "--device", "cpu",
                          "--dtype", "f64"])
    assert out["with_ms"] > 0 and out["without_ms"] > 0
    assert out["differ"] > 1e-6


def test_exp_engine_mesh_main(tmp_path):
    um = un.from_box(build_box_mesh((3, 2, 2), 2, perturb=0.2, seed=3),
                     shuffle_seed=11)
    path = msh_io.write_msh(str(tmp_path / "box"), um.vertices, um.cells)
    out = exp_engine_mesh.main([path, "2"] + SMALL)
    assert set(out["ms"]) == {"gather", "scatter", "engine", "indexed",
                              "index_select", "index_add_"}
    assert out["rel"] <= TOL
    v, c, t = shapes.cylinder_mesh(0.012, 0.02, 0.008, m=2, mr=1, nr_ann=1,
                                   nz=2)
    with pytest.raises(SystemExit):
        exp_engine_mesh.main([msh_io.write_msh(str(tmp_path / "cyl"), v, c,
                                               t), "2"] + SMALL)


def test_exp_indexed_pair_main():
    out = exp_indexed_pair.main(["--small"] + SMALL)
    assert all(r["rel"] <= TOL for r in out.values())


def test_exp_sharded_engine_main():
    out = exp_sharded_engine.main(["2", "--small"] + SMALL)
    assert all(out[2][route]["rel"] <= TOL
               for route in exp_sharded_engine.ROUTES)


def test_exp_isoparametric_bowl_main():
    out = exp_isoparametric_bowl.main(["--elements", "6", "--periods", "0.2",
                                       "--device", "cpu", "--dtype", "f64"])
    for name in ("trilinear", "hex27"):
        assert np.isfinite(out[name]).all() and np.abs(out[name]).max() > 0
    assert np.isfinite(out["delta"])
