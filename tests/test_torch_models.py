"""The port's models against the JAX package's on the CPU in float64: the
right-hand side and a 10-step RK4 trajectory for linear and Westervelt
models, uniform and two-layer, and a small conformal bowl, both for a port
model built from the host setup and for one built from the JAX model's
parameters through `convert.model_from_fustpu`; the source coefficients,
`rk4_step` and `cfl_dt`; and one CLI run of the bowl demo."""

import functools
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from fustpu import config as f_config  # noqa: E402
from fustpu.mesh import msh_io as f_msh  # noqa: E402
from fustpu.mesh.box import BoxMesh as FBoxMesh  # noqa: E402
from fustpu.models import sources as f_sources  # noqa: E402
from fustpu.models import timestepping as f_ts  # noqa: E402
from fustpu.models.linear import LinearWaveModel as FLinear  # noqa: E402
from fustpu.models.westervelt import WesterveltModel as FWest  # noqa: E402
from fustpu.ops import pallas_stiffness as ps  # noqa: E402
from fustpu.ops import spectral_mm as f_mm  # noqa: E402

from fustpu_torch import convert  # noqa: E402
from fustpu_torch.config import Material, Source  # noqa: E402
from fustpu_torch.demos.nonlinear_bowl import bowl_mapping  # noqa: E402
from fustpu_torch.mesh import msh_io, shapes  # noqa: E402
from fustpu_torch.mesh.box import build_box_mesh, build_mapped_mesh  # noqa: E402
from fustpu_torch.mesh.extruded import ExtrudedHexMesh  # noqa: E402
from fustpu_torch.models.discretization import IndexedStiffness  # noqa: E402
from fustpu_torch.models import sources, timestepping  # noqa: E402
from fustpu_torch.models.linear import LinearWaveModel  # noqa: E402
from fustpu_torch.models.westervelt import WesterveltModel  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-11
STEPS = 10
CONFIGS = ["linear_uniform", "linear_two_layer", "westervelt_uniform",
           "westervelt_two_layer", "westervelt_bowl"]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _two_layer(nc, c, rho, beta=0.0, alpha=0.0):
    cs = np.full(nc, c)
    cs[nc[0] // 2:] = 1.06 * c
    rh = np.full(nc, rho)
    rh[nc[0] // 2:] = 1.05 * rho
    return Material(sound_speed=cs, density=rh, nonlinearity=beta,
                    attenuation_dB=alpha)


@functools.lru_cache(maxsize=None)
def _config(name):
    """(port class, JAX class, kwargs shared by both, mesh)."""
    if name == "westervelt_bowl":
        mesh = build_mapped_mesh((16, 8, 8), 2,
                                 bowl_mapping(0.035, 0.016, 0.025, 0.025,
                                              0.08), hi=(0.08, 0.05, 0.05))
        mat = Material(sound_speed=1480.0, density=1000.0, nonlinearity=3.5,
                       attenuation_dB=0.2)
        src = Source(frequency=1.1e6, amplitude=1480.0 * 1000.0 * 0.3856)
        in_ap = lambda c: ((c[:, 1] - 0.025) ** 2
                           + (c[:, 2] - 0.025) ** 2) < 0.016**2
        sfac = mesh.boundary_facets("x-", predicate=in_ap)
        afac = np.concatenate(
            [mesh.boundary_facets("x-", predicate=lambda c: ~in_ap(c))]
            + [mesh.boundary_facets(p) for p in
               ["x+", "y-", "y+", "z-", "z+"]])
        return WesterveltModel, FWest, dict(material=mat, source=src,
                                            source_facets=sfac,
                                            absorbing_facets=afac), mesh
    L = 0.006
    mesh = build_box_mesh((4, 3, 3), 3, hi=(L, L, L), perturb=0.1, seed=3)
    src = Source(frequency=0.5e6, amplitude=60000.0)
    kw = dict(source=src, source_facets=mesh.boundary_facets("x-"),
              absorbing_facets=mesh.boundary_facets("x+"))
    if name.startswith("linear"):
        kw["material"] = (_two_layer(mesh.nc, 1500.0, 1000.0)
                          if name.endswith("two_layer")
                          else Material(sound_speed=1500.0, density=1000.0))
        if name == "linear_uniform":      # phased: the cos/sin source pair
            kw["source_delays"] = lambda p: sources.focus_delays(
                p, (0.01, L / 2, L / 2), 1500.0)
        return LinearWaveModel, FLinear, kw, mesh
    kw["material"] = (_two_layer(mesh.nc, 1500.0, 1000.0, 100.0, 50.0)
                      if name.endswith("two_layer")
                      else Material(sound_speed=1500.0, density=1000.0,
                                    nonlinearity=100.0, attenuation_dB=50.0))
    kw["absorbing_facets"] = mesh.all_boundary_facets()
    return WesterveltModel, FWest, kw, mesh


def _fmesh(mesh):
    return FBoxMesh(degree=mesh.degree, nc=mesh.nc, lo=mesh.lo, hi=mesh.hi,
                    vertex_coords=mesh.vertex_coords)


def _initial(mesh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(mesh.grid_shape),
            rng.standard_normal(mesh.grid_shape))


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The JAX model (float64, matmul path), its dt and its 10-step run
    from a seeded random state."""
    _, fcls, kw, mesh = _config(name)
    fmodel = fcls(_fmesh(mesh), dtype=jnp.float64, **kw)
    dt, _ = fmodel.cfl_dt()
    u0, v0 = _initial(mesh)
    s0 = fmodel.init_state(0.0, u0=u0, v0=v0)
    out, _ = fmodel.solve(s0, dt, STEPS)
    return fmodel, dt, s0, out


def _np_params(fmodel):
    """The JAX model's params as numpy arrays, stiffness as the keyword
    arrays of convert.stiffness_from_fustpu."""
    p = fmodel.params
    out = {k: np.asarray(v) for k, v in p.items() if k != "stiff"}
    op = p["stiff"]
    if isinstance(op, f_mm.MMStiffness):
        out["stiff"] = dict(G=np.asarray(op.G),
                            Dt=tuple(np.asarray(d) for d in op.Dt))
    elif isinstance(op, ps.PallasStiffnessPair):
        out["stiff"] = dict(G=np.asarray(op.G), D=np.asarray(op.D_host),
                            C=np.asarray(op.C))
    else:
        assert isinstance(op, ps.PallasStiffness)
        out["stiff"] = dict(G=np.asarray(op.G), D=np.asarray(op.D_host))
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_rhs_and_trajectory_match(name):
    cls, _, kw, mesh = _config(name)
    fmodel, dt, _, fout = _reference(name)
    model = cls(mesh, dtype=torch.float64, device="cpu", **kw)
    assert model.impl == "mm"
    assert model.stiffness.is_pair == (name == "westervelt_two_layer")
    assert model.cfl_dt() == fmodel.cfl_dt()
    u0, v0 = _initial(mesh, seed=1)
    for t in (1.3e-7, 9.5e-6):
        ref = np.asarray(fmodel.rhs(jnp.asarray(t), jnp.asarray(u0),
                                    jnp.asarray(v0)))
        got = model.rhs(t, torch.as_tensor(u0), torch.as_tensor(v0))
        assert rel(got, ref) <= TOL
    u0, v0 = _initial(mesh)
    out, _ = model.solve(model.init_state(0.0, u0=u0, v0=v0), dt, STEPS)
    assert out.t == pytest.approx(float(fout.t), rel=1e-15)
    assert rel(out.u, fout.u) <= TOL and rel(out.v, fout.v) <= TOL


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("layout", ["mm", "pallas"])
def test_model_from_fustpu_trajectory_matches(name, layout):
    """A port model built from the JAX model's params (matmul-layout or
    fused-kernel-layout stiffness) runs the same trajectory."""
    cls, fcls, kw, mesh = _config(name)
    fmodel, dt, s0, fout = _reference(name)
    if layout == "pallas":
        fmodel = fcls(_fmesh(mesh), dtype=jnp.float64,
                      stiffness_impl="pallas", **kw)
    params = _np_params(fmodel)
    state = tuple(np.asarray(a) for a in s0[:4]) + (float(s0.t),)
    model, st = convert.model_from_fustpu(
        cls, params, state, mesh=mesh, material=kw["material"],
        source=kw["source"], source_facets=kw["source_facets"],
        dtype=torch.float64, device="cpu")
    out, _ = model.solve(st, dt, STEPS)
    assert rel(out.u, fout.u) <= TOL and rel(out.v, fout.v) <= TOL


@pytest.mark.parametrize("name", ["linear_uniform", "westervelt_two_layer"])
@pytest.mark.parametrize("clamp", [False, True])
def test_step_matches_fustpu(name, clamp):
    """`model.step(state, dt, tf)`, the JAX package's signature: two steps
    from a seeded state, the second clamped onto `tf` when `clamp` (a
    third step past `tf` then does nothing)."""
    cls, _, kw, mesh = _config(name)
    fmodel, dt, s0, _ = _reference(name)
    model = cls(mesh, dtype=torch.float64, device="cpu", **kw)
    u0, v0 = _initial(mesh)
    s = model.init_state(0.0, u0=u0, v0=v0)
    fs = s0
    tf = 1.4 * dt if clamp else None
    for _ in range(3 if clamp else 2):
        s = model.step(s, dt, tf)
        fs = fmodel.step(fs, dt, tf)
    assert s.t == pytest.approx(float(fs.t), rel=1e-15)
    if clamp:
        assert s.t == pytest.approx(tf, rel=1e-15)
    for a, b in zip(s[:4], fs[:4]):
        assert rel(a, b) <= TOL


def test_solve_returns_state_and_ys_without_a_probe():
    """A script written for the JAX package runs unchanged: `solve`
    returns (state, ys) with ys None when no probe is given, and the
    state is the one `step` reaches."""
    cls, _, kw, mesh = _config("linear_two_layer")
    model = cls(mesh, dtype=torch.float64, device="cpu", **kw)
    dt, _ = model.cfl_dt()
    s = model.init_state(0.0, *_initial(mesh))
    state, ys = model.solve(s, dt, 3)
    assert ys is None
    for _ in range(3):
        s = model.step(s, dt)
    assert state.t == pytest.approx(s.t, rel=1e-15)
    assert rel(state.u, s.u) <= 1e-15 and rel(state.v, s.v) <= 1e-15


def test_indexed_impl_on_a_prismatic_import_matches_fustpu(tmp_path):
    """stiffness_impl="indexed" on an imported prismatic mesh takes the
    indexed operator (not the extruded one), as the JAX package's does:
    10 steps of a two-layer Westervelt model against the JAX package's
    "indexed" model."""
    v, c, t = shapes.cylinder_mesh(0.012, 0.02, 0.008, m=3, mr=1, nr_ann=1,
                                   nz=4)
    path = msh_io.write_msh(str(tmp_path / "cyl"), v, c, t)
    mesh, fmesh = msh_io.read_msh(path, 3), f_msh.read_msh(path, 3)
    assert isinstance(mesh, ExtrudedHexMesh)
    zc = mesh.cell_corners_flat.mean(axis=1)[:, 2]
    props = dict(sound_speed=np.where(zc < 0.01, 1500.0, 1650.0),
                 density=np.where(zc < 0.01, 1000.0, 1050.0),
                 nonlinearity=100.0, attenuation_dB=50.0)
    args = (mesh.boundary_facets(1), mesh.boundary_facets(2))
    fmodel = FWest(fmesh, f_config.Material(**props),
                   f_config.Source(frequency=0.5e6, amplitude=1e5), *args,
                   dtype=jnp.float64, stiffness_impl="indexed")
    assert fmodel.impl == "indexed"
    model = WesterveltModel(mesh, Material(**props),
                            Source(frequency=0.5e6, amplitude=1e5), *args,
                            dtype=torch.float64, device="cpu",
                            stiffness_impl="indexed")
    assert model.impl == "mm" and isinstance(model.stiffness,
                                             IndexedStiffness)
    assert model.stiffness.is_pair
    dt, _ = fmodel.cfl_dt()
    rng = np.random.default_rng(0)
    u0, v0 = rng.standard_normal(mesh.ndofs), rng.standard_normal(mesh.ndofs)
    fout, _ = fmodel.solve(fmodel.init_state(0.0, u0=u0, v0=v0), dt, STEPS)
    out, _ = model.solve(model.init_state(0.0, u0=u0, v0=v0), dt, STEPS)
    assert rel(out.u, fout.u) <= TOL and rel(out.v, fout.v) <= TOL


def test_indexed_impl_on_a_box_matches_fustpu():
    """On a box mesh, stiffness_impl="indexed" runs the indexed operator
    through the box's dofmap, as the JAX package's does."""
    cls, fcls, kw, mesh = _config("linear_two_layer")
    fmodel = fcls(_fmesh(mesh), dtype=jnp.float64, stiffness_impl="indexed",
                  **kw)
    assert fmodel.impl == "indexed"
    model = cls(mesh, dtype=torch.float64, device="cpu",
                stiffness_impl="indexed", **kw)
    assert isinstance(model.stiffness, IndexedStiffness)
    dt, _ = fmodel.cfl_dt()
    u0, v0 = _initial(mesh)
    fout, _ = fmodel.solve(fmodel.init_state(0.0, u0=u0, v0=v0), dt, STEPS)
    out, _ = model.solve(model.init_state(0.0, u0=u0, v0=v0), dt, STEPS)
    assert rel(out.u, fout.u) <= TOL and rel(out.v, fout.v) <= TOL


@pytest.mark.parametrize("t", [0.0, 1.3e-7, 3.1e-6, 9.5e-6, 2.0e-5])
def test_sources_match(t):
    src = Source(frequency=0.5e6, amplitude=60000.0, window_periods=4.0)
    fsrc = f_config.Source(frequency=0.5e6, amplitude=60000.0,
                           window_periods=4.0)
    tj = jnp.asarray(t, jnp.float64)
    pairs = [
        (sources.hann_window(t, src), f_sources.hann_window(tj, fsrc)),
        (sources.linear_source_coeffs(t, src, 1500.0),
         f_sources.linear_source_coeffs(tj, fsrc, 1500.0)),
        (sum(sources.westervelt_source_coeffs(t, src, 1500.0), ()),
         sum(f_sources.westervelt_source_coeffs(tj, fsrc, 1500.0), ())),
    ]
    for got, ref in pairs:
        ref = np.array([float(r) for r in ref])
        scale = max(np.abs(ref).max(), 1.0)
        assert np.abs(np.array(got) - ref).max() <= 1e-14 * scale


@pytest.mark.parametrize("tf", [None, 0.25])
def test_rk4_step_matches(tf):
    rng = np.random.default_rng(5)
    u0, v0 = rng.standard_normal(7), rng.standard_normal(7)
    k = rng.uniform(1.0, 3.0, 7)
    f_rhs = lambda params, t, u, v: -k * u + 0.3 * v + jnp.sin(t)
    rhs = lambda t, u, v: (-torch.as_tensor(k) * u + 0.3 * v
                           + float(np.sin(t)))
    fs = f_ts.init_state(jnp.asarray(u0), jnp.asarray(v0), 0.1)
    s = timestepping.init_state(torch.as_tensor(u0), torch.as_tensor(v0),
                                0.1)
    for _ in range(2):
        fs = f_ts.rk4_step(f_rhs, None, fs, 0.1, tf)
        s = timestepping.rk4_step(rhs, s, 0.1, tf)
    assert s.t == pytest.approx(float(fs.t), rel=1e-15)
    for a, b in zip(s[:4], fs[:4]):
        assert rel(a, b) <= 1e-14


def test_bowl_demo_cli():
    cmd = [sys.executable, "-m", "fustpu_torch.demos.nonlinear_bowl",
           "--device", "cpu", "--dtype", "f64", "--elements", "16",
           "--degree", "2", "--periods", "0.2", "--progress-every", "50"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "conformal bowl" in out.stdout
    assert "Solve time per step" in out.stdout
    m = re.search(r"pressure at focus: (\S+) Pa", out.stdout)
    assert m and np.isfinite(float(m.group(1))) and float(m.group(1)) != 0.0


def _cylinder_case(tmp_path, detect_extrusion=True):
    """(port mesh, JAX mesh, two-layer Westervelt properties, facets) of an
    imported cylinder."""
    v, c, t = shapes.cylinder_mesh(0.012, 0.02, 0.008, m=3, mr=1, nr_ann=1,
                                   nz=4)
    path = msh_io.write_msh(str(tmp_path / "cyl"), v, c, t)
    mesh = msh_io.read_msh(path, 3, detect_extrusion=detect_extrusion)
    fmesh = f_msh.read_msh(path, 3, detect_extrusion=detect_extrusion)
    zc = mesh.cell_corners_flat.mean(axis=1)[:, 2]
    props = dict(sound_speed=np.where(zc < 0.01, 1500.0, 1650.0),
                 density=np.where(zc < 0.01, 1000.0, 1050.0),
                 nonlinearity=100.0, attenuation_dB=50.0)
    return mesh, fmesh, props, (mesh.boundary_facets(1),
                                mesh.boundary_facets(2))


@pytest.mark.parametrize("impl,where,fimpl", [
    ("pallas", "box", "pallas"),
    ("extruded", "prismatic", "extruded"),
    ("extruded_pallas", "prismatic", "extruded_pallas"),
    ("pallas", "prismatic", "extruded"),
    ("extruded", "general", "indexed")])
def test_jax_kernel_names_match_fustpu(tmp_path, monkeypatch, impl, where,
                                       fimpl):
    """The JAX package's stiffness_impl names where it accepts them: the
    port's model (the plain version on the CPU) against the operator the
    JAX package builds for the name, its TPU kernels in interpret mode:
    10 steps in float64 within 1e-11."""
    if where == "box":
        # the JAX model's structured Pallas kernel, in interpret mode
        orig = ps.stiffness_apply_pallas
        monkeypatch.setattr(ps, "stiffness_apply_pallas",
                            lambda op, x, **kw: orig(op, x, **dict(
                                kw, interpret=True)))
        cls, fcls, kw, mesh = _config("linear_two_layer")
        fmodel = fcls(_fmesh(mesh), dtype=jnp.float64, stiffness_impl=impl,
                      **kw)
        model = cls(mesh, dtype=torch.float64, device="cpu",
                    stiffness_impl=impl, **kw)
        u0, v0 = _initial(mesh)
    else:
        mesh, fmesh, props, args = _cylinder_case(tmp_path,
                                                  where == "prismatic")
        fmodel = FWest(fmesh, f_config.Material(**props),
                       f_config.Source(frequency=0.5e6, amplitude=1e5),
                       *args, dtype=jnp.float64, stiffness_impl=impl)
        model = WesterveltModel(mesh, Material(**props),
                                Source(frequency=0.5e6, amplitude=1e5),
                                *args, dtype=torch.float64, device="cpu",
                                stiffness_impl=impl)
        rng = np.random.default_rng(0)
        u0, v0 = (rng.standard_normal(mesh.ndofs) for _ in range(2))
    assert fmodel.impl == fimpl and model.impl == "mm"
    dt, _ = fmodel.cfl_dt()
    fout, _ = fmodel.solve(fmodel.init_state(0.0, u0=u0, v0=v0), dt, STEPS)
    out, _ = model.solve(model.init_state(0.0, u0=u0, v0=v0), dt, STEPS)
    assert rel(out.u, fout.u) <= TOL and rel(out.v, fout.v) <= TOL


def test_jax_kernel_names_resolve_by_mesh_and_device(tmp_path):
    """'pallas' and 'extruded_pallas' resolve as 'auto' does, 'extruded'
    as the plain version on a prismatic import; the extruded names need
    an imported mesh, as the JAX package's do."""
    from fustpu_torch.models.discretization import resolve_stiffness_impl

    ext = _cylinder_case(tmp_path)[0]
    box = _config("linear_uniform")[3]
    assert isinstance(ext, ExtrudedHexMesh)
    for impl, mesh, want in (("pallas", box, "cuda"), ("pallas", ext, "cuda"),
                             ("extruded_pallas", ext, "cuda"),
                             ("extruded", ext, "mm")):
        assert resolve_stiffness_impl(impl, "cuda", mesh) == want
        assert resolve_stiffness_impl(impl, "cpu", mesh) == "mm"
    for impl in ("extruded", "extruded_pallas"):
        for mesh in (box, None):
            with pytest.raises(ValueError, match="imported mesh"):
                resolve_stiffness_impl(impl, "cuda", mesh)


def test_sharded_models_take_jax_kernel_names(tmp_path):
    """The sharded models take 'pallas' and 'extruded_pallas' as 'auto':
    a rank's part (built in this process) runs the G-stream operator."""
    from fustpu_torch.models.discretization import ExtrudedStiffness
    from fustpu_torch.parallel import sharding as sh
    from fustpu_torch.parallel.extruded import (ExtrudedShardedModel,
                                                IndexedShardedModel,
                                                shard_unstructured)
    from fustpu_torch.parallel.models import ShardedModel, wants_corner

    cls, _, kw, mesh = _config("westervelt_uniform")
    model = cls(mesh, dtype=torch.float64, device="cpu", **kw)
    grid = sh.RankGrid((2, 1, 1), 0, "cpu")
    for impl in ("pallas", "extruded_pallas"):
        assert not wants_corner(model, impl)
        part = ShardedModel(model, grid, stiffness_impl=impl)
        assert not part.corner and part.local.stiffness.kernel is None
    mesh, _, props, args = _cylinder_case(tmp_path)
    model = WesterveltModel(mesh, Material(**props),
                            Source(frequency=0.5e6, amplitude=1e5), *args,
                            dtype=torch.float64, device="cpu")
    for impl in ("pallas", "extruded_pallas"):
        part = shard_unstructured(model, grid, stiffness_impl=impl)
        assert isinstance(part, ExtrudedShardedModel)
        assert isinstance(part.local.stiffness.inner, ExtrudedStiffness)
        assert IndexedShardedModel(model, grid, stiffness_impl=impl).engine \
            is False


@pytest.mark.parametrize("impl,err", [("extruded", ValueError),
                                      ("cuda_please", ValueError)])
def test_stiffness_impl_outside_the_slice_raises(impl, err):
    cls, _, kw, mesh = _config("westervelt_uniform")
    with pytest.raises(err, match="slice|expected"):
        cls(mesh, dtype=torch.float64, device="cpu", stiffness_impl=impl,
            **kw)


@pytest.mark.parametrize("impl,device,resolved", [("auto", "cuda", "cuda"),
                                                  ("auto", "cpu", "mm"),
                                                  ("mm", "cuda", "mm"),
                                                  ("mm", "cpu", "mm"),
                                                  ("pallas_corner", "cpu",
                                                   "mm"),
                                                  ("indexed", "cuda",
                                                   "cuda")])
def test_stiffness_impl_resolves_by_device(impl, device, resolved):
    """'auto' takes the kernel exactly when the tensors live on a CUDA
    device; 'mm' forces the plain version on either; the corner-mode name
    resolves as 'auto' does (it chooses the operator, not the device)."""
    from fustpu_torch.models.discretization import resolve_stiffness_impl
    assert resolve_stiffness_impl(impl, device) == resolved
