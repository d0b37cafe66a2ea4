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
from fustpu_torch.mesh.box import build_box_mesh, build_mapped_mesh  # noqa: E402
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
    out = model.solve(model.init_state(0.0, u0=u0, v0=v0), dt, STEPS)
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
    out = model.solve(st, dt, STEPS)
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


@pytest.mark.parametrize("impl,err", [("indexed", ValueError),
                                      ("extruded", ValueError),
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
                                                   "mm")])
def test_stiffness_impl_resolves_by_device(impl, device, resolved):
    """'auto' takes the kernel exactly when the tensors live on a CUDA
    device; 'mm' forces the plain version on either; the corner-mode name
    resolves as 'auto' does (it chooses the operator, not the device)."""
    from fustpu_torch.models.discretization import resolve_stiffness_impl
    assert resolve_stiffness_impl(impl, device) == resolved
