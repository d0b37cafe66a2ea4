"""bfloat16 state in the port (the JAX package's ``--dtype bf16``): the
port's bf16 models and plain applies against the JAX package's bf16
models, on the CPU, and, on a card, the bf16 forms of the G-stream
kernels (#1 / #2, #6, #11) against their plain versions (the corner
walk's bf16 forms: ``tests/test_torch_bf16_corner.py``).

The JAX package is imported inside the `ref` fixture (the tests that use
it skip where JAX is missing), so that the card tests also run on a
machine without JAX:

    python -m pytest --noconftest tests/test_torch_bf16.py -m cuda

What the bf16 tolerances allow.  One stiffness apply of either package is
within ~5e-3 of float64 (each value's storage rounds by up to 2^-9): the
port's plain version computes in float32 and rounds once, the JAX
package's operators keep bfloat16 accumulators or round at each op.  Two
such applies differ by at most the sum, so 1e-2.  The JAX package carries
a model's time and step in bfloat16 (its RK4 loop takes ``u.dtype``), so
its source ramp and phase are quantised once a step runs; the port keeps
them host float64 scalars, as in float32.  The step and trajectory
comparisons state what that costs.
"""

import functools
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fustpu_torch import convert
from fustpu_torch.config import Material, Source
from fustpu_torch.mesh import msh_io, shapes
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.mesh.extruded import as_extruded
from fustpu_torch.mesh.unstructured import from_box
from fustpu_torch.models import discretization as dz
from fustpu_torch.models.linear import LinearWaveModel
from fustpu_torch.models.westervelt import WesterveltModel
from fustpu_torch.ops import cuda_extruded as ce
from fustpu_torch.ops import cuda_indexed as ci
from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.ops import extruded as ext
from fustpu_torch.ops import indexed as idx
from fustpu_torch.ops import spectral_mm as mm
from fustpu_torch.utils import io as fio

torch.set_num_threads(1)

BF16 = torch.bfloat16
# one bf16 apply of the port against one of the JAX package (see above)
APPLY_TOL = 1e-2
# the card: a bf16 kernel against its plain version on the same bf16
# inputs; the kernel rounds y once a colour class at a shared node (up to
# four at a pencil's or a stack's side edge), the plain version once
CARD_TOL = 2.0 ** -7
CYL = dict(radius=0.012, length=0.02, piston_radius=0.008, m=3, mr=1,
           nr_ann=1)
CONFIGS = ["linear_uniform", "linear_two_layer", "westervelt_uniform",
           "westervelt_two_layer"]


def rel(a, b):
    f = lambda t: (t.double().numpy() if isinstance(t, torch.Tensor)
                   else np.asarray(t, np.float64))
    a, b = f(a).reshape(-1), f(b).reshape(-1)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules; skips where JAX is missing."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from fustpu import config as f_config
    from fustpu.mesh import msh_io as f_msh
    from fustpu.mesh.box import BoxMesh
    from fustpu.models.linear import LinearWaveModel as FLinear
    from fustpu.models.westervelt import WesterveltModel as FWest
    from fustpu.ops import pallas_stiffness as ps
    from fustpu.ops import spectral_mm as f_mm
    from fustpu.utils import io as f_io

    return SimpleNamespace(jax=jax, jnp=jnp, f_config=f_config, f_msh=f_msh,
                           BoxMesh=BoxMesh, FLinear=FLinear, FWest=FWest,
                           ps=ps, f_mm=f_mm, f_io=f_io)


def _fmesh(ref, mesh):
    return ref.BoxMesh(degree=mesh.degree, nc=mesh.nc, lo=mesh.lo,
                       hi=mesh.hi, vertex_coords=mesh.vertex_coords)


def _layers(shape, split, base, ratio):
    a = np.full(shape, base)
    a[split] = base * ratio
    return a


@functools.lru_cache(maxsize=None)
def _box_config(name, amplitude=None):
    """(port class, JAX class name, keyword arguments, mesh) of a 4^3 box
    at P = 3: a phased linear source and one absorbing face, or a
    Westervelt medium absorbing on every face; two-layer: the far half of
    the cells 6% faster and 5% denser."""
    L = 0.006
    mesh = build_box_mesh((4, 4, 4), 3, hi=(L, L, L), perturb=0.1, seed=3)
    src = Source(frequency=0.5e6, amplitude=60000.0 if amplitude is None
                 else amplitude)
    far = (slice(2, None),)
    two = name.endswith("two_layer")
    c = _layers(mesh.nc, far, 1500.0, 1.06) if two else 1500.0
    rho = _layers(mesh.nc, far, 1000.0, 1.05) if two else 1000.0
    kw = dict(source=src, source_facets=mesh.boundary_facets("x-"))
    if name.startswith("linear"):
        kw.update(material=Material(sound_speed=c, density=rho),
                  absorbing_facets=mesh.boundary_facets("x+"))
        return LinearWaveModel, "FLinear", kw, mesh
    kw.update(material=Material(sound_speed=c, density=rho,
                                nonlinearity=100.0, attenuation_dB=50.0),
              absorbing_facets=mesh.all_boundary_facets())
    return WesterveltModel, "FWest", kw, mesh


def _f_kwargs(ref, kw):
    """The JAX package's config objects for the port's keyword arguments."""
    m, s = kw["material"], kw["source"]
    return dict(kw, material=ref.f_config.Material(
        sound_speed=m.sound_speed, density=m.density,
        nonlinearity=m.nonlinearity, attenuation_dB=m.attenuation_dB),
        source=ref.f_config.Source(frequency=s.frequency,
                                   amplitude=s.amplitude))


def _initial(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape), rng.standard_normal(shape)


def _np_params(ref, fmodel):
    """A JAX model's params as numpy arrays (bf16 as ml_dtypes arrays),
    its stiffness as the keyword arrays of convert.stiffness_from_fustpu."""
    p = fmodel.params
    out = {k: np.asarray(v) for k, v in p.items() if k != "stiff"}
    op = p["stiff"]
    if isinstance(op, ref.f_mm.MMStiffness):
        out["stiff"] = dict(G=np.asarray(op.G),
                            Dt=tuple(np.asarray(d) for d in op.Dt))
    elif isinstance(op, ref.ps.PallasStiffnessPair):
        out["stiff"] = dict(G=np.asarray(op.G), D=np.asarray(op.D_host),
                            C=np.asarray(op.C))
    else:
        out["stiff"] = dict(G=np.asarray(op.G), D=np.asarray(op.D_host))
    return out


def _interpret(ref, monkeypatch):
    """The JAX package's structured Pallas kernels in interpret mode (as
    its own CPU tests run them)."""
    for name in ("stiffness_apply_pallas", "stiffness_apply_pallas_pair"):
        orig = getattr(ref.ps, name)
        monkeypatch.setattr(ref.ps, name, functools.partial(
            lambda f, *a, **kw: f(*a, **dict(kw, interpret=True)), orig))


def _cylinder(tmp_path):
    """The test cylinder (an O-grid of 4 layers) as a .msh file."""
    v, c, t = shapes.cylinder_mesh(nz=4, **CYL)
    return msh_io.write_msh(str(tmp_path / "cyl"), v, c, t)


# ---------------------------------------------------------------------------
# One apply, one RHS, one step and ten steps against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("where", ["box", "prismatic", "general"])
@pytest.mark.parametrize("form", ["single", "pair"])
def test_one_apply_matches_fustpu(ref, tmp_path, monkeypatch, where, form):
    """The port's bf16 stiffness apply (#1 / #2's plain version on a box,
    #6's on a prismatic import, #11's on a general one; single: a
    two-layer linear model, the coefficient in G; pair: a two-layer
    Westervelt model) against the JAX package's bf16 operator on the same
    model (its structured Pallas kernel in interpret mode on the box, its
    extruded Pallas kernel in interpret mode on the prismatic import, its
    indexed operator on the general one): <= APPLY_TOL, and each within
    APPLY_TOL of the port's float64 apply."""
    jnp = ref.jnp
    cls = LinearWaveModel if form == "single" else WesterveltModel
    fcls = ref.FLinear if form == "single" else ref.FWest
    beta = {} if form == "single" else dict(nonlinearity=100.0,
                                            attenuation_dB=50.0)
    if where == "box":
        _interpret(ref, monkeypatch)
        physics = "linear" if form == "single" else "westervelt"
        _, _, kw, mesh = _box_config(f"{physics}_two_layer")
        fmesh, impl = _fmesh(ref, mesh), "pallas"
    else:
        path = _cylinder(tmp_path)
        mesh = msh_io.read_msh(path, 3,
                               detect_extrusion=where == "prismatic")
        fmesh = ref.f_msh.read_msh(path, 3,
                                   detect_extrusion=where == "prismatic")
        zc = mesh.cell_corners_flat.mean(axis=1)[:, 2]
        mat = Material(sound_speed=np.where(zc < 0.01, 1500.0, 1650.0),
                       density=np.where(zc < 0.01, 1000.0, 1050.0), **beta)
        kw = dict(material=mat, source=Source(frequency=0.5e6,
                                              amplitude=1e5),
                  source_facets=mesh.boundary_facets(1),
                  absorbing_facets=mesh.boundary_facets(2))
        impl = "extruded_pallas" if where == "prismatic" else "auto"
    fmodel = fcls(fmesh, dtype=jnp.bfloat16, stiffness_impl=impl,
                  **_f_kwargs(ref, kw))
    model = cls(mesh, dtype=BF16, device="cpu", **kw)
    model64 = cls(mesh, dtype=torch.float64, device="cpu", **kw)
    assert model.stiffness.is_pair == (form == "pair")
    u, v = _initial(mesh.grid_shape)
    ub, vb = (torch.as_tensor(a).to(BF16) for a in (u, v))
    g = mesh.grid_shape
    if form == "single":
        got = model.stiffness(ub.reshape(g))
        want = fmodel._apply_stiffness(
            fmodel.params, jnp.asarray(u, jnp.bfloat16).reshape(-1))
        exact = model64.stiffness(ub.double().reshape(g))
    else:
        got = model.stiffness.pair(ub.reshape(g), vb.reshape(g))
        want = fmodel._apply_stiffness(
            fmodel.params, jnp.asarray(u, jnp.bfloat16).reshape(-1),
            jnp.asarray(v, jnp.bfloat16).reshape(-1))
        exact = model64.stiffness.pair(ub.double().reshape(g),
                                       vb.double().reshape(g))
    assert got.dtype == BF16
    want = np.asarray(want).astype(np.float64)
    assert rel(got, exact) <= APPLY_TOL
    assert rel(want, exact) <= APPLY_TOL
    assert rel(got, want) <= APPLY_TOL


@functools.lru_cache(maxsize=None)
def _bf16_pair(name, amplitude=None):
    """The JAX package's bf16 and float32 models of a box config ('auto':
    its matmul path on the CPU) and their dt."""
    import jax.numpy as jnp
    from fustpu import config as f_config
    from fustpu.mesh.box import BoxMesh
    from fustpu.models.linear import LinearWaveModel as FLinear
    from fustpu.models.westervelt import WesterveltModel as FWest

    ref = SimpleNamespace(f_config=f_config, BoxMesh=BoxMesh)
    cls, fname, kw, mesh = _box_config(name, amplitude)
    fcls = FLinear if fname == "FLinear" else FWest
    fkw = _f_kwargs(ref, kw)
    fb = fcls(_fmesh(ref, mesh), dtype=jnp.bfloat16, **fkw)
    f32 = fcls(_fmesh(ref, mesh), dtype=jnp.float32, **fkw)
    return fb, f32, f32.cfl_dt()[0]


def _port_models(ref, name, amplitude=None):
    """The port's bf16 models of a box config: built on the host, and from
    the JAX bf16 model's arrays through convert.model_from_fustpu."""
    cls, _, kw, mesh = _box_config(name, amplitude)
    fb = _bf16_pair(name, amplitude)[0]
    host = cls(mesh, dtype=BF16, device="cpu", **kw)
    conv, _ = convert.model_from_fustpu(
        cls, _np_params(ref, fb), mesh=mesh, material=kw["material"],
        source=kw["source"], source_facets=kw["source_facets"], dtype=BF16,
        device="cpu")
    return host, conv


@pytest.mark.parametrize("name", CONFIGS)
def test_rhs_and_step_match_fustpu(ref, name):
    """One RHS of the port's bf16 models (built on the host, and from the
    JAX model's bf16 arrays) against the JAX package's bf16 model, at a
    time given as a float (its source coefficients then computed in
    float32 and cast): <= APPLY_TOL.  One RK4 step from a seeded state
    with the source off (amplitude 0, so that the JAX package's bf16 time
    does not enter): <= APPLY_TOL; the JAX package's dt rounds to bf16
    (2^-9) and its RK updates round at each op, the port's once."""
    jnp = ref.jnp
    fb, _, _ = _bf16_pair(name)
    u0, v0 = _initial(fb.mesh.grid_shape, seed=1)
    for model in _port_models(ref, name):
        for t in (1.3e-7, 9.5e-6):
            want = np.asarray(fb.rhs(t, jnp.asarray(u0, jnp.bfloat16),
                                     jnp.asarray(v0, jnp.bfloat16)))
            got = model.rhs(t, torch.as_tensor(u0).to(BF16),
                            torch.as_tensor(v0).to(BF16))
            assert got.dtype == BF16
            assert rel(got, want.astype(np.float64)) <= APPLY_TOL
    fb0, _, dt = _bf16_pair(name, 0.0)
    for model in _port_models(ref, name, 0.0):
        s = model.step(model.init_state(0.0, u0=u0, v0=v0), dt)
        fs = fb0.step(fb0.init_state(0.0, u0=u0, v0=v0), dt)
        for a, b in zip(s[:2], fs[:2]):
            assert a.dtype == BF16
            assert rel(a, np.asarray(b).astype(np.float64)) <= APPLY_TOL


@pytest.mark.parametrize("name", ["linear_two_layer",
                                  "westervelt_two_layer"])
def test_fustpu_bf16_time_quantises_its_source(ref, name):
    """The reference's bf16 time (ROADMAP Known traps): its RHS at t =
    1.3e-7 s given as a bf16 scalar lands far from its float32 RHS
    (measured 95.4% / 96.3% here: the Hann ramp's start rounds to 0),
    given as a float within APPLY_TOL (0.51% / 0.55%), which is how the
    port computes its source coefficients (host float64 scalars)."""
    jnp = ref.jnp
    fb, f32, _ = _bf16_pair(name)
    u0, v0 = _initial(fb.mesh.grid_shape, seed=1)
    want = np.asarray(f32.rhs(1.3e-7, jnp.asarray(u0, jnp.float32),
                              jnp.asarray(v0, jnp.float32)))
    ub, vb = jnp.asarray(u0, jnp.bfloat16), jnp.asarray(v0, jnp.bfloat16)
    at_bf16 = np.asarray(fb.rhs(jnp.asarray(1.3e-7, jnp.bfloat16), ub, vb))
    at_float = np.asarray(fb.rhs(1.3e-7, ub, vb))
    assert rel(at_bf16.astype(np.float64), want) > 0.5
    assert rel(at_float.astype(np.float64), want) <= APPLY_TOL


# 10 steps from a seeded state with the source on, port against the JAX
# package's bf16 model.  Measured on these boxes (4^3, P = 3; linear
# uniform, linear two-layer, Westervelt uniform, Westervelt two-layer):
# 3.5e-2, 3.8e-2, 0.141, 0.126.  That is the JAX package's own bf16 drift
# from its float32 run (3.6e-2, 3.7e-2, 0.125, 0.114: its bf16 time
# quantises the source ramp and phase at each stage, and its RK updates
# round at each op), while the port's bf16 stays within 3.1e-3, 4.4e-3,
# 7.9e-3, 6.1e-3 of its float32 run, and the two packages' float32 runs
# agree to 3e-7.  0.2 is above the largest; a trajectory that left the
# physics (a wrong coefficient or source) parts by O(1).
TRAJ_TOL = 0.2
# the port's bf16-vs-float32 drift against the JAX package's on the same
# case: no larger, up to this factor
DRIFT_FACTOR = 1.5


@pytest.mark.parametrize("name", CONFIGS)
def test_trajectory_and_drift_against_fustpu(ref, name):
    """10 RK4 steps of the port's bf16 model (built from the JAX model's
    bf16 arrays) against the JAX package's bf16 model (TRAJ_TOL), and the
    port's bf16-vs-float32 drift within DRIFT_FACTOR of the JAX package's
    bf16-vs-float32 drift on the same case."""
    cls, _, kw, mesh = _box_config(name)
    fb, f32, dt = _bf16_pair(name)
    u0, v0 = _initial(mesh.grid_shape)
    model = _port_models(ref, name)[1]
    model32 = cls(mesh, dtype=torch.float32, device="cpu", **kw)
    out, _ = model.solve(model.init_state(0.0, u0=u0, v0=v0), dt, 10)
    out32, _ = model32.solve(model32.init_state(0.0, u0=u0, v0=v0), dt, 10)
    fo, _ = fb.solve(fb.init_state(0.0, u0=u0, v0=v0), dt, 10)
    fo32, _ = f32.solve(f32.init_state(0.0, u0=u0, v0=v0), dt, 10)
    fu = np.asarray(fo.u).astype(np.float64)
    assert out.u.dtype == BF16 and bool(torch.isfinite(out.u).all())
    assert rel(out.u, fu) <= TRAJ_TOL
    drift, fdrift = rel(out.u, out32.u), rel(fu, np.asarray(fo32.u))
    assert drift <= DRIFT_FACTOR * fdrift, (drift, fdrift)


# ---------------------------------------------------------------------------
# Round trips: the plain versions, convert, checkpoints
# ---------------------------------------------------------------------------

def _ops(tmp_path, where, P=3):
    """(kernel-layout operators single and pair in bf16 and float32 of the
    same numbers, seeded bf16 fields, plain functions) on a box, a
    prismatic import or a general one."""
    rng = np.random.default_rng(7)
    if where == "box":
        mesh = build_box_mesh((3, 4, 5), P, hi=(1.0, 0.8, 1.3),
                              perturb=0.15, seed=7)
        plain = (cs.stiffness_plain, cs.stiffness_pair_plain)
    elif where == "prismatic":
        mesh = as_extruded(from_box(build_box_mesh((3, 4, 5), P),
                                    shuffle_seed=5))
        plain = (ce.extruded_plain, ce.extruded_pair_plain)
    else:
        mesh = from_box(build_box_mesh((3, 4, 5), P, perturb=0.15, seed=7),
                        shuffle_seed=5)
        plain = (ci.indexed_plain, ci.indexed_pair_plain)
    disc = dz.Discretization(mesh)
    shape = mesh.nc if hasattr(mesh, "nc") else (mesh.num_cells,)
    c1 = rng.uniform(0.5, 2.0, shape)
    c2 = rng.uniform(-2.0, 2.0, shape)
    xs = [torch.as_tensor(rng.standard_normal(mesh.grid_shape)).to(BF16)
          for _ in range(2)]
    ops = {dt: (disc.stiffness_op(dt, "cpu", coeff=c1),
                disc.stiffness_op(dt, "cpu", pair=(c1, c2)))
           for dt in (BF16,)}
    return ops[BF16], xs, plain


def _widen_op(op):
    """A kernel-layout operator's bf16 tensors as float32 (exact)."""
    return op._replace(**{k: v.float() for k, v in op._asdict().items()
                          if isinstance(v, torch.Tensor)
                          and v.dtype == BF16})


@pytest.mark.parametrize("where", ["box", "prismatic", "general"])
def test_plain_bf16_is_float32_rounded_once(tmp_path, where):
    """The bf16 plain versions (single and pair) equal the float32 apply of
    the same numbers rounded to bf16 once, bitwise: the semantics the bf16
    kernels are held to."""
    (single, pair), xs, (f1, f2) = _ops(tmp_path, where)
    y = f1(single, xs[0])
    assert y.dtype == BF16
    assert torch.equal(y, f1(_widen_op(single), xs[0].float()).to(BF16))
    y2 = f2(pair, *xs)
    assert y2.dtype == BF16
    assert torch.equal(y2, f2(_widen_op(pair), xs[0].float(),
                              xs[1].float()).to(BF16))


def test_cpu_bf16_axpy_is_float32_rounded_once():
    """`vector.axpy` / `axpy_` on bf16 CPU tensors: y + alpha x formed in
    float32 and rounded once, so an element's result does not depend on
    where it lies in the tensor (PyTorch's own CPU bf16 add rounds alpha
    in its vector body and not in its scalar tail: a node two ranks share
    would part across them)."""
    from fustpu_torch.ops import vector as vec

    rng = np.random.default_rng(5)
    x, y = (torch.as_tensor(rng.standard_normal(1003)).to(BF16)
            for _ in range(2))
    alpha = 1.234e-3
    want = torch.add(y.float(), x.float(), alpha=alpha).to(BF16)
    got = vec.axpy(alpha, x, y)
    assert got.dtype == BF16 and torch.equal(got, want)
    tail = torch.stack([vec.axpy(alpha, x[k:k + 1], y[k:k + 1])[0]
                        for k in range(x.numel())])
    assert torch.equal(tail, want)
    z = y.clone()
    assert vec.axpy_(alpha, x, z) is z and torch.equal(z, want)


def test_plain_apply_functions_round_once():
    """`rounds_once` on the three plain modules' entry points: float32 in,
    float32 out unchanged; bf16 in, the float32 result rounded once."""
    for f in (mm.stiffness_apply_mm, mm.stiffness_apply_mm_pair,
              ext.stiffness_apply_extruded, ext.stiffness_apply_extruded_pair,
              idx.stiffness_apply_indexed, idx.stiffness_apply_indexed_pair):
        assert f.__wrapped__ is not None
    mesh = build_box_mesh((2, 3, 2), 2, perturb=0.1, seed=1)
    disc = dz.Discretization(mesh)
    op = cs.to_mm(disc.stiffness_op(BF16, "cpu"))[0]
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        mesh.grid_shape)).to(BF16)
    y = mm.stiffness_apply_mm(op, x)
    wide = mm.MMStiffness(W=tuple(w.float() for w in op.W),
                          Dt=tuple(d.float() for d in op.Dt),
                          G=op.G.float())
    y32 = mm.stiffness_apply_mm(wide, x.float())
    assert y32.dtype == torch.float32
    assert torch.equal(y, y32.to(BF16))


@pytest.mark.parametrize("layout", ["mm", "pallas"])
def test_convert_of_bf16_arrays_is_bitwise(ref, monkeypatch, layout):
    """A port bf16 model built from a JAX bf16 model's arrays
    (`convert.model_from_fustpu`, the arrays ml_dtypes bfloat16) holds the
    same bits: G (in the kernel layout), D, the diagonal vectors and the
    state."""
    jnp = ref.jnp
    cls, fname, kw, mesh = _box_config("westervelt_two_layer")
    fcls = getattr(ref, fname)
    fmodel = fcls(_fmesh(ref, mesh), dtype=jnp.bfloat16,
                  stiffness_impl="auto" if layout == "mm" else "pallas",
                  **_f_kwargs(ref, kw))
    params = _np_params(ref, fmodel)
    u0, v0 = _initial(mesh.grid_shape)
    s0 = fmodel.init_state(0.0, u0=u0, v0=v0)
    state = tuple(np.asarray(a) for a in s0[:4]) + (0.0,)
    assert str(state[0].dtype) == "bfloat16"
    model, st = convert.model_from_fustpu(
        cls, params, state, mesh=mesh, material=kw["material"],
        source=kw["source"], source_facets=kw["source_facets"], dtype=BF16,
        device="cpu")
    f64 = lambda a: np.asarray(a, np.float64)
    for name in cls.VECTORS:
        if params.get(name) is not None:
            buf = getattr(model, name)
            assert buf.dtype == BF16
            assert np.array_equal(buf.double().numpy(),
                                  f64(params[name]).reshape(-1))
    for a, b in zip(st[:4], state[:4]):
        assert a.dtype == BF16
        assert np.array_equal(a.double().numpy(), f64(b))
    host = convert.stiffness_from_fustpu(nc=mesh.nc, **params["stiff"])
    op = host.to_device(BF16, "cpu", mesh.nc)
    if layout == "pallas":
        # the fused layout carries G and C as they are: bitwise
        assert np.array_equal(op.G.double().numpy(), host.G)
        assert np.array_equal(op.C.double().numpy(), host.C)
    else:
        # the matmul layout's D is its bf16 block-diagonal Dt's block
        assert np.array_equal(op.D.double().numpy(), host.D)


def test_bf16_checkpoint_restart_is_bitwise(tmp_path):
    """A bf16 state through `save_checkpoint` (written as float32, read
    with numpy alone) and `state_from_checkpoint`: bitwise; 5 + 5 steps
    through the file equal 10; the async `Checkpointer` round trip
    bitwise."""
    cls, _, kw, mesh = _box_config("westervelt_two_layer")
    model = cls(mesh, dtype=BF16, device="cpu", **kw)
    dt, _ = model.cfl_dt()
    s5, _ = model.solve(model.init_state(0.0, *_initial(mesh.grid_shape)),
                        dt, 5)
    path = fio.save_checkpoint(str(tmp_path / "ck"), s5, 5)
    with np.load(path) as z:
        assert z["u"].dtype == np.float32
    arrays, step, _ = fio.load_checkpoint(path)
    back = fio.state_from_checkpoint(model, arrays)
    assert step == 5 and back.t == s5.t
    for a, b in zip(back[:4], s5[:4]):
        assert a.dtype == BF16 and torch.equal(a, b)
    s10, _ = model.solve(s5, dt, 5)
    r10, _ = model.solve(back, dt, 5)
    for a, b in zip(s10[:4], r10[:4]):
        assert torch.equal(a, b)
    ck = fio.Checkpointer(str(tmp_path / "async"))
    ck.save(s5, 5)
    ck.wait()
    got, step = ck.restore(like=s5)
    assert step == 5 and all(torch.equal(a, b)
                             for a, b in zip(got[:4], s5[:4]))


def test_fustpu_bf16_checkpoint_reads_back(ref, tmp_path):
    """The JAX package writes a bf16 state's fields as raw 2-byte records
    (numpy's |V2: they read back as bytes, not numbers); the port's
    `load_checkpoint` reads them as the bf16 bits they are, and a bf16
    model resumes from them bitwise."""
    from fustpu.models.timestepping import RKState as FState

    jnp = ref.jnp
    cls, _, kw, mesh = _box_config("linear_uniform")
    u0, v0 = _initial(mesh.grid_shape)
    fields = [jnp.asarray(a, jnp.bfloat16) for a in (u0, v0, u0, v0)]
    path = ref.f_io.save_checkpoint(
        str(tmp_path / "f"), FState(*fields, t=jnp.asarray(
            2.5e-6, jnp.bfloat16)), 7)
    with np.load(path) as z:
        assert z["u"].dtype.kind == "V"
    arrays, step, _ = fio.load_checkpoint(path)
    assert step == 7 and arrays["u"].dtype == np.float32
    model = cls(mesh, dtype=BF16, device="cpu", **kw)
    st = fio.state_from_checkpoint(model, arrays)
    for a, b in zip(st[:4], fields):
        assert np.array_equal(a.double().numpy(),
                              np.asarray(b, np.float64))
    assert st.t == float(np.asarray(jnp.asarray(2.5e-6, jnp.bfloat16),
                                    np.float64))


# ---------------------------------------------------------------------------
# Refusals, demos
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,where", [
    ("pallas_corner", "box"), ("extruded_pallas_corner", "prismatic"),
    ("pallas_corner", "prismatic"), ("indexed_engine", "prismatic"),
    ("indexed_engine", "general")])
def test_corner_and_engine_refuse_bf16(tmp_path, impl, where):
    """The corner mode on a box or a prismatic import and the staged
    engine, which refused bf16 until their kernels had bf16 forms, now
    resolve bf16 as they resolve float32, on the CPU and on the card.  A
    bf16 model in the corner mode builds its corner operator with bf16
    channels and float32 GLL nodes and weights; one on the engine (a
    prismatic and a general import) builds its engine operator with bf16
    G, D and pair coefficients C."""
    if where == "box":
        mesh = build_box_mesh((3, 3, 3), 2)
        sf, af = mesh.boundary_facets("x-"), mesh.boundary_facets("x+")
    else:
        path = _cylinder(tmp_path)
        mesh = msh_io.read_msh(path, 2,
                               detect_extrusion=where == "prismatic")
        sf, af = mesh.boundary_facets(1), mesh.boundary_facets(2)
    build = functools.partial(
        WesterveltModel, mesh, material=Material(sound_speed=1500.0,
                                                 density=1000.0),
        source=Source(frequency=0.5e6, amplitude=1e5), source_facets=sf,
        absorbing_facets=af, dtype=BF16, device="cpu", stiffness_impl=impl)
    for device in ("cpu", "cuda"):
        f32 = dz.resolve_stiffness_impl(impl, device, mesh, torch.float32)
        assert f32 in ("cuda", "mm")
        assert dz.resolve_stiffness_impl(impl, device, mesh, BF16) == f32
    if impl == "indexed_engine":
        zc = mesh.cell_corners_flat.mean(axis=1)[:, 2]
        model = build(material=Material(
            sound_speed=np.where(zc < 0.01, 1500.0, 1650.0),
            density=np.where(zc < 0.01, 1000.0, 1050.0)))
        st = model.stiffness
        assert isinstance(st, dz.EngineStiffness) and st.is_pair
        for buf in (st.plain_G6, st.plain_D, st.plain_c1, st.plain_c2):
            assert buf.dtype == BF16
        return
    model = build()
    assert isinstance(model.stiffness, dz.CornerStiffness)
    assert model.stiffness.T.dtype == BF16 == model.stiffness.D.dtype
    assert model.stiffness.Q.dtype == torch.float32
    assert "_G_host" not in model.disc.__dict__


def test_corner_name_on_a_general_mesh_takes_bf16(tmp_path):
    """On a general import the corner names build the indexed operator (as
    the JAX package routes them), which has a bf16 form."""
    path = _cylinder(tmp_path)
    mesh = msh_io.read_msh(path, 2, detect_extrusion=False)
    model = LinearWaveModel(
        mesh, Material(sound_speed=1500.0, density=1000.0),
        Source(frequency=0.5e6, amplitude=1e5), mesh.boundary_facets(1),
        mesh.boundary_facets(2), dtype=BF16, device="cpu",
        stiffness_impl="pallas_corner")
    assert isinstance(model.stiffness, dz.IndexedStiffness)
    assert model.stiffness.plain_G.dtype == BF16


# every demo that takes --dtype (add_device_args or demo_argparser), and
# exp_kernel_speed's positional dtype
DEMOS = ["anchors", "capacity", "capacity_imported", "exp_degree_sweep",
         "exp_engine_bf16", "exp_engine_mesh", "exp_indexed_pair",
         "exp_isoparametric_bowl",
         "exp_sharded_engine", "linear_box", "linear_piston",
         "nonlinear_bowl", "nonlinear_box", "sharded_box", "time_halo",
         "time_operators", "exp_kernel_speed"]


def _demo_parser(mod):
    if hasattr(mod, "parser"):
        return mod.parser()
    from fustpu_torch.demos import common

    return common.demo_argparser()


@pytest.mark.parametrize("name", DEMOS)
def test_demos_take_dtype_bf16(name):
    """--dtype bf16 (exp_kernel_speed: its positional dtype) parses in
    every demo that takes a dtype, and picks torch.bfloat16."""
    from fustpu_torch.demos import common

    mod = importlib.import_module(f"fustpu_torch.demos.{name}")
    argv = ["bf16"] if name == "exp_kernel_speed" else ["--dtype", "bf16"]
    if name == "exp_engine_mesh":
        argv = ["mesh.msh", *argv]
    args = _demo_parser(mod).parse_args(argv)
    assert common.pick_dtype(args.dtype) == BF16


def test_linear_box_demo_runs_bf16_on_cpu(tmp_path, capsys):
    """The linear box demo end to end in bf16 on the CPU (the plain
    versions): a finite, non-zero field, a checkpoint that resumes."""
    from fustpu_torch.demos import linear_box

    model, state = linear_box.main(
        ["--device", "cpu", "--dtype", "bf16", "--elements", "4",
         "--degree", "2", "--periods", "0.5", "--checkpoint",
         str(tmp_path / "ck"), "--checkpoint-every", "10"])
    assert model.dtype == BF16 and state.u.dtype == BF16
    assert bool(torch.isfinite(state.u).all())
    assert float(state.u.abs().max()) > 0.0
    assert list(tmp_path.glob("ck_*.npz"))


def test_bf16_schedules_fit_the_card():
    """The bf16 layouts of the pencil, stack and chunk kernels (the stream
    in 2 bytes a value, everything else in float32, the cells' f1, f2 of
    their own): every schedule fits a block's shared memory, its stages
    hold each chunk's 16 B span, the spans are 16 B-aligned inside G and
    cut back at its end, and a bf16 stage is half a float32 one plus the
    slack."""
    for P in range(2, 11):
        n = P + 1
        for pair in (False, True):
            s16 = cs.pencil_schedule((5, 3, 7), P, 2, 132, pair)
            s32 = cs.pencil_schedule((5, 3, 7), P, 4, 132, pair,
                                     cpb=s16.cpb)
            assert s16.smem + cs._static_smem(P, 2) <= cs.SMEM_BLOCK
            cell = 6 * n ** 3 * 2
            assert s16.stage_bytes == cs._round16(s16.cpb * cell + 16)
            assert s16.stage_bytes < s32.stage_bytes
            off, nbytes = s16.chunks[:, 2], s16.chunks[:, 3]
            total = 5 * 3 * 7 * cell
            assert (off % 16 == 0).all() and (nbytes % 16 == 0).all()
            assert (off + nbytes <= total).all()
            assert (nbytes <= s16.stage_bytes).all()
            start = s16.chunks[:, 0] * cell
            end = (s16.chunks[:, 0] + s16.chunks[:, 1]) * cell
            assert (off <= start).all() and (end - (off + nbytes) < 16).all()
            # beside the stages, the bf16 layouts hold float32's buffers
            # and the cells' f1, f2 slots, 2 n^3 float32 a cell
            slots = 2 * n ** 3 * s16.cpb * 4
            for layout in (
                    lambda b: cs.pencil_smem(P, b, s16.cpb, pair),
                    lambda b: ci.chunk_smem(P, b, s16.cpb,
                                            s16.cpb * n ** 3, pair)):
                (st16, sm16), (st32, sm32) = layout(2), layout(4)
                assert sm16 - 2 * st16 == sm32 - 2 * st32 + slots


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card_cases(P, tmp_path):
    """(route, mesh) of the odd meshes of chip_smoke's phases 3, 8 and 12
    at degree P."""
    v, c, t = shapes.cylinder_mesh(nz=4 if P <= 6 else 2, **CYL)
    path = msh_io.write_msh(str(tmp_path / f"cyl{P}"), v, c, t)
    small = (5, 3, 7) if P <= 6 else (3, 3, 4)
    return [("#1 / #2", build_box_mesh(small, P, hi=(1.0, 0.8, 1.3),
                                       perturb=0.15, seed=P)),
            ("#6", msh_io.read_msh(path, P)),
            ("#6", as_extruded(from_box(build_box_mesh(small, P),
                                        shuffle_seed=11))),
            ("#11", msh_io.read_msh(path, P, detect_extrusion=False)),
            ("#11", from_box(build_box_mesh(small, P, perturb=0.15, seed=P),
                             shuffle_seed=11))]


@pytest.mark.cuda
@pytest.mark.parametrize("P", range(2, 11))
def test_bf16_kernels_match_plain_on_card(P, tmp_path):
    """The bf16 forms of #1 / #2, #6 and #11, single (with and without a
    coefficient in G) and pair, against their plain bf16 versions on the
    same inputs (CARD_TOL), two applies bitwise equal, each launch counted
    in its bf16 counter (of the walk that runs at P) and in no float32
    one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    forms = {"#1 / #2": ((cs.stiffness_plain, cs.stiffness_pair_plain),
                         (cs.stiffness, cs.stiffness_pair)),
             "#6": ((ce.extruded_plain, ce.extruded_pair_plain),
                    (ce.extruded, ce.extruded_pair)),
             "#11": ((ci.indexed_plain, ci.indexed_pair_plain),
                     (ci.indexed, ci.indexed_pair))}
    for mod in (cs, ce, ci):
        mod.reset_launches()
    rng = np.random.default_rng(P)
    for route, mesh in _card_cases(P, tmp_path):
        disc = dz.Discretization(mesh)
        shape = mesh.nc if hasattr(mesh, "nc") else (mesh.num_cells,)
        c1 = rng.uniform(0.5, 2.0, shape)
        c2 = rng.uniform(-1.5, -0.5, shape)
        xs = [torch.as_tensor(rng.standard_normal(mesh.grid_shape),
                              device="cuda").to(BF16) for _ in range(2)]
        for kw in ({}, {"coeff": c1}, {"pair": (c1, c2)}):
            pair = "pair" in kw
            plain, kernel = (f[pair] for f in forms[route])
            op = disc.stiffness_op(BF16, "cuda", **kw)
            a = xs[:1 + pair]
            y = kernel(op, *a)
            torch.cuda.synchronize()
            assert y.dtype == BF16
            assert rel(y.cpu(), plain(op, *a).cpu()) <= CARD_TOL, (route,
                                                                   kw)
            assert torch.equal(kernel(op, *a), y)
    # the walk that each G-stream form runs at P: the lean walk (the lean
    # chunk kernel) or the first
    walked = ({cs.bf16_key(n, cs.lean_runs(P, n.endswith("pair"), BF16))
               for n in ("stiffness", "stiffness_pair")}
              | {cs.bf16_key(n, ce.lean_runs(P, BF16))
                 for n in ("extruded", "extruded_pair")}
              | {cs.bf16_key(n, ci.lean_runs(P, n.endswith("pair"), BF16))
                 for n in ("indexed", "indexed_pair")})
    for mod in (cs, ce, ci):
        assert all(bool(v) == (k in walked)
                   for k, v in mod.bf16_launches.items()), mod.bf16_launches
        assert not any(mod.launches.values()), mod.launches
