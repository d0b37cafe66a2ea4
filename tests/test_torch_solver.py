"""The port's `timestepping.make_solver` (the RK4 solve as replays of a
captured CUDA graph on the card, the same steps run eagerly on the CPU)
against the JAX package's `make_solver` on the CPU in float64: linear and
Westervelt models, uniform and two-layer, with and without the clamp onto
tf and a probe, 10 steps on a 4^3 P=2 box; against the port's eager
`timestepping.solve` in float64, float32 and bfloat16; the solver cache's
key, the coefficient table's step times and clamped last dt, the bfloat16
update's rounding on the CPU, the cache dropped on an attribute change,
the sharded rank parts' eager solves, and the RK4 update kernel's launch
arguments and checks.  On a card: the replayed graphs bitwise equal to the
same steps launched eagerly (f32 box, Westervelt pair, bf16 engine on a
general mesh), each replay counted, a capture that cannot run raising, and
the update kernel bitwise PyTorch's add with a Python float.

The JAX package is imported inside the `ref` fixture, so that the card
tests also run on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_solver.py -m cuda
"""

import functools

import numpy as np
import pytest
import torch

from fustpu_torch.config import RK4_A, RK4_B, RK4_C, Material, Source
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.mesh.unstructured import from_box
from fustpu_torch.models import timestepping as ts
from fustpu_torch.models.linear import LinearWaveModel
from fustpu_torch.models.westervelt import WesterveltModel
from fustpu_torch.ops import cuda_vector as cv
from fustpu_torch.ops import launch
from fustpu_torch.ops import vector as vec
from fustpu_torch.parallel.models import host_vectors, local_model

torch.set_num_threads(1)

F64 = torch.float64
BF16 = torch.bfloat16
TOL = 1e-11            # 10 RK4 steps of the models' f64 gate
STEPS = 10
L = 0.006
CONFIGS = ["linear_uniform", "linear_two_layer", "westervelt_uniform",
           "westervelt_two_layer"]
PROBE = np.array([5, 300, 700])      # flat dofs of the 9^3 grid


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@functools.lru_cache(maxsize=None)
def _mesh(nc=(4, 4, 4), degree=2):
    return build_box_mesh(nc, degree, hi=(L, L, L), perturb=0.1, seed=3)


def _material(name, nc):
    nl = name.startswith("westervelt")
    extra = dict(nonlinearity=100.0, attenuation_dB=50.0) if nl else {}
    if not name.endswith("two_layer"):
        return Material(sound_speed=1500.0, density=1000.0, **extra)
    c, rho = np.full(nc, 1500.0), np.full(nc, 1000.0)
    c[nc[0] // 2:], rho[nc[0] // 2:] = 1590.0, 1050.0
    return Material(sound_speed=c, density=rho, **extra)


def _kw(name, mesh):
    """The keyword arguments both packages' models take (the linear
    uniform one with a phased source: the cos / sin pair)."""
    kw = dict(material=_material(name, mesh.nc),
              source=Source(frequency=0.5e6, amplitude=60000.0),
              source_facets=mesh.boundary_facets("x-"),
              absorbing_facets=mesh.boundary_facets("x+"))
    if name == "linear_uniform":
        from fustpu_torch.models import sources
        kw["source_delays"] = lambda p: sources.focus_delays(
            p, (0.01, L / 2, L / 2), 1500.0)
    return kw


def _model(name, dtype=F64, device="cpu", mesh=None, **extra):
    mesh = _mesh() if mesh is None else mesh
    cls = (WesterveltModel if name.startswith("westervelt")
           else LinearWaveModel)
    return cls(mesh, dtype=dtype, device=device, **_kw(name, mesh), **extra)


def _state(model, seed=0):
    rng = np.random.default_rng(seed)
    g = model.mesh.grid_shape
    return model.init_state(2.0e-7, u0=rng.standard_normal(g),
                            v0=rng.standard_normal(g))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's models and timestepping; skips where JAX is
    missing."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fustpu import config as f_config
    from fustpu.mesh.box import BoxMesh
    from fustpu.models import timestepping as f_ts
    from fustpu.models.linear import LinearWaveModel as FLinear
    from fustpu.models.westervelt import WesterveltModel as FWest

    def model(name):
        mesh = _mesh()
        fmesh = BoxMesh(degree=mesh.degree, nc=mesh.nc, lo=mesh.lo,
                        hi=mesh.hi, vertex_coords=mesh.vertex_coords)
        kw = _kw(name, mesh)
        m = kw["material"]
        kw["material"] = f_config.Material(
            sound_speed=m.sound_speed, density=m.density,
            nonlinearity=m.nonlinearity, attenuation_dB=m.attenuation_dB)
        kw["source"] = f_config.Source(frequency=0.5e6, amplitude=60000.0)
        cls = FWest if name.startswith("westervelt") else FLinear
        return cls(fmesh, dtype=jnp.float64, **kw)

    return dict(jnp=jnp, ts=f_ts, model=model)


def _jax_run(ref, fmodel, state, dt, clamp, tf, probe):
    """The JAX package's make_solver on the port state's numbers."""
    jnp = ref["jnp"]
    fs = fmodel.init_state(state.t, u0=state.u.numpy(), v0=state.v.numpy())
    run = ref["ts"].make_solver(fmodel._rhs, STEPS, probe, clamp_tf=clamp)
    return run(fmodel.params, fmodel._flat_state(fs),
               jnp.asarray(dt, jnp.float64),
               jnp.asarray(tf if clamp else 0.0, jnp.float64))


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("clamp,probe", [(False, False), (True, True)])
def test_make_solver_matches_fustpu(ref, name, clamp, probe):
    """10 steps of make_solver's plain path (the same steps as the
    captured graphs, eager on the CPU) against the JAX package's
    make_solver: state and probe rows within 1e-11, the final time
    equal; with the clamp, tf falls inside step 8, so step 8 is clamped
    and steps 9 and 10 do nothing."""
    model = _model(name)
    fmodel = ref["model"](name)
    dt, _ = model.cfl_dt()
    s0 = model._flat_state(_state(model))
    tf = s0.t + 7.5 * dt
    idx = torch.as_tensor(PROBE)
    pr = (lambda s: s.u[idx]) if probe else None
    fpr = (lambda s: s.u[ref["jnp"].asarray(PROBE)]) if probe else None
    out, ys = ts.make_solver(model.stage_rhs, STEPS, pr, clamp_tf=clamp)(
        s0, dt, tf if clamp else None)
    fout, fys = _jax_run(ref, fmodel, s0, dt, clamp, tf, fpr)
    for a, b in zip(out[:4], fout[:4]):
        assert rel(a, b) <= TOL
    assert out.t == pytest.approx(float(fout.t), rel=1e-15)
    if clamp:
        assert out.t == pytest.approx(tf, rel=1e-15)
    if probe:
        assert ys.shape == (STEPS, len(PROBE))
        assert rel(ys, fys) <= TOL
    else:
        assert ys is None and fys is None


@pytest.mark.parametrize("clamp,probe", [(True, False), (False, True)])
def test_make_solver_matches_fustpu_one_of_each(ref, clamp, probe):
    """The clamp without a probe and a probe without the clamp, on the
    two-layer linear model: as `test_make_solver_matches_fustpu`."""
    test_make_solver_matches_fustpu(ref, "linear_two_layer", clamp, probe)


@pytest.mark.parametrize("dtype", [F64, torch.float32, BF16])
@pytest.mark.parametrize("name", ["linear_uniform", "westervelt_two_layer"])
def test_solve_matches_eager_solve(name, dtype):
    """`Model.solve` (make_solver's plain path on the CPU; `solve_eager`
    the same) against the port's eager loop of Python-float coefficients
    (`timestepping.solve`),
    clamped onto tf and probed: within 1e-11 in float64, and bitwise in
    every dtype (the host computes the same coefficients in the same
    expressions, the CPU applies them with the same torch.add; bfloat16
    in float32, rounded once)."""
    model = _model(name, dtype)
    dt, _ = model.cfl_dt()
    s0 = _state(model)
    tf = s0.t + 7.5 * dt
    idx = torch.as_tensor(PROBE)
    out, ys = model.solve(s0, dt, STEPS, tf=tf,
                          probe=lambda s: s.u.reshape(-1)[idx])
    old, yo = ts.solve(model._rhs, model._flat_state(s0), dt, STEPS, tf,
                       probe=lambda s: s.u[idx])
    eager, ye = model.solve_eager(s0, dt, STEPS, tf=tf,
                                  probe=lambda s: s.u.reshape(-1)[idx])
    assert torch.equal(eager.u, out.u) and torch.equal(ye, ys)
    assert out.t == old.t
    for a, b in zip(model._flat_state(out)[:4], old[:4]):
        if dtype == F64:
            assert rel(a, b) <= TOL
        assert torch.equal(a, b)
    assert torch.equal(ys, yo)


def test_solver_cache_key_matches_fustpu(ref):
    """`Model.solve` caches its solvers by the JAX package's key
    (num_steps, tf is not None, probe): the same calls leave the same
    keys in both packages' caches, and a repeated call reuses its
    solver."""
    name = "linear_two_layer"
    model, fmodel = _model(name), ref["model"](name)
    dt, _ = model.cfl_dt()
    s0 = _state(model)
    fs0 = fmodel.init_state(s0.t, u0=s0.u.numpy(), v0=s0.v.numpy())
    probe = lambda s: s.u.reshape(-1)[:3]
    calls = [dict(num_steps=3), dict(num_steps=3, tf=s0.t + dt),
             dict(num_steps=2, probe=probe), dict(num_steps=3)]
    for kw in calls:
        model.solve(s0, dt, **kw)
        fmodel.solve(fs0, dt, **kw)
    assert set(model._solvers) == set(fmodel._solver_cache) == {
        (3, False, None), (3, True, None), (2, False, probe)}
    first = model._solvers[(3, False, None)]
    model.solve(s0, dt, 3)
    assert model._solvers[(3, False, None)] is first


def test_coefficient_table_matches_fustpu_step_times(ref):
    """The table's step times and clamped dt are the JAX package's
    make_solver's: t = t0 + k dt, min(t, tf), dt = clip(tf - t, 0, dt)
    (its probe reads the time after each step, t + dt); b_i dt_k and
    a_i dt_k in columns 1 and 0, the source coefficients of each stage
    time after them, as the model computes them."""
    name = "westervelt_uniform"
    model, fmodel = _model(name), ref["model"](name)
    dt, _ = model.cfl_dt()
    t0 = 2.0e-7
    tf = t0 + 7.5 * dt
    table, t_end = ts.coefficient_table(model._source_coeffs, t0, dt,
                                        STEPS, tf)
    assert table.shape == (STEPS, 4, 2 + 4)
    s0 = model._flat_state(_state(model))
    _, fts = _jax_run(ref, fmodel, s0, dt, True, tf,
                      lambda s: s.t.reshape(1))
    fts = np.asarray(fts)[:, 0]
    times = ts.step_times(t0, dt, STEPS, tf)
    ends = np.array([t + h for t, h in times])
    assert np.array_equal(ends, fts) and t_end == fts[-1]
    steps = np.array([h for _, h in times])
    assert np.array_equal(steps[:7], np.full(7, dt))
    assert steps[7] == pytest.approx(0.5 * dt, rel=1e-9)
    assert np.array_equal(steps[8:], [0.0, 0.0])
    for i, (a, b, c) in enumerate(zip(RK4_A, RK4_B, RK4_C)):
        assert np.array_equal(table[:, i, 0], float(a) * steps)
        assert np.array_equal(table[:, i, 1], float(b) * steps)
        for k, (t, h) in enumerate(times):
            assert tuple(table[k, i, 2:]) == model._source_coeffs(
                t + float(c) * h)


def test_cpu_bf16_update_rounds_once():
    """The table-driven update on bfloat16 fields on the CPU: float32
    arithmetic, rounded to bfloat16 once, the same for an element
    wherever it lies in the tensor (PyTorch's CPU add of bf16 tensors
    would round alpha to bf16 in its vector body only).  With a
    bf16-exact coefficient and bf16 inputs the float32 result is exact,
    so the expected value is the exact one rounded once."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal(1003)).to(BF16)
    y = torch.as_tensor(rng.standard_normal(1003)).to(BF16)
    a = torch.tensor(0.3125 + 2.0 ** -7, dtype=torch.float32)
    want = (y.double() + float(a) * x.double()).to(BF16)
    for got in (vec.axpy(a, x, y), vec.axpy_(a, x, y.clone()),
                cv.axpy(a, x, y)):
        assert got.dtype == BF16 and torch.equal(got, want)
    # one element alone gives the same bits as in the tensor
    for i in (0, 17, 1002):
        assert torch.equal(vec.axpy(a, x[i:i + 1], y[i:i + 1]), want[i:i + 1])
    # an update in bf16 arithmetic (alpha rounded, the product rounded)
    # would differ
    bf = y + (a.to(BF16) * x)
    assert not torch.equal(bf, want)


def test_attribute_change_drops_the_solvers():
    """A solver holds the model's modules and buffers as captured:
    assigning any attribute of the model (here its stiffness module) or
    moving it drops them; solving again makes new ones."""
    model = _model("linear_uniform")
    dt, _ = model.cfl_dt()
    s0 = _state(model)
    model.solve(s0, dt, 2)
    assert (2, False, None) in model._solvers
    model.stiffness = model.stiffness
    assert "_solvers" not in model.__dict__
    model.solve(s0, dt, 2)
    model.to(F64)
    assert "_solvers" not in model.__dict__


def test_pickled_model_leaves_its_solvers():
    """A model sent to a spawned rank (pickled) leaves its solvers behind
    (their graphs and closures belong to the process that made them) and
    solves the same steps there."""
    import pickle

    model = _model("linear_two_layer")
    dt, _ = model.cfl_dt()
    s0 = _state(model)
    a, _ = model.solve(s0, dt, 2, probe=lambda s: s.u.reshape(-1)[:3])
    copy = pickle.loads(pickle.dumps(model))
    assert "_solvers" in model.__dict__ and "_solvers" not in copy.__dict__
    b, _ = copy.solve(s0, dt, 2)
    assert torch.equal(a.u, b.u) and torch.equal(a.v, b.v)


def test_sharded_rank_parts_solve_eagerly():
    """A sharded model's rank part (`parallel.models.local_model`) sets
    `capture` False: its exchange cannot be captured, so it solves with
    the eager loop, as the JAX package's sharded models do without
    make_solver; on one rank that is the one-rank model's trajectory."""
    model = _model("westervelt_two_layer")
    local = local_model(model, model.mesh, model.stiffness,
                        host_vectors(model), "cpu")
    assert model.capture and not local.capture
    dt, _ = model.cfl_dt()
    s0 = _state(model)
    a, _ = model.solve(s0, dt, 3)
    b, _ = local.solve(s0, dt, 3)
    assert "_solvers" not in local.__dict__
    assert torch.equal(a.u, b.u) and torch.equal(a.v, b.v)


# ---------------------------------------------------------------------------
# The RK4 update kernel's host side (no card needed)
# ---------------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that the wrapper takes for one on card 0, so that its
    checks and launch arguments run here; `launch.launch` is replaced, so
    nothing launches."""

    is_cpu = False
    is_cuda = True
    device = torch.device("cuda", 0)

    def get_device(self):
        return 0


@pytest.fixture
def no_card_launch(monkeypatch):
    calls = []
    monkeypatch.setattr(launch, "launch",
                        lambda name, dev, *args: calls.append(
                            (name, dev, args)))
    return calls


@pytest.mark.parametrize("dtype,per", [(torch.float32, 4), (F64, 2),
                                       (BF16, 8)])
def test_axpy_launch_arguments(no_card_launch, dtype, per):
    """On a card `cuda_vector.axpy` launches its dtype's entry point with
    x, y, the coefficient's and the output's addresses, the size, the 16 B
    flag and a grid that covers the values (UNROLL packs a thread, of 16 B
    where all three arrays are 16 B-aligned, else of one value), counted
    once; in place the output is y."""
    cv.reset_launches()
    n = 1003
    x = torch.zeros(n, dtype=dtype).as_subclass(_OnCard)
    y = torch.zeros(n, dtype=dtype).as_subclass(_OnCard)
    a = torch.zeros((), dtype=cv.coefficient_dtype(dtype)).as_subclass(
        _OnCard)
    out = cv.axpy(a, x, y)
    cv.axpy(a, x, y, out=y)
    shifted = torch.zeros(n + 1, dtype=dtype)[1:].as_subclass(_OnCard)
    cv.axpy(a, x, shifted, out=shifted)
    (n0, _, a0), (n1, _, a1), (_, _, a2) = no_card_launch
    suffix = {torch.float32: "f32", F64: "f64", BF16: "bf16"}[dtype]
    assert n0 == n1 == f"fustpu_axpy_{suffix}"
    span = cv.THREADS * cv.UNROLL
    assert a0 == (x.data_ptr(), y.data_ptr(), a.data_ptr(), out.data_ptr(),
                  n, 1, -(-(n // per) // span))
    assert a1[3] == y.data_ptr()
    assert a2[5:] == (0, -(-n // span))
    counts = cv.bf16_launches["axpy_bf16"] if dtype == BF16 else \
        cv.launches["axpy"]
    assert counts == 3


def test_axpy_refuses_before_any_launch(no_card_launch):
    """A coefficient of the wrong type, size or device, fields of another
    dtype or shape, a non-contiguous field or a dtype the kernel does not
    take raise before any launch."""
    x = torch.zeros(8).as_subclass(_OnCard)
    a = torch.zeros(()).as_subclass(_OnCard)
    cases = [
        (lambda: cv.axpy(torch.zeros((), dtype=F64).as_subclass(_OnCard),
                         x, x), "alpha is torch.float64"),
        (lambda: cv.axpy(torch.zeros(2).as_subclass(_OnCard), x, x),
         "alpha is"),
        (lambda: cv.axpy(torch.zeros(()), x, x), "alpha is"),
        (lambda: cv.axpy(a, x.double(), x), "x is torch.float64"),
        (lambda: cv.axpy(a, x[:4], x), "x has shape"),
        (lambda: cv.axpy(a, torch.zeros(16).as_subclass(_OnCard)[::2], x),
         "contiguous"),
        (lambda: cv.axpy(a, x.half(), x.half()), "unsupported")]
    for fn, match in cases:
        with pytest.raises(ValueError, match=match):
            fn()
    assert no_card_launch == []


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")


def _engine_model(dtype, device):
    """A two-layer Westervelt model on the staged engine: the box as a
    shuffled general mesh, P = 3, the source on x = 0, absorbing
    elsewhere."""
    mesh = from_box(_mesh((4, 3, 3), 3), shuffle_seed=3)
    ext = mesh.boundary_facets()
    on_x0 = mesh.facet_centroids(ext)[:, 0] < 1e-9
    x = mesh.cell_corners_flat.mean(axis=1)[:, 0]
    mat = Material(sound_speed=np.where(x < L / 2, 1500.0, 1590.0),
                   density=np.where(x < L / 2, 1000.0, 1050.0),
                   nonlinearity=100.0, attenuation_dB=50.0)
    return WesterveltModel(mesh, mat, Source(frequency=0.5e6,
                                             amplitude=60000.0),
                           ext[on_x0], ext[~on_x0], dtype=dtype,
                           device=device, stiffness_impl="indexed_engine")


def _replay_vs_eager(model, steps=STEPS, chunk=4):
    """`steps` steps replayed (graphs of `chunk` steps and a remainder)
    and the same steps eager, clamped onto tf and probed, from the same
    state; returns (replayed, eager, ys, eager ys, the counters' moves in
    the replay, those in the eager run)."""
    dt, _ = model.cfl_dt()
    s0 = _state(model)
    flat = model._flat_state(s0)
    tf = s0.t + (steps - 1.5) * dt
    solver = ts.make_solver(model.stage_rhs, steps,
                            lambda s: s.u[:5].float(), clamp_tf=True,
                            chunk=chunk)
    solver(flat, dt, tf)                 # capture
    before = [dict(d) for d in launch.counter_dicts()]
    out, ys = solver(flat, dt, tf)
    mid = [dict(d) for d in launch.counter_dicts()]
    eout, eys = solver.eager(flat, dt, tf)
    after = [dict(d) for d in launch.counter_dicts()]
    torch.cuda.synchronize()
    moved = lambda a, b: {k: n - a_[k] for a_, b_ in zip(a, b)
                          for k, n in b_.items() if n != a_[k]}
    return out, eout, ys, eys, moved(before, mid), moved(mid, after)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["linear_f32", "westervelt_pair_f32",
                                  "westervelt_engine_bf16"])
def test_replay_matches_eager_on_card(case):
    """10 replayed steps (two graphs of 4 steps, one of 2) bitwise equal
    to the same steps launched eagerly, state and probe rows, on the
    G-stream kernels (#1, #2 with the Westervelt pair) in float32 and the
    bf16 staged engine on a general mesh; a replay moves the launch
    counters as the eager run does."""
    _card()
    if case == "westervelt_engine_bf16":
        model = _engine_model(BF16, "cuda")
    else:
        name = ("linear_two_layer" if case == "linear_f32"
                else "westervelt_two_layer")
        model = _model(name, torch.float32, "cuda")
    out, eout, ys, eys, moved, emoved = _replay_vs_eager(model)
    for a, b in zip(out[:4], eout[:4]):
        assert torch.equal(a, b)
    assert out.t == eout.t and torch.equal(ys, eys)
    assert moved == emoved and moved
    assert all(n % STEPS == 0 for n in moved.values())


@pytest.mark.cuda
def test_capture_that_cannot_run_raises_on_card():
    """A right-hand side that reads a value on the host cannot be
    captured: the solve raises, it does not fall back to eager
    launches, and the counters stay as they were."""
    _card()
    model = _model("linear_two_layer", torch.float32, "cuda")
    dt, _ = model.cfl_dt()
    flat = model._flat_state(_state(model))

    def apply(c, u, v):
        float(v.sum())
        return model._rhs_stage(c, u, v)

    before = [dict(d) for d in launch.counter_dicts()]
    solver = ts.make_solver(ts.StageRHS(model._source_coeffs, apply), 3)
    with pytest.raises(Exception):
        solver(flat, dt)
    assert [dict(d) for d in launch.counter_dicts()] == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, F64, BF16])
def test_axpy_matches_torch_add_on_card(dtype):
    """The update kernel bitwise equal to PyTorch's add with a Python
    float on the card (its vector body and its tail, aligned and not),
    and to the plain version."""
    _card()
    rng = np.random.default_rng(1)
    for n in (1, 7, 1003, 100_003):
        x = torch.as_tensor(rng.standard_normal(n + 1), device="cuda").to(
            dtype)
        y = torch.as_tensor(rng.standard_normal(n + 1), device="cuda").to(
            dtype)
        alpha = float(rng.standard_normal())
        a = torch.tensor(alpha, device="cuda",
                         dtype=cv.coefficient_dtype(dtype))
        for xs, ys_ in ((x[:n], y[:n]), (x[1:], y[1:])):
            want = torch.add(ys_, xs, alpha=float(a))
            assert torch.equal(cv.axpy(a, xs, ys_), want)
            assert torch.equal(cv.axpy_plain(a, xs, ys_), want)
            z = ys_.clone()
            cv.axpy(a, xs, z, out=z)
            assert torch.equal(z, want)
