"""bfloat16 on the port's staged gather / contract / scatter engine (the
JAX package's ``--dtype bf16`` with ``stiffness_impl="indexed_engine"``):
on the CPU, the plain `gather`, `gather2`, `dense_contract` and
`scatter_add` and their wrappers on bf16 data against
``fustpu.ops.pallas_gather``'s Pallas kernels in interpret mode (on a plan
from its `build_plan`), the composed apply and pair against
``operators.stiffness_apply_indexed`` with ``engine=``, and the port's bf16
engine models at P = 5 against the JAX package's bf16 engine models (its
fused engine declines above P = 4, so they run the staged one); the
conversion of its parameters, a checkpoint restart and the wrappers'
launch arguments and checks; and, on a card, the four bf16 engine kernels
against their plain versions.

The JAX package is imported inside the `ref` fixture, so that the card
tests also run on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_bf16_engine.py -m cuda

What the tolerances allow (as in ``tests/test_torch_bf16.py``): a bf16
stiffness apply of either package is within ~5e-3 of float64 on the same
bf16 inputs, so two of them differ by at most 1e-2 (APPLY_TOL).  The port
computes in float32 and rounds where its kernels store (y2, then y); the
JAX package's contraction and scatter keep bfloat16 results and its
scatter accumulates in bfloat16.  Its models carry their time in
bfloat16, which quantises the source once a step runs: the step is taken
with the source off, and the trajectory is held at TRAJ_TOL.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fustpu_torch import convert
from fustpu_torch.config import Material, Source
from fustpu_torch.mesh import msh_io, shapes
from fustpu_torch.mesh import unstructured as un
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.models import discretization as dz
from fustpu_torch.models.linear import LinearWaveModel
from fustpu_torch.models.westervelt import WesterveltModel
from fustpu_torch.ops import cuda_engine as cen
from fustpu_torch.ops import cuda_indexed as ci
from fustpu_torch.ops import engine as eng
from fustpu_torch.ops import launch
from fustpu_torch.utils import io as fio

torch.set_num_threads(1)

BF16 = torch.bfloat16
F64 = torch.float64
# one bf16 apply of the port against one of the JAX package, or against
# float64 on the same bf16 inputs (see above)
APPLY_TOL = 1e-2
# a bf16 kernel against its plain version on the same bf16 inputs, on the
# card: both round y2 and y where they store them, in another order of
# float32 sums
CARD_TOL = 2.0 ** -7
# 5 steps against the JAX package's bf16 engine model, the source on: its
# bf16 time and per-op roundings part the two (tests/test_torch_bf16.py's
# trajectory gate)
TRAJ_TOL = 0.2
STEPS = 5
CYL = dict(radius=0.012, length=0.02, piston_radius=0.008, m=3, mr=1,
           nr_ann=1)


def rel(a, b):
    f = lambda t: (t.double().numpy() if isinstance(t, torch.Tensor)
                   else np.asarray(t).astype(np.float64))
    a, b = f(a).reshape(-1), f(b).reshape(-1)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules; skips where JAX is missing."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from fustpu import config as f_config
    from fustpu.mesh import box as f_box
    from fustpu.mesh import unstructured as f_un
    from fustpu.models.linear import LinearWaveModel as FLinear
    from fustpu.models.westervelt import WesterveltModel as FWest
    from fustpu.ops import operators as f_ops
    from fustpu.ops import pallas_gather as pg

    return SimpleNamespace(jax=jax, jnp=jnp, config=f_config, box=f_box,
                           un=f_un, FLinear=FLinear, FWest=FWest, ops=f_ops,
                           pg=pg)


def _box(ref, P, nc=(3, 2, 4)):
    """(port mesh, JAX package mesh): a perturbed box as a shuffled general
    mesh (``tests/test_torch_engine.py``'s)."""
    um = un.from_box(build_box_mesh(nc, P, perturb=0.2, seed=3),
                     shuffle_seed=11)
    fum = ref.un.from_box(ref.box.build_box_mesh(nc, P, perturb=0.2, seed=3),
                          shuffle_seed=11)
    assert np.array_equal(um.dofmap, fum.dofmap)
    return um, fum


def _bf16(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64)).to(BF16)


def _j(ref, t: torch.Tensor):
    """A bf16 tensor as a JAX bf16 array of the same values (exact through
    float32)."""
    return ref.jnp.asarray(t.float().numpy(), ref.jnp.bfloat16)


def _case(ref, P, seed):
    """The box at degree P, its engine plan, the bf16 operators (unit,
    per-cell coefficient, pair) and bf16 fields and coefficients."""
    mesh, fmesh = _box(ref, P)
    rng = np.random.default_rng(seed)
    disc = dz.Discretization(mesh)
    c1 = rng.uniform(0.5, 2.0, mesh.num_cells)
    c2 = rng.uniform(-1.5, -0.5, mesh.num_cells)
    op = lambda **kw: disc.stiffness_op(BF16, "cpu", engine=True, **kw)
    return SimpleNamespace(
        mesh=mesh, fmesh=fmesh, disc=disc,
        plan=ref.pg.build_plan(mesh.dofmap.ravel(), mesh.ndofs),
        op=op(), cop=op(coeff=c1), pop=op(pair=(c1, c2)),
        x1=_bf16(rng.standard_normal(mesh.ndofs)),
        x2=_bf16(rng.standard_normal(mesh.ndofs)),
        g=torch.as_tensor(mesh.dofmap.reshape(-1).astype(np.int64)))


@pytest.mark.parametrize("P", [2, 3, 5])
def test_plain_bf16_functions_match_pallas_interpret(ref, P):
    """Each plain bf16 engine function (and its wrapper on CPU tensors)
    against the Pallas kernel in interpret mode on the same bf16 inputs:
    the gathers bitwise, the contraction (unit and per-cell coefficient)
    and the scatter within APPLY_TOL, and each within APPLY_TOL of float64
    on the same bf16 inputs."""
    pg = ref.pg
    k = _case(ref, P, seed=P)
    j = lambda t: _j(ref, t)
    want = np.asarray(pg.gather(j(k.x1), k.plan, interpret=True))
    got = eng.gather(k.x1, k.g)
    assert got.dtype == BF16
    assert np.array_equal(got.float().numpy(), want.astype(np.float32))
    assert torch.equal(cen.gather(k.op, k.x1).reshape(-1), got)
    w1, w2 = pg.gather2(j(k.x1), j(k.x2), k.plan, interpret=True)
    u1, u2 = eng.gather2(k.x1, k.x2, k.g)
    v1, v2 = cen.gather2(k.pop, k.x1, k.x2)
    for a, b, c in ((u1, w1, v1), (u2, w2, v2)):
        assert a.dtype == BF16 and torch.equal(c.reshape(-1), a)
        assert np.array_equal(a.float().numpy(),
                              np.asarray(b).astype(np.float32))
    cells = k.mesh.num_cells
    u = got.reshape(cells, -1)
    for op in (k.op, k.cop):
        p = cen.to_plain(op)
        y = pg.dense_contract(j(u), j(p.G6), j(p.D), interpret=True,
                              coeff=None if p.coeff is None else j(p.coeff))
        mine = eng.dense_contract(u, p.G6, p.D, p.coeff)
        exact = eng.dense_contract(u.double(), p.G6.double(), p.D.double(),
                                   None if p.coeff is None
                                   else p.coeff.double())
        assert mine.dtype == BF16
        assert torch.equal(cen.contract(op, u), mine)
        assert rel(mine, np.asarray(y)) <= APPLY_TOL
        assert rel(mine, exact) <= APPLY_TOL
        assert rel(np.asarray(y), exact) <= APPLY_TOL
    v = _bf16(np.random.default_rng(P).standard_normal(u.numel()))
    want = pg.scatter_add(j(v), k.plan, k.mesh.ndofs, interpret=True)
    mine = eng.scatter_add(v, k.g, k.mesh.ndofs)
    exact = eng.scatter_add(v.double(), k.g, k.mesh.ndofs)
    assert mine.dtype == BF16
    assert torch.equal(cen.scatter(k.op, v.reshape(cells, -1)), mine)
    assert rel(mine, np.asarray(want)) <= APPLY_TOL
    assert rel(mine, exact) <= APPLY_TOL
    assert rel(np.asarray(want), exact) <= APPLY_TOL
    assert not any(cen.launches.values())
    assert not any(cen.bf16_launches.values())


@pytest.mark.parametrize("P", [2, 3, 5])
def test_composed_bf16_apply_matches_operators(ref, P):
    """The composed bf16 engine apply (unit, per-cell coefficient) and pair
    against the JAX package's indexed path on its engine plan (interpret
    mode) in bf16 <= APPLY_TOL, each within APPLY_TOL of float64 on the
    same bf16 data, and EngineStiffness's plain module bitwise the
    wrappers'."""
    ops = ref.ops
    k = _case(ref, P, seed=10 + P)
    j = lambda t: _j(ref, t)
    nd = k.mesh.ndofs
    kw = dict(engine=k.plan, engine_interpret=True)
    dm = ref.jnp.asarray(k.mesh.dofmap)
    for op in (k.op, k.cop):
        p = cen.to_plain(op)
        want = ops.stiffness_apply_indexed(
            j(k.x1), j(p.G6), None if p.coeff is None else j(p.coeff), dm,
            j(p.D), nd, **kw)
        got = cen.engine(op, k.x1)
        exact = eng.stiffness_apply_engine(
            k.x1.double(), p.G6.double(), None if p.coeff is None
            else p.coeff.double(), p.g, p.D.double(), nd)
        assert got.dtype == BF16
        assert torch.equal(dz.EngineStiffness(op, "mm")(k.x1), got)
        assert rel(got, np.asarray(want)) <= APPLY_TOL
        assert rel(got, exact) <= APPLY_TOL
    p = cen.to_plain(k.pop)
    want = ops.stiffness_apply_indexed_pair(
        j(k.x1), j(p.c1), j(k.x2), j(p.c2), j(p.G6), dm, j(p.D), nd, **kw)
    got = cen.engine_pair(k.pop, k.x1, k.x2)
    exact = eng.stiffness_apply_engine_pair(
        k.x1.double(), p.c1.double(), k.x2.double(), p.c2.double(),
        p.G6.double(), p.g, p.D.double(), nd)
    assert got.dtype == BF16
    assert torch.equal(dz.EngineStiffness(k.pop, "mm").pair(k.x1, k.x2), got)
    assert rel(got, np.asarray(want)) <= APPLY_TOL
    assert rel(got, exact) <= APPLY_TOL
    assert not any(cen.bf16_launches.values())


def test_plain_bf16_stores_where_its_kernel_stores(ref):
    """Each plain bf16 function stores where its kernel does: the gathers
    copy bf16 values; the contraction is the float32 contraction of the
    widened inputs rounded once to bf16; the pair fold is float32;
    the scatter is the float32 sum of the widened y2 rounded once to bf16;
    the composed applies are these in turn, and differ from one rounding
    of the float32 apply (``spectral_mm.rounds_once``) by the rounding of
    y2 alone."""
    k = _case(ref, 3, seed=7)
    cells = k.mesh.num_cells
    u = eng.gather(k.x1, k.g)
    assert u.dtype == BF16 and torch.equal(u.float(), k.x1.float()[k.g])
    u = u.reshape(cells, -1)
    for op in (k.op, k.cop):
        p = cen.to_plain(op)
        f32 = eng.dense_contract(u.float(), p.G6.float(), p.D.float(),
                                 None if p.coeff is None
                                 else p.coeff.float())
        y2 = eng.dense_contract(u, p.G6, p.D, p.coeff)
        assert f32.dtype == torch.float32
        assert torch.equal(y2, f32.to(BF16))
        y = eng.scatter_add(y2, k.g, k.mesh.ndofs)
        sum32 = torch.zeros(k.mesh.ndofs).index_add_(0, k.g,
                                                     y2.float().reshape(-1))
        assert y.dtype == BF16 and torch.equal(y, sum32.to(BF16))
        assert torch.equal(cen.engine(op, k.x1), y)
        once = eng.scatter_add(f32, k.g, k.mesh.ndofs).to(BF16)
        assert rel(y, once) <= APPLY_TOL
    p = cen.to_plain(k.pop)
    u1, u2 = eng.gather2(k.x1, k.x2, k.g)
    uf = eng.fold(u1.reshape(cells, -1), p.c1, u2.reshape(cells, -1), p.c2)
    assert uf.dtype == torch.float32
    assert torch.equal(uf, p.c1.float()[:, None] * u1.float().reshape(
        cells, -1) + p.c2.float()[:, None] * u2.float().reshape(cells, -1))
    y = eng.scatter_add(eng.dense_contract(uf, p.G6, p.D), k.g,
                        k.mesh.ndofs)
    assert torch.equal(cen.engine_pair(k.pop, k.x1, k.x2), y)


def test_engine_resolves_bf16_and_builds_bf16_buffers(tmp_path):
    """'indexed_engine' resolves bf16 as it resolves float32 on the CPU and
    on the card, and a bf16 model on it (a general and a prismatic import)
    builds an EngineStiffness with bf16 G, D, coeff or C, named for its
    bf16 counters."""
    v, c, t = shapes.cylinder_mesh(nz=3, **CYL)
    path = msh_io.write_msh(str(tmp_path / "c"), v, c, t)
    for extrusion in (False, True):
        mesh = msh_io.read_msh(path, 2, detect_extrusion=extrusion)
        for device in ("cpu", "cuda"):
            assert dz.resolve_stiffness_impl(
                "indexed_engine", device, mesh, BF16) == \
                dz.resolve_stiffness_impl("indexed_engine", device, mesh,
                                          torch.float32)
        zc = mesh.cell_corners_flat.mean(axis=1)[:, 2]
        two = Material(sound_speed=np.where(zc < 0.01, 1500.0, 1650.0),
                       density=np.where(zc < 0.01, 1000.0, 1050.0))
        for cls in (LinearWaveModel, WesterveltModel):
            model = cls(mesh, two, Source(frequency=0.5e6, amplitude=1e5),
                        mesh.boundary_facets(1), mesh.boundary_facets(2),
                        dtype=BF16, device="cpu",
                        stiffness_impl="indexed_engine")
            st = model.stiffness
            assert isinstance(st, dz.EngineStiffness) and st.impl == "mm"
            extra = st.plain_coeff if cls is LinearWaveModel else st.plain_c1
            for buf in (st.plain_G6, st.plain_D, extra):
                assert buf.dtype == BF16
            op = model.disc.stiffness_op(BF16, "cpu", engine=True)
            card = dz.EngineStiffness(op, "cuda")
            assert card.kernel == "engine_bf16"
            assert card.kernels == ("engine_gather_bf16",
                                    "engine_contract_bf16",
                                    "engine_scatter_bf16")
            assert set(card.kernels) <= set(dz.launch_counts())


# ---------------------------------------------------------------------------
# Models at P = 5 against the JAX package's bf16 staged engine
# ---------------------------------------------------------------------------

MODELS = ["linear_two_layer", "westervelt_uniform", "westervelt_two_layer"]
_REFERENCES = {}


def _material(name, mesh):
    west = name.startswith("westervelt")
    kw = dict(nonlinearity=100.0, attenuation_dB=50.0) if west else {}
    if name.endswith("two_layer"):
        x = mesh.cell_corners_flat.mean(axis=1)[:, 0]
        kw.update(sound_speed=np.where(x < 0.5, 1500.0, 1650.0),
                  density=np.where(x < 0.5, 1000.0, 1050.0))
    else:
        kw.update(sound_speed=1500.0, density=1000.0)
    return Material(**kw)


def _facets(mesh):
    ext = mesh.boundary_facets()
    centre = mesh.facet_centroids(ext)
    return ext[centre[:, 0] < 1e-9], ext[centre[:, 0] >= 1e-9]


def _port_class(name):
    return WesterveltModel if name.startswith("westervelt") \
        else LinearWaveModel


def _reference(ref, name, amplitude=1e5):
    """The JAX package's bf16 'indexed_engine' model at P = 5 on the 2^3
    box (the staged engine in interpret mode), the port's bf16 engine
    model of the same problem, and the JAX model's dt (cached)."""
    key = (name, amplitude)
    if key not in _REFERENCES:
        jnp = ref.jnp
        mesh, fmesh = _box(ref, 5, nc=(2, 2, 2))
        mat = _material(name, mesh)
        fmat = ref.config.Material(
            sound_speed=mat.sound_speed, density=mat.density,
            nonlinearity=mat.nonlinearity, attenuation_dB=mat.attenuation_dB)
        src = Source(frequency=0.5e6, amplitude=amplitude)
        fsrc = ref.config.Source(frequency=0.5e6, amplitude=amplitude)
        fcls = ref.FWest if name.startswith("westervelt") else ref.FLinear
        sf, af = _facets(fmesh)
        fmodel = fcls(fmesh, fmat, fsrc, sf, af, dtype=jnp.bfloat16,
                      stiffness_impl="indexed_engine")
        assert fmodel._idx_engine is not None and fmodel._idx_fused is None
        model = _port_class(name)(mesh, mat, src, sf, af, dtype=BF16,
                                  device="cpu",
                                  stiffness_impl="indexed_engine")
        _REFERENCES[key] = SimpleNamespace(
            mesh=mesh, mat=mat, src=src, fmodel=fmodel, model=model,
            dt=float(fmodel.cfl_dt()[0]))
    return _REFERENCES[key]


def _initial(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n), rng.standard_normal(n)


@pytest.mark.parametrize("name", MODELS)
def test_bf16_engine_model_matches_fustpu(ref, name):
    """The port's bf16 engine model (COEFF for the two-layer linear model,
    PLAIN for uniform Westervelt, PAIR for two-layer Westervelt) against
    the JAX package's bf16 engine model: the RHS at times given as floats
    <= APPLY_TOL; one RK4 step with the source off <= APPLY_TOL; STEPS
    steps with the source on <= TRAJ_TOL, the field finite and bf16."""
    jnp = ref.jnp
    r = _reference(ref, name)
    model = r.model
    assert isinstance(model.stiffness, dz.EngineStiffness)
    assert model.stiffness.is_pair == (name == "westervelt_two_layer")
    assert (model.stiffness.plain_coeff is not None) == \
        (name == "linear_two_layer")
    u, v = _initial(r.mesh.ndofs, 1)
    for t in (1.3e-7, 9.5e-6):
        want = r.fmodel.rhs(t, jnp.asarray(u, jnp.bfloat16),
                            jnp.asarray(v, jnp.bfloat16))
        got = model.rhs(t, _bf16(u), _bf16(v))
        assert got.dtype == BF16
        assert rel(got, np.asarray(want)) <= APPLY_TOL
    r0 = _reference(ref, name, 0.0)
    s = r0.model.step(r0.model.init_state(0.0, u0=u, v0=v), r0.dt)
    fs = r0.fmodel.step(r0.fmodel.init_state(0.0, u0=u, v0=v), r0.dt)
    for a, b in zip(s[:2], fs[:2]):
        assert a.dtype == BF16 and rel(a, np.asarray(b)) <= APPLY_TOL
    out, _ = model.solve(model.init_state(0.0, u0=u, v0=v), r.dt, STEPS)
    fout, _ = r.fmodel.solve(r.fmodel.init_state(0.0, u0=u, v0=v), r.dt,
                             STEPS)
    assert out.u.dtype == BF16 and bool(torch.isfinite(out.u).all())
    assert rel(out.u, np.asarray(fout.u)) <= TRAJ_TOL
    assert rel(out.v, np.asarray(fout.v)) <= TRAJ_TOL


@pytest.mark.parametrize("name", ["linear_two_layer",
                                  "westervelt_two_layer"])
def test_convert_bf16_engine_params_bitwise(ref, name):
    """`convert.model_from_fustpu` on the JAX bf16 engine model's params
    (G, dofmap and D as bf16 arrays, the per-cell c2_c or c3_c / c4_c):
    the port's bf16 engine operator holds the same numbers bit for bit,
    and its RHS is within APPLY_TOL of the JAX model's."""
    jnp = ref.jnp
    r = _reference(ref, name)
    p = r.fmodel.params
    a = np.asarray
    params = {k: a(v) for k, v in p.items() if k != "stiff"}
    G, dm, D = p["stiff"]
    params["stiff"] = dict(G=a(G), dofmap=a(dm), D=a(D))
    assert str(params["stiff"]["G"].dtype) == "bfloat16"
    model, _ = convert.model_from_fustpu(
        _port_class(name), params, mesh=r.mesh, material=r.mat,
        source=r.src, source_facets=_facets(r.mesh)[0], dtype=BF16,
        device="cpu", stiffness_impl="indexed_engine")
    st = model.stiffness
    assert isinstance(st, dz.EngineStiffness)
    same = lambda t, arr: np.array_equal(t.double().numpy(),
                                         np.asarray(arr).astype(np.float64))
    assert same(st.plain_G6, G) and same(st.plain_D, D)
    assert np.array_equal(st.plain_g.numpy(), a(dm).reshape(-1))
    if name == "linear_two_layer":
        assert same(st.plain_coeff, p["c2_c"])
    else:
        assert same(st.plain_c1, p["c3_c"]) and same(st.plain_c2, p["c4_c"])
    u, v = _initial(r.mesh.ndofs, 2)
    want = r.fmodel.rhs(2.0e-6, jnp.asarray(u, jnp.bfloat16),
                        jnp.asarray(v, jnp.bfloat16))
    assert rel(model.rhs(2.0e-6, _bf16(u), _bf16(v)),
               np.asarray(want)) <= APPLY_TOL


def test_bf16_engine_checkpoint_restart_is_bitwise(ref, tmp_path):
    """A bf16 engine model's state through `save_checkpoint` and
    `state_from_checkpoint`: bitwise, and 3 + 3 steps through the file
    equal 6."""
    r = _reference(ref, "westervelt_two_layer")
    model = r.model
    s3, _ = model.solve(model.init_state(0.0, *_initial(r.mesh.ndofs, 3)),
                        r.dt, 3)
    path = fio.save_checkpoint(str(tmp_path / "ck"), s3, 3)
    arrays, step, _ = fio.load_checkpoint(path)
    back = fio.state_from_checkpoint(model, arrays)
    assert step == 3 and back.t == s3.t
    for a, b in zip(back[:4], s3[:4]):
        assert a.dtype == BF16 and torch.equal(a, b)
    s6, _ = model.solve(s3, r.dt, 3)
    r6, _ = model.solve(back, r.dt, 3)
    assert all(torch.equal(a, b) for a, b in zip(s6[:4], r6[:4]))


# ---------------------------------------------------------------------------
# The bf16 wrappers' host side: launch arguments and checks (no card: a CPU
# tensor subclass stands in for a card tensor and `launch.launch` records
# its calls; the gather's grid, the same in every dtype, is
# tests/test_torch_engine.py's test_gather_grid_covers_every_position_once)
# ---------------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that the wrappers take for one on card 0."""

    is_cpu = False
    is_cuda = True
    device = torch.device("cuda", 0)

    def get_device(self):
        return 0


def _on_card(op):
    return op._replace(**{k: v.as_subclass(_OnCard)
                          for k, v in op._asdict().items()
                          if isinstance(v, torch.Tensor)})


@pytest.fixture
def no_card_launch(monkeypatch):
    """`launch.launch` recording its calls, and 132 SMs."""
    calls = []
    monkeypatch.setattr(launch, "launch",
                        lambda name, dev, *args: calls.append(
                            (name, dev, args)))
    monkeypatch.setattr(launch, "sm_count", lambda dev: 132)
    return calls


def _small(dtype=BF16, pair=False, cells=5, n=3, ndofs=400):
    """An engine operator of `cells` random overlapping cells (degree
    n - 1) in `dtype`, and a field."""
    rng = np.random.default_rng(2)
    n3 = n ** 3
    dm = np.stack([min(c * 28, ndofs - n3 - 1) + rng.permutation(n3)
                   for c in range(cells)])
    mesh = SimpleNamespace(dofmap=dm, ndofs=ndofs, num_cells=cells)
    kw = dict(pair=(rng.uniform(0.5, 2, cells), rng.uniform(-2, -1, cells))
              ) if pair else {}
    op = cen.build(mesh, rng.standard_normal((cells, n3, 6)),
                   rng.standard_normal((n, n)), dtype, "cpu", **kw)
    x = torch.as_tensor(rng.standard_normal(ndofs)).to(dtype)
    return op, x


def test_bf16_launch_arguments(no_card_launch):
    """On a card each bf16 wrapper launches its bf16 entry point with the
    float32 kernels' arguments (the gather on its one-wave grid), counted
    in `bf16_launches` only: u2, y2 and y in bf16."""
    cen.reset_launches()
    op, x = _small(pair=True)
    op, x = _on_card(op), x.as_subclass(_OnCard)
    u = cen.gather(op, x)
    u1, u2 = cen.gather2(op, x, x)
    y2 = cen.contract(op, u1.as_subclass(_OnCard), u2.as_subclass(_OnCard))
    y = cen.scatter(op, y2.as_subclass(_OnCard))
    assert (u.dtype, u1.dtype, y2.dtype, y.dtype) == (BF16,) * 4
    names = [c[0] for c in no_card_launch]
    assert names == ["fustpu_engine_gather_bf16",
                     "fustpu_engine_gather2_bf16",
                     "fustpu_engine_contract_bf16",
                     "fustpu_engine_scatter_bf16"]
    n = op.dofmap.numel()
    assert no_card_launch[0][2] == (x.data_ptr(), op.dofmap.data_ptr(),
                                    u.data_ptr(), n,
                                    launch.gather_blocks(n, 132))
    assert no_card_launch[2][2][-3:] == (op.dofmap.shape[0], 2, 2)
    assert not any(cen.launches.values())
    assert all(v == 1 for v in cen.bf16_launches.values())


def test_bf16_wrappers_refuse_before_any_launch(no_card_launch):
    """Wrong dtypes (a float32 field into a bf16 operator's contraction, y2
    of the wrong dtype into its scatter, bf16 into the first design's
    gather), wrong shapes and a tensor off the card raise before any
    launch."""
    op, x = _small()
    card = _on_card(op)
    xc = x.as_subclass(_OnCard)
    u = torch.zeros(op.dofmap.shape, dtype=BF16).as_subclass(_OnCard)
    cases = [
        (lambda: cen.contract(card, u.float().as_subclass(_OnCard)),
         "input is torch.float32"),
        (lambda: cen.scatter(card, u.float().as_subclass(_OnCard)),
         "input is torch.float32"),
        (lambda: cen.gather_flat(card, xc), "unsupported"),
        (lambda: cen.gather(card, xc[1:]), "shape"),
        (lambda: cen.contract(card, u[1:]), "shape"),
        (lambda: cen.contract(card._replace(G=op.G), u), "G is"),
        (lambda: cen.contract(_on_card(op._replace(D=op.D.float())), u),
         "D is"),
        (lambda: cen.gather(op, xc), "dofmap is torch.int32 on cpu")]
    for fn, match in cases:
        with pytest.raises(ValueError, match=match):
            fn()
    assert no_card_launch == []


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("P", range(2, 11))
def test_bf16_engine_kernels_match_plain_on_card(tmp_path, P):
    """Each bf16 engine kernel against its plain version on the same bf16
    inputs (the gathers bitwise, the contraction and the scatter within
    CARD_TOL), the composed apply and pair within CARD_TOL, each repeated
    bitwise, on the imported cylinder read as a general mesh; the composed
    apply within APPLY_TOL of the bf16 indexed kernel on the same
    buffers."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    v, c, t = shapes.cylinder_mesh(nz=3 if P <= 6 else 2, **CYL)
    mesh = msh_io.read_msh(msh_io.write_msh(str(tmp_path / "c"), v, c, t),
                           P, detect_extrusion=False)
    disc = dz.Discretization(mesh)
    rng = np.random.default_rng(P)
    c1 = rng.uniform(0.5, 2.0, mesh.num_cells)
    c2 = rng.uniform(-1.5, -0.5, mesh.num_cells)
    x1, x2 = (torch.as_tensor(rng.standard_normal(mesh.ndofs),
                              device="cuda").to(BF16) for _ in range(2))
    cen.reset_launches()
    for kw in (dict(), dict(coeff=c1), dict(pair=(c1, c2))):
        pair = "pair" in kw
        op = disc.stiffness_op(BF16, "cuda", engine=True, **kw)
        p = cen.to_plain(op)
        if pair:
            u1, u2 = cen.gather2(op, x1, x2)
            assert torch.equal(u1.reshape(-1), eng.gather(x1, p.g))
            assert torch.equal(u2.reshape(-1), eng.gather(x2, p.g))
            yk = cen.contract(op, u1, u2)
            yp = eng.dense_contract(eng.fold(u1, p.c1, u2, p.c2), p.G6, p.D)
            assert torch.equal(cen.contract(op, u1, u2), yk)
        else:
            u1 = cen.gather(op, x1)
            assert torch.equal(u1.reshape(-1), eng.gather(x1, p.g))
            yk = cen.contract(op, u1)
            yp = eng.dense_contract(u1, p.G6, p.D, p.coeff)
            assert torch.equal(cen.contract(op, u1), yk)
        assert yk.dtype == BF16 and rel(yk.cpu(), yp.cpu()) <= CARD_TOL
        ys = cen.scatter(op, yk)
        assert rel(ys.cpu(), eng.scatter_add(yk, p.g,
                                             mesh.ndofs).cpu()) <= CARD_TOL
        assert torch.equal(cen.scatter(op, yk), ys)
        run = (lambda: cen.engine_pair(op, x1, x2)) if pair else \
            (lambda: cen.engine(op, x1))
        plain = (cen.engine_pair_plain(op, x1, x2) if pair
                 else cen.engine_plain(op, x1))
        y = run()
        torch.cuda.synchronize()
        assert y.dtype == BF16 and rel(y.cpu(), plain.cpu()) <= CARD_TOL
        assert torch.equal(run(), y)
        if "coeff" not in kw:
            iop = cen.to_indexed(op, ci.ChunkPlan(mesh.dofmap, mesh.ndofs))
            yi = (ci.indexed_pair(iop, x1, x2) if pair
                  else ci.indexed(iop, x1))
            assert rel(y.cpu(), yi.cpu()) <= APPLY_TOL
    assert not any(cen.launches.values())
    assert all(cen.bf16_launches.values())
