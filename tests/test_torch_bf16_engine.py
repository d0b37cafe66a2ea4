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
launch arguments and checks; the host side of the redesigned bf16
contraction and scatter (their grids, the cells and dofs each block walks,
the bulk-copy spans, the scatter's tiles emulated in float32 against the
first design's order of adds) and of the first designs kept as the
comparison; and, on a card, the four bf16 engine kernels against their
plain versions and the redesigned contraction and scatter against the
first designs.

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

import ctypes
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
from fustpu_torch.ops import cuda_stiffness as cs
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
    cen.reset_launches()      # count this test's launches only
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


OCCUPANCY = 5     # the contraction's blocks an SM where the card is replaced


@pytest.fixture
def no_card_launch(monkeypatch):
    """`launch.launch` recording its calls, 132 SMs, and OCCUPANCY blocks of
    the bf16 contraction an SM."""
    calls = []
    monkeypatch.setattr(launch, "launch",
                        lambda name, dev, *args: calls.append(
                            (name, dev, args)))
    monkeypatch.setattr(launch, "sm_count", lambda dev: 132)
    monkeypatch.setattr(launch, "contract_occupancy",
                        lambda dev, P, mode: OCCUPANCY)
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
    """On a card each bf16 wrapper launches its bf16 entry point, counted
    in `bf16_launches` only: the gathers with the float32 kernels'
    arguments (both on the one-wave grid of four positions a thread), the
    redesigned contraction with D's host copy, the cells a chunk and its
    one-wave grid, the redesigned scatter with the positions and one block
    a run of dofs; u2, y2 and y in bf16."""
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
    assert no_card_launch[1][2] == (x.data_ptr(), x.data_ptr(),
                                    op.dofmap.data_ptr(), u1.data_ptr(),
                                    u2.data_ptr(), n,
                                    launch.gather_blocks(n, 132))
    cells = op.dofmap.shape[0]
    assert no_card_launch[2][2] == (
        u1.data_ptr(), u2.data_ptr(), op.C.data_ptr(), 0, op.G.data_ptr(),
        cen.host_D(op.D), y2.data_ptr(), cells, 2, 2,
        launch.CONTRACT_CELLS[2], launch.contract_blocks(cells, 2,
                                                         OCCUPANCY, 132))
    assert launch.contract_blocks(cells, 2, OCCUPANCY, 132) == 1
    assert no_card_launch[3][2] == (y2.data_ptr(), op.pos.data_ptr(),
                                    op.ptr.data_ptr(), y.data_ptr(),
                                    op.ndofs, n,
                                    launch.scatter_blocks(op.ndofs))
    assert launch.scatter_blocks(op.ndofs) == 4
    assert not any(cen.launches.values())
    assert not any(cen.comparison_launches.values())
    assert all(v == 1 for v in cen.bf16_launches.values())


def _shifted(t: torch.Tensor) -> torch.Tensor:
    """t's values in a tensor whose data starts one element (2 or 4 B)
    past a 16 B boundary."""
    base = torch.zeros(t.numel() + 1, dtype=t.dtype)
    out = base[1:].view(t.shape)
    out.copy_(t)
    return out


def test_bf16_wrappers_refuse_before_any_launch(no_card_launch):
    """Wrong dtypes (a float32 field into a bf16 operator's contraction, y2
    of the wrong dtype into its scatter, bf16 into the first design's
    gather, float32 into the first bf16 designs kept as the comparison),
    wrong shapes, a tensor off the card, and buffers the redesigned
    contraction and scatter cannot take (u, u2 or G off a 16 B boundary,
    pos off one) raise before any launch."""
    op, x = _small()
    card = _on_card(op)
    xc = x.as_subclass(_OnCard)
    u = torch.zeros(op.dofmap.shape, dtype=BF16).as_subclass(_OnCard)
    pop = _on_card(_small(pair=True)[0])
    f32 = _on_card(_small(dtype=torch.float32)[0])
    uf = u.float().as_subclass(_OnCard)
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
        (lambda: cen.gather(op, xc), "dofmap is torch.int32 on cpu"),
        (lambda: cen.contract(card, _shifted(u).as_subclass(_OnCard)),
         "u1 not 16-byte aligned"),
        (lambda: cen.contract(pop, u, _shifted(u).as_subclass(_OnCard)),
         "u2 not 16-byte aligned"),
        (lambda: cen.contract(_on_card(op._replace(G=_shifted(op.G))), u),
         "G not 16-byte aligned"),
        (lambda: cen.scatter(_on_card(op._replace(pos=_shifted(op.pos))), u),
         "pos not 16-byte aligned"),
        (lambda: cen.contract_cells(f32, uf), "unsupported"),
        (lambda: cen.scatter_dofs(f32, uf), "unsupported"),
        (lambda: cen.contract_cells(card, u[1:]), "shape"),
        (lambda: cen.contract_cells(pop, u), "takes two fields"),
        (lambda: cen.scatter_dofs(card, xc), "shape")]
    for fn, match in cases:
        with pytest.raises(ValueError, match=match):
            fn()
    assert no_card_launch == []


def test_bf16_first_designs_launch_as_the_comparison(no_card_launch):
    """`contract_cells` and `scatter_dofs` launch the first bf16 designs
    (their own arguments: no chunk, no grid, D on the card), counted in
    `comparison_launches` only; on CPU tensors they are the plain
    versions, as `contract` and `scatter` are there."""
    cen.reset_launches()
    for pair in (False, True):
        op, x = _small(pair=pair)
        u = cen.gather2(op, x, x) if pair else (cen.gather(op, x),)
        want = cen.contract(op, *u)
        assert torch.equal(cen.contract_cells(op, *u), want)
        assert torch.equal(cen.scatter_dofs(op, want), cen.scatter(op, want))
        card = _on_card(op)
        uc = [t.as_subclass(_OnCard) for t in u]
        y2 = cen.contract_cells(card, *uc)
        y = cen.scatter_dofs(card, y2.as_subclass(_OnCard))
        (cname, _, cargs), (sname, _, sargs) = no_card_launch[-2:]
        assert (cname, sname) == ("fustpu_engine_contract_cells_bf16",
                                  "fustpu_engine_scatter_dofs_bf16")
        assert cargs == (uc[0].data_ptr(),
                         uc[1].data_ptr() if pair else 0,
                         card.C.data_ptr() if pair else 0, 0,
                         card.G.data_ptr(), card.D.data_ptr(),
                         y2.data_ptr(), card.dofmap.shape[0], 2,
                         2 if pair else 0)
        assert sargs == (y2.data_ptr(), card.pos.data_ptr(),
                         card.ptr.data_ptr(), y.data_ptr(), card.ndofs)
        assert (y2.dtype, y.dtype) == (BF16, BF16)
    assert cen.comparison_launches == {"engine_gather_flat": 0,
                                       "engine_gather2_flat": 0,
                                       "engine_gather2_flat_bf16": 0,
                                       "engine_contract_cells_bf16": 2,
                                       "engine_scatter_dofs_bf16": 2}
    assert not any(cen.launches.values())
    assert not any(cen.bf16_launches.values())


def test_host_D_is_kept_and_follows_changes():
    """The bf16 contraction's D by value: a float32 host copy of the
    operator's D, made once a tensor, remade after an in-place change."""
    D = torch.tensor([[0.5, -1.25], [3.0, 7.5]], dtype=BF16)
    at = cen.host_D(D)
    assert cen.host_D(D) == at
    got = (ctypes.c_float * 4).from_address(at)
    assert list(got) == [0.5, -1.25, 3.0, 7.5]
    D[1, 1] = 2.0
    got = (ctypes.c_float * 4).from_address(cen.host_D(D))
    assert list(got) == [0.5, -1.25, 3.0, 2.0]


def _region(L: int) -> int:
    """A stage's room for a span of a run of L bytes (engine_bf16.cu
    Ring::region)."""
    return L if L % 16 == 0 else -(-(L + 30) // 16) * 16


@pytest.mark.parametrize("P", range(2, 11))
def test_contract_walk_covers_every_cell_once(P):
    """The redesigned bf16 contraction's host plan at every degree: for
    meshes of 1 to 102,400 cells (counts that are and are not multiples of
    8 and of the cells a chunk) on cards holding 1 or 5 blocks an SM, the
    blocks' chunks (block b: chunks b, b + grid, ...) hold every cell
    once; each chunk's bulk-copy spans of u (2 n^3 B a cell) and G (12 n^3
    B) start at or before the chunk on a 16 B boundary, are 16 B multiples
    inside the array, leave at most the array's last 15 B to the block's
    own reads, and with that tail fit the stage; where a chunk's run is a
    16 B multiple (the P = 4 and P = 6 bowls), every span is the run."""
    n3, ch = (P + 1) ** 3, launch.CONTRACT_CELLS[P]
    for cells in (1, 7, 8, 13, ch + 1, 1001, 102_400):
        for per_sm in (1, OCCUPANCY):
            grid = launch.contract_blocks(cells, P, per_sm, 132)
            chunks = -(-cells // ch)
            assert grid == max(1, min(132 * per_sm, chunks))
            seen = np.zeros(cells, np.int64)
            first = []
            for b in range(grid):
                for q in range(b, chunks, grid):
                    c0 = q * ch
                    seen[c0:min(c0 + ch, cells)] += 1
                    first.append(c0)
            assert (seen == 1).all()
            c0 = np.array(sorted(first))
            ncell = np.minimum(ch, cells - c0)
            for cb in (2 * n3, 12 * n3):
                off, nbytes = cs.bulk_spans(c0, ncell, cb, cells * cb)
                start, end = c0 * cb, (c0 + ncell) * cb
                assert (off % 16 == 0).all() and (nbytes % 16 == 0).all()
                assert (off <= start).all() and (nbytes >= 0).all()
                assert (off + nbytes <= cells * cb).all()
                assert (end - (off + nbytes) < 16).all()
                assert (end - off <= _region(ch * cb)).all()
                if (ch * cb) % 16 == 0:
                    last = end == cells * cb
                    assert (off == start).all()
                    assert (nbytes[~last] == (end - start)[~last]).all()
    if P in (4, 6):
        assert (2 * n3 * launch.CONTRACT_CELLS[P]) % 16 == 0


def _scatter_emulated(v32: np.ndarray, pos: np.ndarray, ptr: np.ndarray,
                      ndofs: int) -> tuple[np.ndarray, np.ndarray]:
    """The redesigned scatter's walk in float32 (engine_bf16.cu
    `scatter_runs`): y and how often each entry was added.  Block b takes
    dofs [R b, R b + R), R = SCATTER_DOFS, thread t its dofs 2t and 2t + 1,
    the run's segment of pos in tiles of 2 R entries from the 16 B
    boundary at or below its start, four entries a thread a tile (one
    16 B load where all four lie in pos, else one at a time)."""
    R = launch.SCATTER_DOFS
    tile = 2 * R
    y = np.zeros(ndofs, np.float32)
    used = np.zeros(pos.size, np.int64)
    for b in range(launch.scatter_blocks(ndofs)):
        d0 = b * R
        nd = min(R, ndofs - d0)
        e0, e1 = int(ptr[d0]), int(ptr[d0 + nd])
        for t in range(R // 2):
            da = 2 * t
            if da >= nd:
                continue
            a, mid = int(ptr[d0 + da]), int(ptr[d0 + da + 1])
            c = int(ptr[d0 + da + 2]) if da + 1 < nd else mid
            acc = [np.float32(0.0), np.float32(0.0)]
            for t0 in range(e0 & ~3, e1, tile):
                assert t0 % 4 == 0
                for x in range(max(a, t0), min(c, t0 + tile)):
                    assert e0 <= x < e1
                    acc[x >= mid] = np.float32(acc[x >= mid]
                                               + v32[pos[x]])
                    used[x] += 1
            y[d0 + da] = acc[0]
            if da + 1 < nd:
                y[d0 + da + 1] = acc[1]
    return y, used


def test_scatter_runs_cover_every_dof_once():
    """The redesigned bf16 scatter's host plan on an inverse map of 1,500
    dofs (not a multiple of the run) whose positions are 0 to 8 a dof, one
    dof 9 and one 2,500 (more than a run's tiles hold, many times over):
    every entry added once, by its dof's thread, in
    ascending order across tiles, so that the float32 sums, rounded once,
    are bitwise the first design's order of adds and the plain version."""
    rng = np.random.default_rng(4)
    ndofs = 1500
    counts = rng.integers(0, 9, ndofs)
    counts[[3, 700]] = [9, 2500]
    g = rng.permutation(np.repeat(np.arange(ndofs), counts))
    g = g[: g.size // 27 * 27]                  # whole cells of n = 3
    pos, ptr = cen.inverse_map(g.reshape(-1, 27), ndofs)
    assert np.array_equal(np.diff(ptr), np.bincount(g, minlength=ndofs))
    v = _bf16(rng.standard_normal(g.size))
    v32 = v.float().numpy()
    y, used = _scatter_emulated(v32, pos, ptr, ndofs)
    assert (used == 1).all()
    want = np.zeros(ndofs, np.float32)         # the first design: a dof's
    for d in range(ndofs):                     # positions in ascending
        for k in range(ptr[d], ptr[d + 1]):    # order, from 0.0
            want[d] = np.float32(want[d] + v32[pos[k]])
    assert np.array_equal(y, want)
    got = torch.from_numpy(y).to(BF16)
    plain = eng.scatter_add(v, torch.as_tensor(g.astype(np.int64)), ndofs)
    assert torch.equal(got, plain)
    assert launch.scatter_blocks(ndofs) == -(-ndofs // launch.SCATTER_DOFS)
    assert launch.scatter_blocks(1) == 1


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


def test_exp_engine_bf16_demo_on_cpu(capsys):
    """`exp_engine_bf16` on a small box on the CPU, where both designs are
    the plain versions: every case compared and timed in turns (old, new,
    new, old), the designs equal; it refuses another dtype."""
    from fustpu_torch.demos import exp_engine_bf16

    out = exp_engine_bf16.main(["--nc", "3", "2", "2", "--degree", "2",
                                "--turns", "1", "--device", "cpu"])
    assert set(out) == {"contract plain", "contract coeff", "contract pair",
                        "scatter", "apply", "apply pair"}
    for r in out.values():
        assert len(r["old"]) == len(r["new"]) == 2
        assert r["differ"] == 0 and r["rel"] == 0.0 and r["bound_ms"] > 0
    assert "host clock on the CPU" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        exp_engine_bf16.main(["--device", "cpu", "--dtype", "f32"])


def _shared_dof_mesh(P: int, cells: int, seed: int):
    """`cells` random cells of degree P (a count that is no multiple of 8)
    whose node 0 is one dof, held by every cell (an irregular vertex of
    `cells` positions); the other nodes random distinct dofs; random G, D
    and per-cell coefficients."""
    rng = np.random.default_rng(seed)
    n3 = (P + 1) ** 3
    ndofs = cells * n3 // 2 + n3
    dm = np.stack([np.concatenate([[0], 1 + rng.choice(ndofs - 1, n3 - 1,
                                                      replace=False)])
                   for _ in range(cells)])
    return (SimpleNamespace(dofmap=dm, ndofs=ndofs, num_cells=cells),
            rng.standard_normal((cells, n3, 6)),
            rng.standard_normal((P + 1, P + 1)),
            rng.uniform(0.5, 2.0, cells), rng.uniform(-1.5, -0.5, cells),
            rng)


@pytest.mark.cuda
@pytest.mark.parametrize("P", range(2, 11))
def test_bf16_redesigned_kernels_match_first_designs_on_card(tmp_path, P):
    """The redesigned bf16 contraction (unit, per-cell coefficient, pair)
    and scatter against the first designs kept as the comparison, on the
    same buffers: the scatter bitwise, the contraction bitwise or within
    1e-3 rel-l2 with at most 1% of its values differing; each within
    CARD_TOL of its plain version and repeated bitwise; on the imported
    cylinder read as a general mesh and on 13 random cells sharing one
    dof."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    v, c, t = shapes.cylinder_mesh(nz=3 if P <= 6 else 2, **CYL)
    cyl = msh_io.read_msh(msh_io.write_msh(str(tmp_path / "c"), v, c, t),
                          P, detect_extrusion=False)
    disc = dz.Discretization(cyl)
    rng = np.random.default_rng(P)
    cases = [(cyl, disc._G_host, disc._D_host,
              rng.uniform(0.5, 2.0, cyl.num_cells),
              rng.uniform(-1.5, -0.5, cyl.num_cells))]
    cases.append(_shared_dof_mesh(P, 13, seed=P)[:5])
    cen.reset_launches()
    for mesh, G, D, c1, c2 in cases:
        x1, x2 = (torch.as_tensor(rng.standard_normal(mesh.ndofs),
                                  device="cuda").to(BF16) for _ in range(2))
        for kw in (dict(), dict(coeff=c1), dict(pair=(c1, c2))):
            op = cen.build(mesh, G, D, BF16, "cuda", **kw)
            p = cen.to_plain(op)
            if "pair" in kw:
                us = cen.gather2(op, x1, x2)
                plain = eng.dense_contract(eng.fold(us[0], p.c1, us[1],
                                                    p.c2), p.G6, p.D)
            else:
                us = (cen.gather(op, x1),)
                plain = eng.dense_contract(us[0], p.G6, p.D, p.coeff)
            new = cen.contract(op, *us)
            old = cen.contract_cells(op, *us)
            torch.cuda.synchronize()
            differ = int((new != old).sum())
            assert torch.equal(cen.contract(op, *us), new)
            assert rel(new.cpu(), old.cpu()) <= 1e-3
            assert differ <= new.numel() // 100, (differ, new.numel())
            assert rel(new.cpu(), plain.cpu()) <= CARD_TOL
            y = cen.scatter(op, new)
            torch.cuda.synchronize()
            assert torch.equal(y, cen.scatter_dofs(op, new))
            assert torch.equal(cen.scatter(op, new), y)
            assert rel(y.cpu(), eng.scatter_add(new, p.g,
                                                mesh.ndofs).cpu()) <= CARD_TOL
    assert not any(cen.launches.values())
    assert cen.bf16_launches["engine_contract_bf16"] == 12
    assert cen.bf16_launches["engine_scatter_bf16"] == 12
    assert cen.comparison_launches["engine_contract_cells_bf16"] == 6
    assert cen.comparison_launches["engine_scatter_dofs_bf16"] == 6


@pytest.mark.cuda
@pytest.mark.parametrize("P", range(2, 11))
def test_bf16_gather2_matches_first_design_on_card(tmp_path, P):
    """The bf16 two-field gather (four positions a thread, one 8 B store a
    field) bitwise equal to its first design (one thread a position) and
    to `index_select` of each field, on the imported cylinder read as a
    general mesh and on 13 random cells sharing one dof (at even P an odd
    number of positions: the scalar tail runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    v, c, t = shapes.cylinder_mesh(nz=3 if P <= 6 else 2, **CYL)
    cyl = msh_io.read_msh(msh_io.write_msh(str(tmp_path / "c"), v, c, t),
                          P, detect_extrusion=False)
    disc = dz.Discretization(cyl)
    rng = np.random.default_rng(P)
    cases = [(cyl, disc._G_host, disc._D_host),
             _shared_dof_mesh(P, 13, seed=P)[:3]]
    cen.reset_launches()
    for mesh, G, D in cases:
        x1, x2 = (torch.as_tensor(rng.standard_normal(mesh.ndofs),
                                  device="cuda").to(BF16) for _ in range(2))
        op = cen.build(mesh, G, D, BF16, "cuda")
        u1, u2 = cen.gather2(op, x1, x2)
        f1, f2 = cen.gather2_flat(op, x1, x2)
        torch.cuda.synchronize()
        g = op.dofmap.reshape(-1).long()
        assert torch.equal(u1, f1) and torch.equal(u2, f2)
        assert torch.equal(u1.reshape(-1), x1.index_select(0, g))
        assert torch.equal(u2.reshape(-1), x2.index_select(0, g))
    assert cen.bf16_launches["engine_gather2_bf16"] == 2
    assert cen.comparison_launches["engine_gather2_flat_bf16"] == 2
