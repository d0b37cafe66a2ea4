"""The port's staged gather / contract / scatter engine against the JAX
package on the CPU in float64: the plain `gather`, `gather2`,
`dense_contract` and `scatter_add` against ``fustpu.ops.pallas_gather``'s
Pallas kernels in interpret mode (on a plan from its `build_plan`), the
composed apply and pair against ``operators.stiffness_apply_indexed`` with
``engine=`` and against the dense oracle, and the models with
``stiffness_impl="indexed_engine"`` at P = 5, where the JAX package's fused
engine declines and its models run the staged engine; and, on a card, the
four engine CUDA kernels against their plain version and the composed
apply against the indexed kernel on the same buffers.

The JAX package is imported inside the fixture that compares against it,
so that the card tests also run on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_engine.py -m cuda
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
from fustpu_torch.models.discretization import (Discretization,
                                                EngineStiffness,
                                                resolve_stiffness_impl)
from fustpu_torch.models.linear import LinearWaveModel
from fustpu_torch.models.westervelt import WesterveltModel
from fustpu_torch.ops import cuda_engine as cen
from fustpu_torch.ops import cuda_indexed as ci
from fustpu_torch.ops import engine as eng

torch.set_num_threads(1)

F64 = torch.float64
TOL = 1e-12           # operator gate, the reference's own f64 tolerance
MODEL_TOL = 1e-11     # RK4 steps of the operator gate
STEPS = 5
CYL = dict(radius=0.012, length=0.02, piston_radius=0.008, m=3, mr=1,
           nr_ann=1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules; skips where JAX is missing."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from fustpu import config as f_config
    from fustpu.mesh import box as f_box
    from fustpu.mesh import unstructured as f_un
    from fustpu.models import discretization as f_disc
    from fustpu.models.linear import LinearWaveModel as FLinear
    from fustpu.models.westervelt import WesterveltModel as FWest
    from fustpu.ops import operators as f_ops
    from fustpu.ops import pallas_gather as pg
    from fustpu.oracle import assemble as oracle

    return SimpleNamespace(jax=jax, jnp=jnp, config=f_config, box=f_box,
                           un=f_un, disc=f_disc, FLinear=FLinear,
                           FWest=FWest, ops=f_ops, pg=pg, oracle=oracle)


def _box(ref, P, nc=(3, 2, 4)):
    """(port mesh, JAX package mesh): a perturbed box as a shuffled general
    mesh."""
    um = un.from_box(build_box_mesh(nc, P, perturb=0.2, seed=3),
                     shuffle_seed=11)
    fum = ref.un.from_box(ref.box.build_box_mesh(nc, P, perturb=0.2, seed=3),
                          shuffle_seed=11)
    assert np.array_equal(um.dofmap, fum.dofmap)
    return um, fum


def _case(ref, P, seed):
    mesh, fmesh = _box(ref, P)
    rng = np.random.default_rng(seed)
    disc = Discretization(mesh)
    return SimpleNamespace(
        mesh=mesh, fmesh=fmesh, disc=disc,
        plan=ref.pg.build_plan(mesh.dofmap.ravel(), mesh.ndofs),
        G6=np.ascontiguousarray(np.moveaxis(disc._G_host, 2, 0)),
        x1=rng.standard_normal(mesh.ndofs), x2=rng.standard_normal(mesh.ndofs),
        c1=rng.uniform(0.5, 2.0, mesh.num_cells),
        c2=rng.uniform(-1.5, -0.5, mesh.num_cells))


@pytest.mark.parametrize("P", [2, 3])
def test_plain_functions_match_pallas_interpret(ref, P):
    """Each plain engine function (and its wrapper on CPU tensors) against
    the Pallas kernel in interpret mode: the gathers exact, the contraction
    (unit and per-cell coefficient) and the scatter within 1e-12."""
    jnp, pg = ref.jnp, ref.pg
    k = _case(ref, P, seed=P)
    j, t = jnp.asarray, torch.as_tensor
    g = t(k.mesh.dofmap.reshape(-1).astype(np.int64))
    op = k.disc.stiffness_op(F64, "cpu", engine=True)
    want = np.array(pg.gather(j(k.x1), k.plan, interpret=True))
    assert np.array_equal(eng.gather(t(k.x1), g).numpy(), want)
    assert np.array_equal(cen.gather(op, t(k.x1)).reshape(-1).numpy(), want)
    w1, w2 = pg.gather2(j(k.x1), j(k.x2), k.plan, interpret=True)
    u1, u2 = eng.gather2(t(k.x1), t(k.x2), g)
    assert np.array_equal(u1.numpy(), np.asarray(w1))
    assert np.array_equal(u2.numpy(), np.asarray(w2))
    cells = k.mesh.num_cells
    u = want.reshape(cells, -1)
    D = k.disc._D_host
    for coeff in (None, k.c1):
        y = pg.dense_contract(j(u), j(k.G6), j(D), coeff=None if coeff is None
                              else j(coeff), interpret=True)
        got = eng.dense_contract(t(u), t(k.G6), t(D),
                                 None if coeff is None else t(coeff))
        assert rel(got, y) <= TOL
    cop = k.disc.stiffness_op(F64, "cpu", engine=True, coeff=k.c1)
    assert rel(cen.contract(cop, t(u)), pg.dense_contract(
        j(u), j(k.G6), j(D), coeff=j(k.c1), interpret=True)) <= TOL
    v = np.random.default_rng(P).standard_normal(u.size)
    want = pg.scatter_add(j(v), k.plan, k.mesh.ndofs, interpret=True)
    assert rel(eng.scatter_add(t(v), g, k.mesh.ndofs), want) <= TOL
    assert rel(cen.scatter(op, t(v).reshape(cells, -1)), want) <= TOL
    assert all(n == 0 for n in cen.launches.values())


def test_inverse_map_lists_positions_in_order(ref):
    """Every dof's positions, ascending, exactly once."""
    mesh = _box(ref, 3)[0]
    pos, ptr = cen.inverse_map(mesh.dofmap, mesh.ndofs)
    g = mesh.dofmap.reshape(-1)
    assert ptr[0] == 0 and ptr[-1] == g.size
    assert np.array_equal(np.sort(pos), np.arange(g.size))
    for d in range(mesh.ndofs):
        p = pos[ptr[d]:ptr[d + 1]]
        assert np.all(g[p] == d) and np.all(np.diff(p) > 0)


@pytest.mark.parametrize("P", [2, 3])
def test_composed_apply_matches_operators_and_oracle(ref, P):
    """The composed engine apply (unit, per-cell coefficient) and pair
    against the JAX package's indexed path on its engine plan (interpret
    mode), and the coefficient apply against the dense oracle."""
    jnp, ops = ref.jnp, ref.ops
    k = _case(ref, P, seed=10 + P)
    j, t = jnp.asarray, torch.as_tensor
    G, dm, D = j(k.G6), j(k.mesh.dofmap), j(k.disc._D_host)
    nd = k.mesh.ndofs
    kw = dict(engine=k.plan, engine_interpret=True)
    for coeff in (None, k.c1):
        op = k.disc.stiffness_op(F64, "cpu", engine=True, coeff=coeff)
        want = ops.stiffness_apply_indexed(
            j(k.x1), G, None if coeff is None else j(coeff), dm, D, nd, **kw)
        assert rel(cen.engine(op, t(k.x1)), want) <= TOL
        assert rel(EngineStiffness(op, "mm")(t(k.x1)), want) <= TOL
    op = k.disc.stiffness_op(F64, "cpu", engine=True, pair=(k.c1, k.c2))
    want = ops.stiffness_apply_indexed_pair(j(k.x1), j(k.c1), j(k.x2),
                                            j(k.c2), G, dm, D, nd, **kw)
    assert rel(cen.engine_pair(op, t(k.x1), t(k.x2)), want) <= TOL
    assert rel(EngineStiffness(op, "mm").pair(t(k.x1), t(k.x2)), want) <= TOL
    mats = ref.oracle.element_stiffness_matrices(k.fmesh)
    y_ref = ref.oracle.apply_elementwise(mats, k.fmesh.dofmap, k.c1, k.x1, nd)
    op = k.disc.stiffness_op(F64, "cpu", engine=True, coeff=k.c1)
    assert rel(cen.engine(op, t(k.x1)), y_ref) <= TOL
    assert all(n == 0 for n in cen.launches.values())


def test_engine_route_resolves_and_refuses_a_box():
    """'indexed_engine' is the kernel on a CUDA device and the plain
    version on the CPU, on any imported mesh (extruded too); a box mesh
    refuses it."""
    assert resolve_stiffness_impl("indexed_engine", "cuda") == "cuda"
    assert resolve_stiffness_impl("indexed_engine", "cpu") == "mm"
    box = build_box_mesh((2, 2, 2), 2)
    with pytest.raises(ValueError, match="imported mesh"):
        LinearWaveModel(box, Material(), Source(), box.boundary_facets("x-"),
                        None, dtype=F64, device="cpu",
                        stiffness_impl="indexed_engine")


def test_engine_on_an_extruded_mesh(tmp_path):
    """An imported prismatic cylinder on the engine equals its extruded
    apply (the same operator through the mesh's dofmap)."""
    v, c, tags = shapes.cylinder_mesh(nz=3, **CYL)
    mesh = msh_io.read_msh(msh_io.write_msh(str(tmp_path / "c"), v, c,
                                            tags), 3)
    disc = Discretization(mesh)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(mesh.ndofs))
    eop = disc.stiffness_op(F64, "cpu", engine=True)
    from fustpu_torch.ops import cuda_extruded as ce
    assert rel(cen.engine(eop, x), ce.extruded(disc.stiffness_op(F64, "cpu"),
                                                x)) <= TOL
    model = WesterveltModel(mesh, Material(), Source(),
                            mesh.boundary_facets(1), mesh.boundary_facets(2),
                            dtype=F64, device="cpu",
                            stiffness_impl="indexed_engine")
    assert isinstance(model.stiffness, EngineStiffness)


# ---------------------------------------------------------------------------
# Models at P = 5 against the JAX package's staged engine
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
    cen_ = mesh.facet_centroids(ext)
    return ext[cen_[:, 0] < 1e-9], ext[cen_[:, 0] >= 1e-9]


def _model_reference(ref, name):
    """The JAX model (float64, 'indexed_engine' at P = 5: the staged
    engine, interpret mode), its dt, a seeded state and its run
    (cached)."""
    if name not in _REFERENCES:
        jnp = ref.jnp
        mesh, fmesh = _box(ref, 5, nc=(2, 2, 2))
        mat = _material(name, mesh)
        fmat = ref.config.Material(
            sound_speed=mat.sound_speed, density=mat.density,
            nonlinearity=mat.nonlinearity, attenuation_dB=mat.attenuation_dB)
        src = Source(frequency=0.5e6, amplitude=1e5)
        fsrc = ref.config.Source(frequency=0.5e6, amplitude=1e5)
        fcls = ref.FWest if name.startswith("westervelt") else ref.FLinear
        sf, af = _facets(fmesh)
        fmodel = fcls(fmesh, fmat, fsrc, sf, af, dtype=jnp.float64,
                      stiffness_impl="indexed_engine")
        assert fmodel._idx_engine is not None and fmodel._idx_fused is None
        dt, _ = fmodel.cfl_dt()
        rng = np.random.default_rng(0)
        u0 = rng.standard_normal(mesh.ndofs)
        v0 = rng.standard_normal(mesh.ndofs)
        s0 = fmodel.init_state(0.0, u0=u0, v0=v0)
        out, _ = fmodel.solve(s0, dt, STEPS)
        _REFERENCES[name] = SimpleNamespace(
            mesh=mesh, mat=mat, src=src, fmodel=fmodel, dt=dt, u0=u0,
            v0=v0, s0=s0, out=out)
    return _REFERENCES[name]


def _port_class(name):
    return WesterveltModel if name.startswith("westervelt") \
        else LinearWaveModel


@pytest.mark.parametrize("name", MODELS)
def test_engine_model_matches_fustpu(ref, name):
    r = _model_reference(ref, name)
    mesh, jnp = r.mesh, ref.jnp
    sf, af = _facets(mesh)
    model = _port_class(name)(mesh, r.mat, r.src, sf, af, dtype=F64,
                              device="cpu", stiffness_impl="indexed_engine")
    assert model.impl == "mm" and isinstance(model.stiffness,
                                             EngineStiffness)
    assert model.stiffness.is_pair == (name == "westervelt_two_layer")
    assert model.cfl_dt() == r.fmodel.cfl_dt()
    rng = np.random.default_rng(1)
    u, v = rng.standard_normal(mesh.ndofs), rng.standard_normal(mesh.ndofs)
    for t in (1.3e-7, 9.5e-6):
        want = r.fmodel.rhs(jnp.asarray(t), jnp.asarray(u), jnp.asarray(v))
        got = model.rhs(t, torch.as_tensor(u), torch.as_tensor(v))
        assert rel(got, want) <= MODEL_TOL
    out, _ = model.solve(model.init_state(0.0, u0=r.u0, v0=r.v0), r.dt, STEPS)
    assert rel(out.u, r.out.u) <= MODEL_TOL
    assert rel(out.v, r.out.v) <= MODEL_TOL


@pytest.mark.parametrize("name", MODELS)
def test_engine_model_from_fustpu_trajectory_matches(ref, name):
    """A port engine model built from the JAX model's params runs the same
    trajectory."""
    r = _model_reference(ref, name)
    p = r.fmodel.params
    a = np.asarray
    params = {k: a(v) for k, v in p.items() if k != "stiff"}
    G, dm, D = p["stiff"]
    params["stiff"] = dict(G=a(G), dofmap=a(dm), D=a(D))
    state = tuple(a(x) for x in r.s0[:4]) + (float(r.s0.t),)
    model, st = convert.model_from_fustpu(
        _port_class(name), params, state, mesh=r.mesh, material=r.mat,
        source=r.src, source_facets=_facets(r.mesh)[0], dtype=F64,
        device="cpu", stiffness_impl="indexed_engine")
    assert isinstance(model.stiffness, EngineStiffness)
    out, _ = model.solve(st, r.dt, STEPS)
    assert rel(out.u, r.out.u) <= MODEL_TOL
    assert rel(out.v, r.out.v) <= MODEL_TOL


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _random_dofmap(n, cells=120, ndofs=5000, seed=2):
    """Overlapping cells with their local ids in random order, a random G
    and a random D."""
    rng = np.random.default_rng(seed)
    n3 = n ** 3
    dm = np.zeros((cells, n3), np.int64)
    for c in range(cells):
        dm[c] = min(c * 28, ndofs - n3 - 1) + rng.permutation(n3)
    return dm, ndofs, rng.standard_normal((cells, n3, 6)), \
        rng.standard_normal((n, n)), rng


@pytest.mark.cuda
@pytest.mark.parametrize("P", range(2, 11))
def test_kernels_match_plain_on_card(tmp_path, P):
    """Each engine kernel against its plain version (the gathers bitwise,
    float64 to 1e-12, float32 to 1e-5 against the float64 plain version),
    the composed apply and pair, the composed apply against the indexed
    kernel on the same buffers, and a repeated apply bitwise identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    v, c, t = shapes.cylinder_mesh(nz=3 if P <= 6 else 2, **CYL)
    cyl = msh_io.read_msh(msh_io.write_msh(str(tmp_path / "c"), v, c, t), P,
                          detect_extrusion=False)
    dm, ndofs, G_rand, D_rand, rng = _random_dofmap(P + 1, seed=P)
    disc = Discretization(cyl)
    meshes = [(cyl, disc._G_host, disc._D_host),
              (SimpleNamespace(dofmap=dm, ndofs=ndofs, num_cells=120),
               G_rand, D_rand)]
    cen.reset_launches()
    for mesh, G, D in meshes:
        c1 = rng.uniform(0.5, 2.0, mesh.num_cells)
        c2 = rng.uniform(-1.5, -0.5, mesh.num_cells)
        x1 = torch.as_tensor(rng.standard_normal(mesh.ndofs), device="cuda")
        x2 = torch.as_tensor(rng.standard_normal(mesh.ndofs), device="cuda")
        plan = ci.ChunkPlan(mesh.dofmap, mesh.ndofs)
        for kw in (dict(), dict(coeff=c1), dict(pair=(c1, c2))):
            pair = "pair" in kw
            ref64 = cen.build(mesh, G, D, F64, "cuda", **kw)
            y_ref = (cen.engine_pair_plain(ref64, x1, x2) if pair
                     else cen.engine_plain(ref64, x1)).cpu()
            for dtype, tol in ((F64, TOL), (torch.float32, 1e-5)):
                op = cen.build(mesh, G, D, dtype, "cuda", **kw)
                a, b = x1.to(dtype), x2.to(dtype)
                run = (lambda: cen.engine_pair(op, a, b)) if pair else \
                    (lambda: cen.engine(op, a))
                y = run()
                torch.cuda.synchronize()
                assert rel(y.cpu(), y_ref) <= tol
                assert torch.equal(run(), y)
                g = op.dofmap.reshape(-1).long()
                assert torch.equal(cen.gather(op, a).reshape(-1),
                                   eng.gather(a, g))
                u1, u2 = cen.gather2(op, a, b)
                assert torch.equal(u1.reshape(-1), eng.gather(a, g))
                assert torch.equal(u2.reshape(-1), eng.gather(b, g))
                plain = cen.to_plain(op)
                if pair:
                    uc = (plain.c1[:, None] * u1.double()
                          + plain.c2[:, None] * u2.double())
                    yk = cen.contract(op, u1, u2)
                else:
                    uc = u1.double()
                    yk = cen.contract(op, u1)
                yp = eng.dense_contract(uc, cen.to_plain(ref64).G6,
                                        ref64.D, cen.to_plain(ref64).coeff)
                assert rel(yk.cpu(), yp.cpu()) <= tol
                ys = cen.scatter(op, yk)
                assert rel(ys.cpu(), eng.scatter_add(
                    yk.double(), g, mesh.ndofs).cpu()) <= tol
                if "coeff" not in kw:
                    yi = (ci.indexed_pair(cen.to_indexed(op, plan), a, b)
                          if pair else ci.indexed(
                              cen.to_indexed(op, plan), a))
                    assert rel(y.cpu(), yi.cpu()) <= tol
    # each case: two composed applies (three launches each) and one direct
    # call of every kernel
    assert cen.launches["engine_contract"] == 2 * 3 * 2 * 3
    assert cen.launches["engine_scatter"] == 2 * 3 * 2 * 3
    assert (cen.launches["engine_gather"]
            + cen.launches["engine_gather2"]) == 2 * 3 * 2 * 4
    assert cen.launches["engine_gather2"] > 0


# ---------------------------------------------------------------------------
# The single-field gather's host side: its grid and the wrapper's checks
# (no card needed)
# ---------------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that the wrappers take for one on card 0, so that
    their checks and launch arguments run here; `launch.launch` is
    replaced in each test that uses it, so nothing launches."""

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
    from fustpu_torch.ops import launch

    calls = []
    monkeypatch.setattr(launch, "launch",
                        lambda name, dev, *args: calls.append(
                            (name, dev, args)))
    monkeypatch.setattr(launch, "sm_count", lambda dev: 132)
    return calls


def _gather_walk(n, blocks):
    """How often `engine_gather_quads` (csrc/engine.cu) writes each
    position: thread t of T takes quads q = t + k T below n // 4
    (positions 4q .. 4q + 3), then position 4 (n // 4) + t below n."""
    from fustpu_torch.ops import launch

    T = blocks * launch.GATHER_THREADS
    nq = n // launch.GATHER_QUAD
    touched = []
    q = np.arange(T)
    while (live := q < nq).any():
        touched += [launch.GATHER_QUAD * q[live] + i
                    for i in range(launch.GATHER_QUAD)]
        q[live] += T
    tail = launch.GATHER_QUAD * nq + np.arange(T)
    touched.append(tail[tail < n])
    return np.bincount(np.concatenate(touched), minlength=n)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("n", [1, 3, 27, 125, 12_800_000])
def test_gather_grid_covers_every_position_once(n, sms):
    """The single-field gather's grid writes every position once.  A
    thread takes four positions in every dtype (one 16 B store in float32,
    two in float64, one 8 B store in bfloat16), so the grid is the same
    for each."""
    from fustpu_torch.ops import launch

    blocks = launch.gather_blocks(n, sms)
    assert 1 <= blocks <= sms * launch.BLOCKS_PER_SM
    assert np.array_equal(_gather_walk(n, blocks), np.ones(n, np.int64))


def _small_op(cells=5, n=3, dtype=F64):
    dm, ndofs, G, D, rng = _random_dofmap(n, cells=cells, ndofs=400)
    mesh = SimpleNamespace(dofmap=dm, ndofs=ndofs, num_cells=cells)
    return cen.build(mesh, G, D, dtype, "cpu"), rng


def test_gather_launch_arguments(no_card_launch):
    """On a card `gather` launches the new kernel with its pointers, the
    position count and the one-wave grid, `gather_flat` the first design;
    each counted in its own table."""
    cen.reset_launches()
    op, rng = _small_op()
    op = _on_card(op)
    x = torch.as_tensor(rng.standard_normal(op.ndofs)).as_subclass(_OnCard)
    out = cen.gather(op, x)
    cen.gather_flat(op, x)
    assert tuple(out.shape) == tuple(op.dofmap.shape)
    (name, dev, args), (fname, _, fargs) = no_card_launch
    assert name == "fustpu_engine_gather_f64" and dev == 0
    assert args == (x.data_ptr(), op.dofmap.data_ptr(), out.data_ptr(), 135,
                    1)
    assert fname == "fustpu_engine_gather_flat_f64" and fargs[3] == 135
    assert cen.launches["engine_gather"] == 1
    assert cen.comparison_launches["engine_gather_flat"] == 1


def test_gather_refuses_before_any_launch(no_card_launch):
    """A misaligned or non-contiguous dofmap, or a field of the wrong
    size, raises before the wrapper launches anything."""
    op, rng = _small_op()
    x = torch.as_tensor(rng.standard_normal(op.ndofs)).as_subclass(_OnCard)
    base = torch.zeros(op.dofmap.numel() + 1, dtype=torch.int32)
    shifted = base[1:].view(op.dofmap.shape)
    shifted.copy_(op.dofmap)
    wide = torch.zeros(op.dofmap.shape[0], 2 * op.dofmap.shape[1],
                       dtype=torch.int32)
    for dofmap, match, fns in (
            (shifted, "16-byte aligned", (cen.gather,)),
            (wide[:, ::2], "not contiguous", (cen.gather, cen.gather_flat))):
        bad = _on_card(op._replace(dofmap=dofmap))
        for fn in fns:
            with pytest.raises(ValueError, match=match):
                fn(bad, x)
    for fn in (cen.gather, cen.gather_flat):
        with pytest.raises(ValueError, match="shape"):
            fn(_on_card(op), x[1:])
    assert no_card_launch == []


@pytest.mark.cuda
@pytest.mark.parametrize("P", range(2, 11))
def test_gather_matches_index_select_and_first_design_on_card(tmp_path, P):
    """The single-field gather bitwise equal to `x.index_select(0, g)` and
    to the first design's kernel, float32 and float64, on the meshes of
    `test_kernels_match_plain_on_card` and on 121 random cells (at even P
    an odd number of positions: the scalar tail runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    v, c, t = shapes.cylinder_mesh(nz=3 if P <= 6 else 2, **CYL)
    cyl = msh_io.read_msh(msh_io.write_msh(str(tmp_path / "c"), v, c, t), P,
                          detect_extrusion=False)
    disc = Discretization(cyl)
    meshes = [(cyl, disc._G_host, disc._D_host)]
    for cells in (120, 121):
        dm, ndofs, G, D, rng = _random_dofmap(P + 1, cells=cells, seed=P)
        meshes.append((SimpleNamespace(dofmap=dm, ndofs=ndofs,
                                       num_cells=cells), G, D))
    assert ((121 * (P + 1) ** 3) % 4 != 0) == (P % 2 == 0)
    cen.reset_launches()
    for mesh, G, D in meshes:
        x = torch.as_tensor(rng.standard_normal(mesh.ndofs), device="cuda")
        for dtype in (F64, torch.float32):
            op = cen.build(mesh, G, D, dtype, "cuda")
            a = x.to(dtype)
            got = cen.gather(op, a)
            torch.cuda.synchronize()
            assert torch.equal(got.reshape(-1),
                               a.index_select(0, op.dofmap.reshape(-1).long()))
            assert torch.equal(got, cen.gather_flat(op, a))
    assert cen.launches["engine_gather"] == 6
    assert cen.comparison_launches["engine_gather_flat"] == 6
