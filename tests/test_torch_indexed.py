"""The port's non-prismatic (indexed) slice against the JAX package on the
CPU in float64: imported general meshes and their `locality_order`, the
plain indexed stiffness and mass applies against `operators.py`, the fused
Pallas engine in interpret mode and the dense oracle, the scatter classes
of the indexed kernel, `convert` of the indexed and fused-engine layouts,
the models (rhs and 10-step trajectories, directly and through `convert`)
on an imported cylinder and a small bodyfit bowl, the bodyfit bowl demo
and its CLI; and, on a card, the indexed CUDA kernels against their plain
version.

The JAX package is imported inside the fixtures that compare against it
(they skip where JAX is missing), so that the card tests also run on a
machine without JAX:

    python -m pytest --noconftest tests/test_torch_indexed.py -m cuda
"""

import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fustpu_torch import convert
from fustpu_torch.config import Material, Source
from fustpu_torch.demos import nonlinear_bowl
from fustpu_torch.mesh import msh_io, shapes
from fustpu_torch.mesh import unstructured as un
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.mesh.extruded import ExtrudedHexMesh
from fustpu_torch.models.discretization import (Discretization,
                                                IndexedStiffness,
                                                resolve_stiffness_impl)
from fustpu_torch.models.linear import LinearWaveModel
from fustpu_torch.models.westervelt import WesterveltModel
from fustpu_torch.ops import cuda_indexed as ci
from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.ops import indexed as idx
from fustpu_torch.ops import precompute as pre

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
F64 = torch.float64
SETUP_TOL = 1e-14     # host setup: the same float64 numpy arithmetic
TOL = 1e-12           # operator gate, the reference's own f64 tolerance
MODEL_TOL = 1e-11     # 10 RK4 steps of the operator gate
STEPS = 10
CYL = dict(radius=0.012, length=0.02, piston_radius=0.008, m=3, mr=1,
           nr_ann=1)
BOWL = ["--elements", "16", "--degree", "2", "--geometry", "bodyfit",
        "--device", "cpu", "--dtype", "f64"]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules; skips where JAX is missing.  The fused
    engine is built with one plan tile per grid step, so that its
    interpret mode traces in about a second (the default eight-tile
    supertile takes ~8 s); the tile size, which `locality_order` reads,
    stays the default."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from demos.demo_nonlinear_bowl import bodyfit_mapping
    from fustpu import config as f_config
    from fustpu.mesh import box as f_box
    from fustpu.mesh import msh_io as f_msh
    from fustpu.mesh import unstructured as f_un
    from fustpu.models import discretization as f_disc
    from fustpu.models.linear import LinearWaveModel as FLinear
    from fustpu.models.westervelt import WesterveltModel as FWest
    from fustpu.ops import operators as f_ops
    from fustpu.ops import pallas_gather as pg
    from fustpu.ops import precompute as f_pre
    from fustpu.oracle import assemble as oracle

    old = pg.FST
    pg.FST = 1
    yield SimpleNamespace(jax=jax, jnp=jnp, config=f_config, box=f_box,
                          msh=f_msh, un=f_un, disc=f_disc, FLinear=FLinear,
                          FWest=FWest, ops=f_ops, pg=pg, pre=f_pre,
                          oracle=oracle, bodyfit_mapping=bodyfit_mapping)
    pg.FST = old


@pytest.fixture(scope="module")
def msh_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("msh")


def _bodyfit(ref, directory):
    """(port mesh, JAX package mesh) of the small bodyfit bowl: the port's
    through its demo's `build`, the JAX package's as its demo builds it
    (mapped, exported to a tagged .msh, imported)."""
    model, _, _, _ = nonlinear_bowl.build(
        nonlinear_bowl.parser().parse_args(BOWL))
    fmesh = ref.box.build_mapped_mesh(
        (16, 8, 8), 2,
        ref.bodyfit_mapping(0.035, 0.016, 0.025, 0.025, 0.08, 0.05),
        hi=(0.08, 0.05, 0.05))
    ap = lambda c: ((c[:, 1] - 0.025) ** 2 + (c[:, 2] - 0.025) ** 2
                    ) < 0.016 ** 2
    cap = fmesh.boundary_facets("x-", predicate=ap)
    other = np.concatenate(
        [fmesh.boundary_facets("x-", predicate=lambda c: ~ap(c))]
        + [fmesh.boundary_facets(p) for p in ["x+", "y-", "y+", "z-",
                                              "z+"]])
    path = ref.msh.export_box_msh(fmesh, {1: cap, 2: other},
                                  str(Path(directory) / "fbowl"))
    return model.mesh, ref.msh.read_msh(path, 2)


def _meshes(ref, directory, kind, P):
    """(port mesh, JAX package mesh) of one non-prismatic kind."""
    if kind == "cylinder":
        v, c, t = shapes.cylinder_mesh(nz=3 if P <= 6 else 2, **CYL)
        path = msh_io.write_msh(str(Path(directory) / f"cyl{P}"), v, c, t)
        return (msh_io.read_msh(path, P, detect_extrusion=False),
                ref.msh.read_msh(path, P, detect_extrusion=False))
    if kind == "bodyfit":
        return _bodyfit(ref, directory)
    nc = (3, 2, 4) if P <= 4 else (2, 2, 2)
    um = un.from_box(build_box_mesh(nc, P, perturb=0.2, seed=3),
                     shuffle_seed=11)
    fum = ref.un.from_box(ref.box.build_box_mesh(nc, P, perturb=0.2,
                                                 seed=3), shuffle_seed=11)
    if kind == "box":
        return um, fum
    # "perturbed": the same box through a .msh file and back
    path = msh_io.write_msh(str(Path(directory) / f"box{P}"), um.vertices,
                            um.cells)
    return msh_io.read_msh(path, P), ref.msh.read_msh(path, P)


def _assert_same_mesh(mesh, fmesh):
    assert not isinstance(mesh, ExtrudedHexMesh)
    assert np.array_equal(mesh.cells, fmesh.cells)
    assert np.array_equal(mesh.dofmap, fmesh.dofmap)
    assert mesh.ndofs == fmesh.ndofs
    assert mesh.facet_tag_map.keys() == fmesh.facet_tag_map.keys()
    for tag in fmesh.facet_tag_map:
        assert np.array_equal(mesh.facet_tag_map[tag],
                              fmesh.facet_tag_map[tag])
    assert rel(mesh.node_coords, fmesh.node_coords) <= SETUP_TOL


@pytest.mark.parametrize("kind", ["cylinder", "perturbed", "bodyfit"])
def test_imported_mesh_matches(ref, msh_dir, kind):
    mesh, fmesh = _meshes(ref, msh_dir, kind, 2)
    _assert_same_mesh(mesh, fmesh)


def test_locality_order_matches(ref):
    """A file order that fronts badly (z fastest on a long z column): both
    packages pick the same sweep, which is not the file order; and
    reorder_cells (of a random order) and _rcm_order agree on their own."""
    hi = (0.01, 0.01, 0.08)
    um = un.from_box(build_box_mesh((6, 6, 40), 3, hi=hi))
    fum = ref.un.from_box(ref.box.build_box_mesh((6, 6, 40), 3, hi=hi))
    perm = np.random.default_rng(5).permutation(um.num_cells)
    _assert_same_mesh(un.reorder_cells(um, perm),
                      ref.un.reorder_cells(fum, perm))
    assert np.array_equal(un._rcm_order(um), ref.un._rcm_order(fum))
    lo, flo = un.locality_order(um), ref.un.locality_order(fum)
    assert not np.array_equal(lo.cells, um.cells)
    _assert_same_mesh(lo, flo)


def _apply_case(ref, directory, kind, P, seed=0):
    mesh, fmesh = _meshes(ref, directory, kind, P)
    rng = np.random.default_rng(seed)
    return SimpleNamespace(
        mesh=mesh, fmesh=fmesh, disc=Discretization(mesh),
        fdisc=ref.disc.Discretization(fmesh, ref.jnp.float64),
        x1=rng.standard_normal(mesh.ndofs),
        x2=rng.standard_normal(mesh.ndofs),
        c1=rng.uniform(0.5, 2.0, mesh.num_cells),
        c2=rng.uniform(-1.5, -0.5, mesh.num_cells))


@pytest.mark.parametrize("P", range(2, 11))
def test_plain_apply_matches_operators(ref, msh_dir, P):
    """Single (unit and per-cell coefficient) and pair applies of the
    kernel-layout operator on CPU tensors (the plain version), and the
    indexed mass apply, against the JAX package's indexed path, P = 2..10
    (a smaller mesh at P >= 5)."""
    jnp, ops = ref.jnp, ref.ops
    k = _apply_case(ref, msh_dir, "cylinder" if P <= 4 else "box", P,
                    seed=P)
    G, dm, D = k.fdisc.indexed_op
    x1, x2 = jnp.asarray(k.x1), jnp.asarray(k.x2)
    c1, c2 = jnp.asarray(k.c1), jnp.asarray(k.c2)
    nd = k.mesh.ndofs
    t = torch.as_tensor
    ci.reset_launches()
    y = ci.indexed(k.disc.stiffness_op(F64, "cpu"), t(k.x1))
    assert rel(y, ops.stiffness_apply_indexed(x1, G, None, dm, D, nd)) <= TOL
    y = ci.indexed(k.disc.stiffness_op(F64, "cpu", coeff=k.c1), t(k.x1))
    assert rel(y, ops.stiffness_apply_indexed(x1, G, c1, dm, D, nd)) <= TOL
    y = ci.indexed_pair(k.disc.stiffness_op(F64, "cpu", pair=(k.c1, k.c2)),
                        t(k.x1), t(k.x2))
    assert rel(y, ops.stiffness_apply_indexed_pair(x1, c1, x2, c2, G, dm, D,
                                                   nd)) <= TOL
    assert ci.launches == {"indexed": 0, "indexed_pair": 0}
    detJ = pre.cell_detJ(k.mesh)
    y = idx.mass_apply_indexed(t(k.x1), t(detJ), t(k.c1),
                               t(k.mesh.dofmap.astype(np.int64)), nd)
    assert rel(y, ops.mass_apply_indexed(x1, jnp.asarray(detJ), c1, dm,
                                         nd)) <= TOL


@pytest.mark.parametrize("kind", ["cylinder", "box"])
def test_plain_apply_matches_oracle(ref, msh_dir, kind):
    """Against the dense element-matrix oracle (non-circular: no shared
    operator code)."""
    k = _apply_case(ref, msh_dir, kind, 3, seed=7)
    mats = ref.oracle.element_stiffness_matrices(k.fmesh)
    y_ref = ref.oracle.apply_elementwise(mats, k.fmesh.dofmap, k.c1, k.x1,
                                         k.mesh.ndofs)
    y = ci.indexed(k.disc.stiffness_op(F64, "cpu", coeff=k.c1),
                   torch.as_tensor(k.x1))
    assert rel(y, y_ref) <= TOL


def _random_dofmap(n, cells=300, ndofs=9000, seed=2):
    """Overlapping cells with their local ids in random order (the JAX
    package's fused-engine test, at any degree), a random G whose six
    components all differ and a random D, so that an axis swap shows."""
    rng = np.random.default_rng(seed)
    n3 = n ** 3
    dm = np.zeros((cells, n3), np.int64)
    for c in range(cells):
        dm[c] = min(c * 28, ndofs - n3 - 1) + rng.permutation(n3)
    return dm, ndofs, rng.standard_normal((cells, n3, 6)), \
        rng.standard_normal((n, n)), rng


@pytest.mark.parametrize("kind", ["random", "cylinder"])
@pytest.mark.parametrize("P", [2, 3, 4])
def test_plain_apply_matches_fused_interpret(ref, msh_dir, kind, P):
    """The three modes of the fused Pallas engine (`fused_apply` plain and
    coeff, `fused_apply_pair`) in interpret mode, rel-max <= 1e-12."""
    jnp, pg = ref.jnp, ref.pg
    if kind == "random":
        dm, ndofs, G, D, rng = _random_dofmap(P + 1, seed=P)
    else:
        mesh, _ = _meshes(ref, msh_dir, "cylinder", P)
        dm, ndofs = mesh.dofmap.astype(np.int64), mesh.ndofs
        disc = Discretization(mesh)
        G, D, rng = disc._G_host, disc._D_host, np.random.default_rng(P)
    cells = dm.shape[0]
    x1, x2 = rng.standard_normal(ndofs), rng.standard_normal(ndofs)
    c1, c2 = rng.standard_normal(cells), rng.standard_normal(cells)
    fe = pg.build_fused_engine(dm, ndofs, G, D, jnp.float64)
    assert fe is not None
    j, t = jnp.asarray, torch.as_tensor
    mesh = SimpleNamespace(dofmap=dm, ndofs=ndofs, num_cells=cells)
    y = ci.indexed(ci.build(mesh, G, D, F64, "cpu"), t(x1))
    assert rel_max(y, pg.fused_apply(j(x1), None, fe, ndofs,
                                     interpret=True)) <= TOL
    y = ci.indexed(ci.build(mesh, G, D, F64, "cpu", coeff=c1), t(x1))
    assert rel_max(y, pg.fused_apply(j(x1), j(c1), fe, ndofs,
                                     interpret=True)) <= TOL
    y = ci.indexed_pair(ci.build(mesh, G, D, F64, "cpu", pair=(c1, c2)),
                        t(x1), t(x2))
    assert rel_max(y, pg.fused_apply_pair(j(x1), j(c1), j(x2), j(c2), fe,
                                          ndofs, interpret=True)) <= TOL


@pytest.mark.parametrize("kind", ["random", "cylinder", "box", "bodyfit"])
def test_scatter_classes_cover_and_separate(ref, msh_dir, kind):
    """At P = 2..4 (the bodyfit bowl at its P = 2): every cell lies in
    exactly one class, no two cells of a class share a dof, each class is
    in ascending order, and a rebuild gives the same operator."""
    for P in ([2] if kind == "bodyfit" else [2, 3, 4]):
        if kind == "random":
            dm, ndofs = _random_dofmap(P + 1, seed=P)[:2]
        else:
            mesh = _meshes(ref, msh_dir, kind, P)[0]
            dm, ndofs = mesh.dofmap, mesh.ndofs
        cells, bounds = ci.scatter_classes(dm, ndofs)
        assert bounds[0] == 0 and bounds[-1] == dm.shape[0]
        assert np.array_equal(np.sort(cells), np.arange(dm.shape[0]))
        # an interior vertex of a hex mesh lies in 8 cells
        assert kind == "random" or len(bounds) - 1 >= 8
        for a, b in zip(bounds[:-1], bounds[1:]):
            cls = cells[a:b]
            assert np.all(np.diff(cls) > 0)
            ids = np.asarray(dm)[cls].reshape(-1)
            assert np.unique(ids).size == ids.size
        again = ci.scatter_classes(dm, ndofs)
        assert np.array_equal(again[0], cells) and again[1] == bounds
    if kind != "random":
        disc = Discretization(mesh)
        op1, op2 = (disc.stiffness_op(F64, "cpu"),
                    Discretization(mesh).stiffness_op(F64, "cpu"))
        for name in ("G", "D", "dofmap"):
            assert torch.equal(getattr(op1, name), getattr(op2, name))
        assert np.array_equal(op1.plan.classes[0], op2.plan.classes[0])
        assert op1.plan.classes[1] == op2.plan.classes[1]


def test_scatter_classes_refuse_shared_dofs(monkeypatch):
    """The host build refuses a colouring whose class shares a dof (the
    kernel's plain y += would race there)."""
    dm = np.array([[0, 1, 2], [2, 3, 4], [5, 6, 7]])
    assert ci.scatter_classes(dm, 8)[1] == (0, 2, 3)
    monkeypatch.setattr(ci, "colour_cells",
                        lambda d, n: np.zeros(len(d), np.int64))
    with pytest.raises(RuntimeError, match="shares a dof"):
        ci.scatter_classes(dm, 8)


# ---------------------------------------------------------------------------
# The chunk kernel's tables and schedule (ops/cuda_indexed.py)
# ---------------------------------------------------------------------------

def _check_chunk_schedule(plan, P, itemsize, pair, cpb=None, sms=132,
                          occupancy=cs.model_occupancy):
    dm, nnn = plan.dofmap, (P + 1) ** 3
    cells = dm.shape[0]
    sched = ci.chunk_schedule(plan, P, itemsize, sms, pair, occupancy, cpb)
    tab = plan.tables(sched.cpb)
    # shared memory: the kernel's layout at the fullest chunk, within one
    # block's limit
    stage, smem = ci.chunk_smem(P, itemsize, sched.cpb, sched.maxu, pair)
    assert (sched.stage_bytes, sched.smem) == (stage, smem)
    static = -(-(P + 1) ** 2 * itemsize // 128) * 128
    assert sched.smem + static <= 232_448 and sched.stages >= 2
    assert 1 <= sched.cpb and (P + 1) ** 2 * sched.cpb <= 256
    assert sched.maxu == tab.nu.max() <= sched.cpb * nnn
    ch = sched.chunks
    assert ch.dtype == np.int64 and ch.shape[1] == 6
    assert sched.classes[:, 1].sum() == len(ch) == tab.cell0.size
    assert (sched.classes[1:, 0] == np.cumsum(sched.classes[:, 1])[:-1]).all()
    # every cell once
    covered = np.zeros(cells, np.int64)
    for c0, m, *_ in ch:
        assert 1 <= m <= sched.cpb
        covered[c0:c0 + m] += 1
    assert (covered == 1).all()
    # the tables: each chunk's unique dofs ascending and its own, its
    # inverse map a permutation of its (cell, node) entries grouped by
    # unique dof, ascending within each
    for c0, m, _, _, u0, nu in ch:
        uq = tab.uniq[u0:u0 + nu]
        assert (np.diff(uq) > 0).all()
        assert np.array_equal(uq, np.unique(dm[c0:c0 + m]))
        ends = tab.ends[u0:u0 + nu].astype(np.int64)
        assert ends[-1] == m * nnn and (np.diff(ends) > 0).all()
        pos = tab.pos[c0 * nnn:(c0 + m) * nnn].astype(np.int64)
        assert np.array_equal(np.sort(pos), np.arange(m * nnn))
        start = np.concatenate([[0], ends[:-1]])
        for s in range(nu):
            run = pos[start[s]:ends[s]]
            assert (np.diff(run) > 0).all()
            assert (dm[c0:c0 + m].reshape(-1)[run] == uq[s]).all()
    # no two chunks of a class share a dof
    for first, count in sched.classes:
        seen = np.zeros(plan.ndofs, np.int64)
        for c0, m, *_ in ch[first:first + count]:
            seen[np.unique(dm[c0:c0 + m])] += 1
        assert seen.max() <= 1
    # bulk-copy spans, as the pencil kernel's
    cb = 6 * nnn * itemsize
    total = cells * cb
    start, end = ch[:, 0] * cb, (ch[:, 0] + ch[:, 1]) * cb
    off, nbytes = ch[:, 2], ch[:, 3]
    assert (off % 16 == 0).all() and (nbytes % 16 == 0).all()
    assert (off >= 0).all() and (off + nbytes <= total).all()
    assert (off <= start).all() and (start - off < 16).all()
    short = end - (off + nbytes)
    assert ((short <= 0) | ((end == total) & (short < 16))).all()
    assert (start - off + ch[:, 1] * cb <= sched.stage_bytes).all()
    return sched


@pytest.mark.parametrize("kind", ["structured", "cylinder", "perturbed"])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("P", range(2, 11))
def test_chunk_schedule(tmp_path, P, itemsize, kind):
    """For the single and the pair kernel, with the model's cells a chunk
    and with one cell a chunk: every cell once; the chunk tables
    consistent (each chunk's unique dofs its own, positions in range, the
    inverse map a permutation of the chunk's (cell, node) entries); no two
    chunks of a class share a dof; a block's shared bytes within the
    card's 232,448; every bulk-copy span 16 B-aligned, inside G, and
    covering its chunk's run of G.  On a structured footprint (a box in
    `locality_order`), the imported non-prismatic cylinder and a perturbed
    box through a .msh file."""
    if kind == "structured":
        mesh = un.locality_order(un.from_box(build_box_mesh((3, 3, 4), P)))
    elif kind == "cylinder":
        v, c, t = shapes.cylinder_mesh(nz=3 if P <= 6 else 2, **CYL)
        mesh = msh_io.read_msh(msh_io.write_msh(str(tmp_path / "c"), v, c,
                                                t), P, detect_extrusion=False)
    else:
        um = un.from_box(build_box_mesh((3, 2, 4) if P <= 4 else (2, 2, 2),
                                        P, perturb=0.2, seed=3),
                         shuffle_seed=11)
        mesh = msh_io.read_msh(msh_io.write_msh(str(tmp_path / "p"),
                                                um.vertices, um.cells), P)
    plan = ci.ChunkPlan(mesh.dofmap, mesh.ndofs)
    for pair in (False, True):
        _check_chunk_schedule(plan, P, itemsize, pair)
        assert _check_chunk_schedule(plan, P, itemsize, pair, cpb=1).cpb == 1


def test_chunk_schedule_on_the_bodyfit_bowl(ref, msh_dir):
    """The small bodyfit bowl (P = 2): the schedule's invariants, its
    classes hold several chunks a block on a small card, and a rebuilt
    plan gives the same tables."""
    mesh = _meshes(ref, msh_dir, "bodyfit", 2)[0]
    plan = ci.ChunkPlan(mesh.dofmap, mesh.ndofs)
    sched = _check_chunk_schedule(plan, 2, 4, False, sms=1)
    assert sched.classes[:, 1].max() > sched.blocks
    again = ci.ChunkPlan(mesh.dofmap, mesh.ndofs).tables(sched.cpb)
    for name in ci.ChunkTables._fields:
        assert np.array_equal(getattr(again, name),
                              getattr(plan.tables(sched.cpb), name))


def _chunk_emulate(op, sched, x1, x2=None):
    """Float64 torch emulation of the chunk kernel on `op` under `sched`,
    through its tables: class by class, each chunk's u from its unique
    dofs' x through the inverse map (for the pair c1 x1 + c2 x2 with each
    position's cell's c), each cell's node sums, then each unique dof's
    positions summed in the inverse map's order and added to y once."""
    P, n = op.P, op.P + 1
    nnn = n ** 3
    tab = op.plan.tables(sched.cpb)
    y = torch.zeros_like(x1)
    for first, count in sched.classes:
        for c0, m, _, _, u0, nu in sched.chunks[first:first + count]:
            ends = tab.ends[u0:u0 + nu].astype(np.int64)
            pos = torch.as_tensor(tab.pos[c0 * nnn:(c0 + m) * nnn]
                                  .astype(np.int64))
            ids = torch.as_tensor(tab.uniq[u0:u0 + nu].astype(np.int64))
            slot = torch.as_tensor(np.repeat(np.arange(nu), np.diff(
                np.concatenate([[0], ends]))))
            cell = pos // nnn + c0
            u = torch.empty(m * nnn, dtype=x1.dtype)
            if x2 is None:
                u[pos] = x1[ids[slot]]
            else:
                u[pos] = (op.C[cell, 0] * x1[ids[slot]]
                          + op.C[cell, 1] * x2[ids[slot]])
            out = idx._indexed_contract(
                u.reshape(m, n, n, n), op.G[c0:c0 + m].transpose(0, 1), None,
                op.D).reshape(-1)
            acc = torch.zeros(nu, dtype=x1.dtype)
            start = np.concatenate([[0], ends[:-1]])
            for r in range(int((ends - start).max())):
                has = torch.as_tensor(start + r < ends)
                at = torch.as_tensor(np.minimum(start + r, ends - 1))
                acc += torch.where(has, out[pos[at]], 0.0)
            y[ids] += acc
    return y


@pytest.mark.parametrize("small_card", [False, True])
@pytest.mark.parametrize("kind", ["random", "cylinder"])
@pytest.mark.parametrize("P", [2, 3, 4])
def test_chunk_order_matches_fused_interpret(ref, msh_dir, kind, P,
                                             small_card):
    """The chunk kernel's schedule, emulated in float64 through its tables
    (classes, chunks, unique dofs, inverse map and its order of adds),
    against the JAX package's fused Pallas engine in interpret mode
    (`fused_apply` with a coefficient, `fused_apply_pair`), rel-max <=
    1e-12: with the model's schedule on a card of 132 SMs, and on a card
    that holds one block of 2 cells (several chunks a block)."""
    jnp, pg = ref.jnp, ref.pg
    if kind == "random":
        dm, ndofs, G, D, rng = _random_dofmap(P + 1, seed=P)
    else:
        mesh, _ = _meshes(ref, msh_dir, "cylinder", P)
        dm, ndofs = mesh.dofmap.astype(np.int64), mesh.ndofs
        disc = Discretization(mesh)
        G, D, rng = disc._G_host, disc._D_host, np.random.default_rng(P)
    cells = dm.shape[0]
    x1, x2 = rng.standard_normal(ndofs), rng.standard_normal(ndofs)
    c1, c2 = rng.standard_normal(cells), rng.standard_normal(cells)
    fe = pg.build_fused_engine(dm, ndofs, G, D, jnp.float64)
    j, t = jnp.asarray, torch.as_tensor
    mesh = SimpleNamespace(dofmap=dm, ndofs=ndofs, num_cells=cells)
    op = ci.build(mesh, G, D, F64, "cpu", coeff=c1)
    if small_card:
        sched = ci.chunk_schedule(op.plan, P, 8, sms=1,
                                  occupancy=lambda *a: int(a[3] == 2))
        assert sched.cpb == 2 and sched.blocks == 1
    else:
        sched = ci.chunk_schedule(op.plan, P, 8, sms=132)
    assert rel_max(_chunk_emulate(op, sched, t(x1)),
                   pg.fused_apply(j(x1), j(c1), fe, ndofs,
                                  interpret=True)) <= TOL
    pop = ci.build(mesh, G, D, F64, "cpu", pair=(c1, c2), plan=op.plan)
    assert rel_max(_chunk_emulate(pop, sched, t(x1), t(x2)),
                   pg.fused_apply_pair(j(x1), j(c1), j(x2), j(c2), fe,
                                       ndofs, interpret=True)) <= TOL


def test_convert_matches_own_build(ref, msh_dir):
    """stiffness_from_fustpu of the `indexed_op` arrays and of a
    FusedEngine gives the port's own operator data, chunk tables and
    apply; no launch on CPU tensors."""
    jnp, pg = ref.jnp, ref.pg
    k = _apply_case(ref, msh_dir, "cylinder", 3, seed=3)
    mesh, fd = k.mesh, k.fdisc
    a = np.asarray
    G, dm, D = (a(v) for v in fd.indexed_op)
    fe = pg.build_fused_engine(a(mesh.dofmap), mesh.ndofs, fd._G_host,
                               fd._D_host, jnp.float64)
    layouts = [dict(G=G, D=D, dofmap=dm),
               dict(G=a(fe.G6p), D3p=a(fe.D3p), dofmap=mesh.dofmap)]
    own = k.disc.stiffness_op(F64, "cpu", coeff=k.c1)
    own_pair = k.disc.stiffness_op(F64, "cpu", pair=(k.c1, k.c2))
    x1, x2 = torch.as_tensor(k.x1), torch.as_tensor(k.x2)
    ci.reset_launches()
    for kw in layouts:
        op = convert.stiffness_from_fustpu(nc=None, coeff_e=k.c1,
                                           **kw).to_device(F64, "cpu", mesh)
        assert rel(op.G, own.G) <= TOL and rel(op.D, own.D) <= TOL
        assert torch.equal(op.dofmap, own.dofmap)
        for cpb in (1, 3):
            mine, theirs = op.plan.tables(cpb), own.plan.tables(cpb)
            for name in ci.ChunkTables._fields:
                assert np.array_equal(getattr(mine, name),
                                      getattr(theirs, name)), name
        assert rel(ci.indexed(op, x1), ci.indexed(own, x1)) <= TOL
        op = convert.stiffness_from_fustpu(
            nc=None, c1_e=k.c1, c2_e=k.c2, **kw).to_device(F64, "cpu", mesh)
        assert rel(op.G, own_pair.G) <= TOL and rel(op.C, own_pair.C) == 0.0
        assert rel(ci.indexed_pair(op, x1, x2),
                   ci.indexed_pair(own_pair, x1, x2)) <= TOL
    assert ci.launches == {"indexed": 0, "indexed_pair": 0}


# ---------------------------------------------------------------------------
# Models on the imported cylinder and the small bodyfit bowl
# ---------------------------------------------------------------------------

MODELS = ["linear_uniform", "linear_two_layer", "westervelt_uniform",
          "westervelt_two_layer"]
CASES = ([("cylinder", n, "indexed") for n in MODELS]
         + [("bodyfit", n, "indexed") for n in MODELS]
         + [("cylinder", "westervelt_two_layer", "indexed_engine")])


def _material(name, mesh, kind):
    west = name.startswith("westervelt")
    kw = dict(nonlinearity=100.0, attenuation_dB=50.0) if west else {}
    if name.endswith("two_layer"):
        # a layer across the cylinder's axis, or the bowl's tissue layer
        axis, cut = (2, 0.01) if kind == "cylinder" else (0, 0.02)
        x = mesh.cell_corners_flat.mean(axis=1)[:, axis]
        kw.update(sound_speed=np.where(x < cut, 1500.0, 1650.0),
                  density=np.where(x < cut, 1000.0, 1050.0))
    else:
        kw.update(sound_speed=1500.0, density=1000.0)
    return Material(**kw)


_REFERENCES = {}


def _model_reference(ref, directory, kind, name, impl):
    """The JAX model (float64), its dt, a seeded initial state and its
    10-step run (cached)."""
    key = (directory, kind, name, impl)
    if key not in _REFERENCES:
        jnp = ref.jnp
        mesh, fmesh = _meshes(ref, directory, kind, 3 if kind == "cylinder"
                              else 2)
        mat = _material(name, mesh, kind)
        fmat = ref.config.Material(
            sound_speed=mat.sound_speed, density=mat.density,
            nonlinearity=mat.nonlinearity,
            attenuation_dB=mat.attenuation_dB)
        src = Source(frequency=0.5e6, amplitude=1e5)
        fsrc = ref.config.Source(frequency=0.5e6, amplitude=1e5)
        fcls = ref.FWest if name.startswith("westervelt") else ref.FLinear
        fmodel = fcls(fmesh, fmat, fsrc, fmesh.boundary_facets(1),
                      fmesh.boundary_facets(2), dtype=jnp.float64,
                      stiffness_impl=impl)
        assert fmodel.impl == impl
        assert (getattr(fmodel, "_idx_fused", None) is not None) == \
            (impl == "indexed_engine")
        dt, _ = fmodel.cfl_dt()
        rng = np.random.default_rng(0)
        u0 = rng.standard_normal(mesh.ndofs)
        v0 = rng.standard_normal(mesh.ndofs)
        s0 = fmodel.init_state(0.0, u0=u0, v0=v0)
        out, _ = fmodel.solve(s0, dt, STEPS)
        _REFERENCES[key] = SimpleNamespace(
            mesh=mesh, mat=mat, src=src, fmodel=fmodel, dt=dt, u0=u0,
            v0=v0, s0=s0, out=out)
    return _REFERENCES[key]


def _port_class(name):
    return WesterveltModel if name.startswith("westervelt") \
        else LinearWaveModel


@pytest.mark.parametrize("kind,name,impl", CASES)
def test_model_matches_fustpu(ref, msh_dir, kind, name, impl):
    r = _model_reference(ref, str(msh_dir), kind, name, impl)
    mesh, jnp = r.mesh, ref.jnp
    model = _port_class(name)(mesh, r.mat, r.src, mesh.boundary_facets(1),
                              mesh.boundary_facets(2), dtype=F64,
                              device="cpu")
    assert model.impl == "mm" and isinstance(model.stiffness,
                                             IndexedStiffness)
    assert model.stiffness.is_pair == (name == "westervelt_two_layer")
    assert model.cfl_dt() == r.fmodel.cfl_dt()
    rng = np.random.default_rng(1)
    u, v = rng.standard_normal(mesh.ndofs), rng.standard_normal(mesh.ndofs)
    for t in (1.3e-7, 9.5e-6):
        want = r.fmodel.rhs(jnp.asarray(t), jnp.asarray(u), jnp.asarray(v))
        got = model.rhs(t, torch.as_tensor(u), torch.as_tensor(v))
        assert rel(got, want) <= MODEL_TOL
    out, _ = model.solve(model.init_state(0.0, u0=r.u0, v0=r.v0), r.dt, STEPS)
    assert out.t == pytest.approx(float(r.out.t), rel=1e-15)
    assert rel(out.u, r.out.u) <= MODEL_TOL
    assert rel(out.v, r.out.v) <= MODEL_TOL


def _np_params(fmodel):
    """The JAX model's params as numpy arrays, the stiffness as the keyword
    arrays of convert.stiffness_from_fustpu."""
    p = fmodel.params
    a = np.asarray
    out = {k: a(v) for k, v in p.items() if k not in ("stiff", "fused")}
    if "fused" in p:
        out["stiff"] = None
        out["fused"] = dict(G=a(p["fused"].G6p), D3p=a(p["fused"].D3p))
    else:
        G, dm, D = p["stiff"]
        out["stiff"] = dict(G=a(G), dofmap=a(dm), D=a(D))
    return out


@pytest.mark.parametrize("kind,name,impl", CASES)
def test_model_from_fustpu_trajectory_matches(ref, msh_dir, kind, name,
                                              impl):
    """A port model built from the JAX model's params (the indexed or the
    fused-engine layout) runs the same trajectory."""
    r = _model_reference(ref, str(msh_dir), kind, name, impl)
    state = tuple(np.asarray(x) for x in r.s0[:4]) + (float(r.s0.t),)
    model, st = convert.model_from_fustpu(
        _port_class(name), _np_params(r.fmodel), state, mesh=r.mesh,
        material=r.mat, source=r.src,
        source_facets=r.mesh.boundary_facets(1), dtype=F64, device="cpu")
    assert isinstance(model.stiffness, IndexedStiffness)
    out, _ = model.solve(st, r.dt, STEPS)
    assert rel(out.u, r.out.u) <= MODEL_TOL
    assert rel(out.v, r.out.v) <= MODEL_TOL


@pytest.mark.parametrize("device,resolved", [("cuda", "cuda"),
                                             ("cpu", "mm")])
def test_auto_resolves_on_a_general_mesh(device, resolved):
    """'auto' on a non-prismatic mesh is the kernel on a CUDA device (its
    module holds the kernel layout) and the plain version on the CPU."""
    um = un.from_box(build_box_mesh((2, 2, 2), 2, perturb=0.2, seed=4))
    assert resolve_stiffness_impl("auto", device) == resolved
    module = IndexedStiffness(Discretization(um).stiffness_op(F64, "cpu"),
                              resolved)
    assert hasattr(module, "G") == (resolved == "cuda")
    assert hasattr(module, "plain_G") == (resolved == "mm")
    if device == "cpu":
        model = LinearWaveModel(um, Material(), Source(),
                                np.zeros((0, 2), int), None, dtype=F64,
                                device=device)
        assert model.impl == "mm"
        assert isinstance(model.stiffness, IndexedStiffness)


def test_bodyfit_bowl_matches_fustpu(ref, msh_dir):
    """A few float64 steps of the small bodyfit Westervelt bowl: the port's
    demo and the JAX package's model on its own import give the same u at
    the focus."""
    jnp = ref.jnp
    model, dt, _, focus = nonlinear_bowl.build(
        nonlinear_bowl.parser().parse_args(BOWL))
    fmesh = _bodyfit(ref, msh_dir)[1]
    mat = ref.config.Material(sound_speed=1480.0, density=1000.0,
                              nonlinearity=3.5, attenuation_dB=0.2)
    fsrc = ref.config.Source(frequency=1.1e6,
                             amplitude=model.source.amplitude)
    fmodel = ref.FWest(fmesh, mat, fsrc, fmesh.boundary_facets(1),
                       fmesh.boundary_facets(2), dtype=jnp.float64)
    assert fmodel.impl == "indexed"
    assert fmodel.cfl_dt(0.4)[0] == dt
    steps = 40
    fout, _ = fmodel.solve(fmodel.init_state(), dt, steps)
    want = float(fmesh.evaluate(np.asarray(fout.u), focus[None, :])[0])
    state, _ = model.solve(model.init_state(), dt, steps)
    got = nonlinear_bowl.focal_pressure(model, state, focus)
    assert want != 0.0
    assert abs(got - want) <= 1e-11 * abs(want)


def test_bodyfit_demo_cli():
    cmd = [sys.executable, "-m", "fustpu_torch.demos.nonlinear_bowl",
           *BOWL, "--periods", "0.2", "--progress-every", "60"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "imported, general (non-prismatic)" in out.stdout
    assert re.search(r"indexed scatter: \d+ colour classes", out.stdout)
    m = re.search(r"pressure at focus: (\S+) Pa", out.stdout)
    assert m and np.isfinite(float(m.group(1))) and float(m.group(1)) != 0.0


def test_exp_imported_demo_on_cpu(capsys):
    """The exp_imported demo at a small size on the CPU (16 elements,
    P = 2, no P = 6 bowl): the imported and bodyfit bowls, every form's
    results equal to the plain version (on the CPU each wrapper runs it),
    and the CPU named as the clock; then with --corner --hex27 the corner
    forms of the imported bowl as hex8 and as hex27, the class-launch
    design and the walk each equal to the plain version."""
    from fustpu_torch.demos import exp_imported

    out = exp_imported.main(["--device", "cpu", "--elements", "16",
                             "--degree", "2", "--p6-elements", "0",
                             "--chain", "1", "--reps", "1"])
    assert set(out) == {"#6", "#11"}
    assert set(out["#6"]) == set(out["#11"]) == {"single", "pair"}
    for label, forms in out.items():
        for f in forms.values():
            assert all(rel(y, f["plain"]) <= TOL for y in f["ys"].values())
            assert f["nbytes"] > f["op"].G.numel() * 4
    assert set(out["#11"]["single"]["ys"]) == {"classes", "chunks",
                                                "engine"}
    assert capsys.readouterr().out.count("host clock on the CPU") == 1
    out = exp_imported.main(["--device", "cpu", "--elements", "16",
                             "--degree", "2", "--chain", "1", "--reps", "1",
                             "--corner", "--hex27"])
    assert set(out) == {"#6c hex8", "#6c hex27"}
    for label, forms in out.items():
        assert set(forms) == {"single", "pair"}
        for f in forms.values():
            assert set(f["ys"]) == {"classes", "walk"}
            assert all(rel(y, f["plain"]) <= TOL for y in f["ys"].values())
            assert f["op"].T.shape[1] == (163 if "27" in label else 37)
            assert f["nbytes"] > f["op"].T.numel() * 4 and f["flops"] > 0
    assert capsys.readouterr().out.count("host clock on the CPU") == 1


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("P", range(2, 11))
def test_kernels_match_plain_on_card(tmp_path, P):
    """Indexed CUDA kernels vs the plain version on the card (float64 to
    1e-12, float32 to 1e-5 against the float64 plain version), single with
    and without a coefficient and pair, on the imported non-prismatic
    cylinder and on overlapping random cells with a random G and D; a
    repeated apply is bitwise identical (the colour-ordered scatter)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    v, c, t = shapes.cylinder_mesh(nz=3 if P <= 6 else 2, **CYL)
    cyl = msh_io.read_msh(msh_io.write_msh(str(tmp_path / "c"), v, c, t), P,
                          detect_extrusion=False)
    dm, ndofs, G_rand, D_rand, rng = _random_dofmap(P + 1, cells=120,
                                                    seed=P)
    disc = Discretization(cyl)
    meshes = [(cyl, disc._G_host, disc._D_host),
              (SimpleNamespace(dofmap=dm, ndofs=ndofs, num_cells=120),
               G_rand, D_rand)]
    before = dict(ci.launches)
    for mesh, G, D in meshes:
        c1 = rng.uniform(0.5, 2.0, mesh.num_cells)
        c2 = rng.uniform(-1.5, -0.5, mesh.num_cells)
        x1 = torch.as_tensor(rng.standard_normal(mesh.ndofs), device="cuda")
        x2 = torch.as_tensor(rng.standard_normal(mesh.ndofs), device="cuda")
        for kw in (dict(), dict(coeff=c1), dict(pair=(c1, c2))):
            pair = "pair" in kw
            run = (lambda op, a, b: ci.indexed_pair(op, a, b)) if pair \
                else (lambda op, a, b: ci.indexed(op, a))
            plain = (lambda op, a, b: ci.indexed_pair_plain(op, a, b)) \
                if pair else (lambda op, a, b: ci.indexed_plain(op, a))
            y_ref = plain(ci.build(mesh, G, D, F64, "cuda", **kw),
                          x1, x2).cpu()
            for dtype, tol in ((F64, TOL), (torch.float32, 1e-5)):
                op = ci.build(mesh, G, D, dtype, "cuda", **kw)
                y = run(op, x1.to(dtype), x2.to(dtype))
                torch.cuda.synchronize()
                assert rel(y.cpu(), y_ref) <= tol
                assert torch.equal(run(op, x1.to(dtype), x2.to(dtype)), y)
    assert ci.launches["indexed"] == before["indexed"] + 16
    assert ci.launches["indexed_pair"] == before["indexed_pair"] + 8


@pytest.mark.cuda
@pytest.mark.parametrize("P", range(2, 11))
def test_chunk_kernel_matches_plain_on_card(tmp_path, P):
    """The chunk kernels (`indexed`, `indexed_pair`) vs the plain version
    on the card, float64 to 1e-12 and float32 to 1e-6 against the float64
    plain version, two applies bitwise equal, and against the class-launch
    kernels to 1e-14 in float64; single with and without a coefficient and
    pair, on the imported non-prismatic cylinder, on overlapping random
    cells, on one cell (the bulk copy's span cut back at G's end) and on a
    long perturbed column (several chunks a class), there also with one
    cell a chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    v, c, t = shapes.cylinder_mesh(nz=3 if P <= 6 else 2, **CYL)
    cyl = msh_io.read_msh(msh_io.write_msh(str(tmp_path / "c"), v, c, t), P,
                          detect_extrusion=False)
    dm, ndofs, G_rand, D_rand, rng = _random_dofmap(P + 1, cells=120,
                                                    seed=P)
    column = un.from_box(build_box_mesh((1, 2, 29), P, perturb=0.2, seed=P))
    meshes = [(cyl, None), (SimpleNamespace(dofmap=dm, ndofs=ndofs,
                                            num_cells=120), (G_rand, D_rand)),
              (un.from_box(build_box_mesh((1, 1, 1), P)), None),
              (column, None), (column, "one cell a chunk")]
    before = dict(ci.launches)
    for mesh, extra in meshes:
        if isinstance(extra, tuple):
            G, D = extra
        else:
            disc = Discretization(mesh)
            G, D = disc._G_host, disc._D_host
        cpb = 1 if extra == "one cell a chunk" else None
        c1 = rng.uniform(0.5, 2.0, mesh.num_cells)
        c2 = rng.uniform(-1.5, -0.5, mesh.num_cells)
        x1 = torch.as_tensor(rng.standard_normal(mesh.ndofs), device="cuda")
        x2 = torch.as_tensor(rng.standard_normal(mesh.ndofs), device="cuda")
        for kw in (dict(), dict(coeff=c1), dict(pair=(c1, c2))):
            pair = "pair" in kw
            if pair:
                run = lambda op, a, b: ci.indexed_pair(op, a, b, cpb)
                old = ci.indexed_classes_pair
                plain = ci.indexed_pair_plain
            else:
                run = lambda op, a, b: ci.indexed(op, a, cpb)
                old = lambda op, a, b: ci.indexed_classes(op, a)
                plain = lambda op, a, b: ci.indexed_plain(op, a)
            y_ref = plain(ci.build(mesh, G, D, F64, "cuda", **kw),
                          x1, x2).cpu()
            for dtype, tol in ((F64, TOL), (torch.float32, 1e-6)):
                op = ci.build(mesh, G, D, dtype, "cuda", **kw)
                a, b = x1.to(dtype), x2.to(dtype)
                y = run(op, a, b)
                torch.cuda.synchronize()
                assert rel(y.cpu(), y_ref) <= tol, (mesh.num_cells, kw.keys())
                assert torch.equal(run(op, a, b), y)
                if dtype == F64:
                    assert rel(y.cpu(), old(op, a, b).cpu()) <= 1e-14
    assert ci.launches["indexed"] == before["indexed"] + 5 * 2 * 2 * 2
    assert ci.launches["indexed_pair"] == before["indexed_pair"] + 5 * 2 * 2
