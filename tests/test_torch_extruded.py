"""The port's imported-prismatic-mesh slice against the JAX package on the
CPU in float64: the vendored .msh import and extrusion detection, the host
setup on imported (and curved hex27) meshes, the plain extruded stiffness
apply against `operators.stiffness_apply_extruded`, the Pallas kernel in
interpret mode and the dense oracle, `convert` of the three extruded
operator layouts, the models (rhs, 10-step trajectories and probe traces)
on an imported cylinder, the imported bowl against the conformal one, and
the piston demo's CLI; and, on a card, the extruded CUDA kernels against
their plain version.

The JAX package is imported inside the fixtures that compare against it
(they skip where JAX is missing), so that the card tests also run on a
machine without JAX:

    python -m pytest --noconftest tests/test_torch_extruded.py -m cuda
"""

import dataclasses
import functools
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
from fustpu_torch.elements.hex import hex8_tabulate
from fustpu_torch.mesh import msh_io, shapes
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.mesh.extruded import ExtrudedHexMesh, as_extruded
from fustpu_torch.mesh.unstructured import UPointSampler, from_box
from fustpu_torch.models.discretization import (Discretization,
                                                ExtrudedStiffness,
                                                IndexedStiffness,
                                                resolve_stiffness_impl)
from fustpu_torch.models.linear import LinearWaveModel
from fustpu_torch.models.westervelt import WesterveltModel
from fustpu_torch.ops import cuda_extruded as ce
from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.ops import indexed as idx_ops
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


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules; skips where JAX is missing."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from fustpu import config as f_config
    from fustpu.elements import hex as f_hex
    from fustpu.mesh import box as f_box
    from fustpu.mesh import extruded as f_ext
    from fustpu.mesh import msh_io as f_msh
    from fustpu.mesh import unstructured as f_un
    from fustpu.models import discretization as f_disc
    from fustpu.models.linear import LinearWaveModel as FLinear
    from fustpu.models.westervelt import WesterveltModel as FWest
    from fustpu.ops import operators as f_ops
    from fustpu.ops import pallas_extruded as pex
    from fustpu.ops import precompute as f_pre
    from fustpu.oracle import assemble as oracle

    return SimpleNamespace(jax=jax, jnp=jnp, config=f_config, hex=f_hex,
                           box=f_box,
                           ext=f_ext, msh=f_msh, un=f_un, disc=f_disc,
                           FLinear=FLinear, FWest=FWest, ops=f_ops, pex=pex,
                           pre=f_pre, oracle=oracle)


@pytest.fixture(scope="module")
def msh_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("msh")


@functools.lru_cache(maxsize=None)
def _cyl_file(directory, nz):
    v, c, t = shapes.cylinder_mesh(nz=nz, **CYL)
    return msh_io.write_msh(str(Path(directory) / f"cyl{nz}"), v, c, t)


def _phi(x):
    """Prismatic curvature: the transverse shift depends on (x, y) only
    (vertex columns survive); layers curved and graded in z."""
    x = np.asarray(x, np.float64)
    out = x.copy()
    out[..., 0] = x[..., 0] + 0.04 * np.sin(1.3 * x[..., 1])
    out[..., 1] = x[..., 1] + 0.05 * np.sin(1.1 * x[..., 0] + 0.4)
    out[..., 2] = x[..., 2] * (1.0 + 0.1 * x[..., 2]) \
        + 0.06 * np.sin(1.7 * x[..., 0] + 0.5 * x[..., 1])
    return out


def _curved(um, tabulate):
    """The hex27 prism of `um` (either package's mesh) under _phi."""
    lat3 = np.array([[i / 2, j / 2, k / 2] for i in range(3)
                     for j in range(3) for k in range(3)])
    vals, _ = tabulate(lat3)                       # (27, 8)
    gl = np.einsum("qv,cvd->cqd", vals, um.vertices[um.cells])
    return dataclasses.replace(um, vertices=_phi(um.vertices),
                               geom_nodes=_phi(gl))


def _meshes(ref, directory, kind, P, nz=4):
    """(port mesh, JAX package mesh) of one kind, both extruded."""
    if kind == "cylinder":
        path = _cyl_file(str(directory), nz)
        return msh_io.read_msh(path, P), ref.msh.read_msh(path, P)
    um = from_box(build_box_mesh((3, 2, 4), P), shuffle_seed=11)
    fum = ref.un.from_box(ref.box.build_box_mesh((3, 2, 4), P),
                          shuffle_seed=11)
    if kind == "curved":
        um = _curved(um, hex8_tabulate)
        fum = _curved(fum, ref.hex.hex8_tabulate)
    return as_extruded(um), ref.ext.as_extruded(fum)


KINDS = ["cylinder", "box", "curved"]


@pytest.mark.parametrize("kind", KINDS)
def test_mesh_structure_matches(ref, msh_dir, kind):
    mesh, fmesh = _meshes(ref, msh_dir, kind, 3)
    assert isinstance(mesh, ExtrudedHexMesh)
    for name in ("cells", "stack_cells", "rows2d", "dofmap"):
        assert np.array_equal(getattr(mesh, name), getattr(fmesh, name))
    assert (mesh.n2d, mesh.nz, mesh.axis, mesh.ndofs) == \
        (fmesh.n2d, fmesh.nz, fmesh.axis, fmesh.ndofs)
    assert mesh.facet_tag_map.keys() == fmesh.facet_tag_map.keys()
    for tag in fmesh.facet_tag_map:
        assert np.array_equal(mesh.facet_tag_map[tag],
                              fmesh.facet_tag_map[tag])
    assert np.array_equal(mesh.boundary_facets(), fmesh.boundary_facets())
    assert rel(mesh.node_coords, fmesh.node_coords) <= SETUP_TOL
    assert (mesh.geom_nodes is None) == (kind != "curved")


def test_non_prismatic_mesh_is_not_extruded(ref, msh_dir):
    bm = build_box_mesh((3, 3, 3), 2, perturb=0.2, seed=4)
    assert as_extruded(from_box(bm)) is None
    # a non-prismatic import stays general, in the JAX package's cell
    # order (locality_order)
    um = from_box(bm)
    path = msh_io.write_msh(str(msh_dir / "perturbed"), um.vertices,
                            um.cells)
    imported = msh_io.read_msh(path, 2)
    assert not isinstance(imported, ExtrudedHexMesh)
    fimported = ref.msh.read_msh(path, 2)
    assert np.array_equal(imported.cells, fimported.cells)
    assert np.array_equal(imported.dofmap, fimported.dofmap)


@pytest.mark.parametrize("kind", KINDS)
def test_host_setup_matches(ref, msh_dir, kind):
    mesh, fmesh = _meshes(ref, msh_dir, kind, 3)
    assert rel(pre.cell_detJ(mesh), ref.pre.cell_detJ(fmesh)) <= SETUP_TOL
    dJ, G = pre.cell_geometry_factors(mesh)
    fdJ, fG = ref.pre.cell_geometry_factors(fmesh, use_native=False)
    assert rel(dJ, fdJ) <= SETUP_TOL and rel(G, fG) <= SETUP_TOL
    bd = mesh.boundary_facets(1) if kind == "cylinder" \
        else mesh.boundary_facets()
    assert rel(pre.facet_geometry_factors(mesh, bd),
               ref.pre.facet_geometry_factors(fmesh, bd, use_native=False)
               ) <= SETUP_TOL
    disc = Discretization(mesh)
    fdisc = ref.disc.Discretization(fmesh, ref.jnp.float64)
    coeff = np.random.default_rng(0).uniform(0.5, 2.0, mesh.num_cells)
    assert rel(disc.mass_diag_host(coeff),
               fdisc.mass_diag_host(coeff)) <= SETUP_TOL
    fcoeff = np.random.default_rng(1).uniform(0.5, 2.0, len(bd))
    assert rel(disc.facet_diag_host(disc.facet_block(bd), fcoeff),
               fdisc.facet_diag_host(fdisc.facet_block(bd), fcoeff)
               ) <= SETUP_TOL


def _apply_case(ref, directory, kind, P, seed=0):
    nz = 4 if P <= 4 else 2           # high degrees on a shallower stack
    mesh, fmesh = _meshes(ref, directory, kind, P, nz=nz)
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
    kernel-layout operator on CPU tensors (the plain version) against the
    JAX package's einsum path, P = 2..10."""
    jnp, ops = ref.jnp, ref.ops
    k = _apply_case(ref, msh_dir, "cylinder", P, seed=P)
    fop = k.fdisc.extruded_op
    x1, x2 = jnp.asarray(k.x1), jnp.asarray(k.x2)
    xe = lambda c: ops.expand_coeff_extruded(k.fmesh, c, jnp.float64)
    nd = k.mesh.ndofs
    ce.reset_launches()
    y = ce.extruded(k.disc.stiffness_op(F64, "cpu"), torch.as_tensor(k.x1))
    assert rel(y, ops.stiffness_apply_extruded(x1, fop, nd)) <= TOL
    y = ce.extruded(k.disc.stiffness_op(F64, "cpu", coeff=k.c1),
                    torch.as_tensor(k.x1))
    assert rel(y, ops.stiffness_apply_extruded(x1, fop, nd,
                                               coeff_e=xe(k.c1))) <= TOL
    y = ce.extruded_pair(k.disc.stiffness_op(F64, "cpu", pair=(k.c1, k.c2)),
                         torch.as_tensor(k.x1), torch.as_tensor(k.x2))
    assert rel(y, ops.stiffness_apply_extruded_pair(
        x1, x2, fop, nd, xe(k.c1), xe(k.c2))) <= TOL
    assert ce.launches == {"extruded": 0, "extruded_pair": 0}


@pytest.mark.parametrize("P", [2, 3, 4])
def test_plain_apply_matches_pallas_interpret(ref, msh_dir, P):
    jnp, pex = ref.jnp, ref.pex
    k = _apply_case(ref, msh_dir, "cylinder", P, seed=P)
    fd = k.fdisc
    fop = pex.build_extruded(k.fmesh, fd._G_host, fd._D_host, jnp.float64,
                             coeff=k.c1)
    y_ref = pex.stiffness_apply_extruded_pallas(
        jnp.asarray(k.x1), fop, k.mesh.ndofs, interpret=True,
        precision=pex._HI)
    y = ce.extruded(k.disc.stiffness_op(F64, "cpu", coeff=k.c1),
                    torch.as_tensor(k.x1))
    assert rel(y, y_ref) <= TOL
    if P == 3:
        fpair = pex.build_extruded_pair(k.fmesh, fd._G_host, fd._D_host,
                                        jnp.float64, k.c1, k.c2)
        ref2 = pex.stiffness_apply_extruded_pallas_pair(
            jnp.asarray(k.x1), jnp.asarray(k.x2), fpair, k.mesh.ndofs,
            interpret=True, precision=pex._HI)
        y2 = ce.extruded_pair(
            k.disc.stiffness_op(F64, "cpu", pair=(k.c1, k.c2)),
            torch.as_tensor(k.x1), torch.as_tensor(k.x2))
        assert rel(y2, ref2) <= TOL


@pytest.mark.parametrize("kind", ["box", "curved"])
def test_plain_apply_matches_oracle(ref, msh_dir, kind):
    """Against the dense element-matrix oracle on the shuffled box and the
    curved hex27 prism (non-circular: no shared operator code)."""
    k = _apply_case(ref, msh_dir, kind, 3, seed=7)
    mats = ref.oracle.element_stiffness_matrices(k.fmesh)
    y_ref = ref.oracle.apply_elementwise(mats, k.fmesh.dofmap, k.c1, k.x1,
                                         k.mesh.ndofs)
    y = ce.extruded(k.disc.stiffness_op(F64, "cpu", coeff=k.c1),
                    torch.as_tensor(k.x1))
    assert rel(y, y_ref) <= TOL


def test_convert_matches_own_build(ref, msh_dir):
    """stiffness_from_fustpu of the three JAX extruded layouts gives the
    port's own operator data, stack schedule and apply; no launch on CPU
    tensors."""
    jnp, ops, pex = ref.jnp, ref.ops, ref.pex
    k = _apply_case(ref, msh_dir, "cylinder", 3, seed=3)
    mesh, fmesh, fd = k.mesh, k.fmesh, k.fdisc
    nc = (mesh.nstacks, mesh.nz)
    a = lambda t: np.asarray(t)
    xe = lambda c: a(ops.expand_coeff_extruded(fmesh, c, jnp.float64))
    own = k.disc.stiffness_op(F64, "cpu", coeff=k.c1)
    own_pair = k.disc.stiffness_op(F64, "cpu", pair=(k.c1, k.c2))
    eo = fd.extruded_op
    pal = pex.build_extruded(fmesh, fd._G_host, fd._D_host, jnp.float64,
                             coeff=k.c1)
    ppair = pex.build_extruded_pair(fmesh, fd._G_host, fd._D_host,
                                    jnp.float64, k.c1, k.c2)
    single = [
        convert.stiffness_from_fustpu(a(eo.G6), nc, D=a(eo.D),
                                      rows=a(eo.rows), coeff_e=xe(k.c1)),
        convert.stiffness_from_fustpu(a(pal.Gt), nc, D=a(pal.statics[0]),
                                      rows=a(pal.rows))]
    pairs = [
        convert.stiffness_from_fustpu(a(eo.G6), nc, D=a(eo.D),
                                      rows=a(eo.rows), c1_e=xe(k.c1),
                                      c2_e=xe(k.c2)),
        convert.stiffness_from_fustpu(a(ppair.Gt), nc,
                                      D=a(ppair.statics[0]),
                                      rows=a(ppair.rows), C=a(ppair.ce))]
    ce.reset_launches()
    x1, x2 = torch.as_tensor(k.x1), torch.as_tensor(k.x2)

    def schedule(plan):
        return ce.stack_schedule(plan.colour, plan.rows2d, plan.nz, 3, 8,
                                 sms=132)

    mine = schedule(own.plan)
    for host in single + pairs:
        theirs = schedule(host.to_device(F64, "cpu", mesh).plan)
        for name in ("classes", "chunks", "ids"):
            assert np.array_equal(getattr(theirs, name), getattr(mine, name))
    for host in single:
        op = host.to_device(F64, "cpu", mesh)
        assert rel(op.G, own.G) <= TOL and rel(op.D, own.D) == 0.0
        assert rel(ce.extruded(op, x1), ce.extruded(own, x1)) <= TOL
    for host in pairs:
        op = host.to_device(F64, "cpu", mesh)
        assert rel(op.G, own_pair.G) <= TOL and rel(op.C, own_pair.C) == 0.0
        assert rel(ce.extruded_pair(op, x1, x2),
                   ce.extruded_pair(own_pair, x1, x2)) <= TOL
    assert ce.launches == {"extruded": 0, "extruded_pair": 0}


# ---------------------------------------------------------------------------
# The stack kernel's schedule (ops/cuda_extruded.py `stack_schedule`)
# ---------------------------------------------------------------------------

def _footprint(kind, P, directory=None):
    """An extruded mesh of the port alone: a structured footprint (a box,
    3 x 2 stacks of 7 layers) or an unstructured one (the imported
    cylinder, 4 layers)."""
    if kind == "structured":
        return as_extruded(from_box(build_box_mesh((3, 2, 7), P)))
    v, c, t = shapes.cylinder_mesh(nz=4, **CYL)
    return msh_io.read_msh(msh_io.write_msh(str(Path(directory) / "f"), v, c,
                                            t), P)


def _segments(sched, nz):
    """The schedule's segments by class: (segment index in table order,
    stack, first layer, end layer, table rows)."""
    seg = 0
    for first, count, per in sched.classes:
        out = []
        for u in range(count):
            rows = sched.chunks[first + u * per:first + (u + 1) * per]
            out.append((seg, rows[0, 0] // nz, rows[0, 0] % nz,
                        (rows[-1, 0] + rows[-1, 1] - 1) % nz + 1, rows))
            seg += 1
        yield out


def _check_stack_schedule(mesh, P, itemsize, pair, segments=None):
    n, nz = P + 1, mesh.nz
    ns = mesh.rows2d.shape[0]
    colour = ce.colour_stacks(mesh.rows2d)
    sched = ce.stack_schedule(colour, mesh.rows2d, nz, P, itemsize, sms=132,
                              pair=pair, segments=segments)
    stage, smem = cs.pencil_smem(P, itemsize, sched.cpb, pair, ids=True)
    assert (sched.stage_bytes, sched.smem) == (stage, smem)
    static = -(-n * n * itemsize // 128) * 128       # D, as ptxas rounds it
    assert sched.smem + static <= 232_448 and sched.stages >= 2
    assert 1 <= sched.cpb and n * n * sched.cpb <= 256
    ch = sched.chunks
    assert ch.dtype == np.int64 and ch.shape[1] == 5
    # every cell once; one chunk count a segment; classes start on a
    # segment; column 4 is the chunk's first layer times P
    covered = np.zeros(ns * nz, np.int64)
    for c0, m, *_ in ch:
        assert 1 <= m <= sched.cpb
        covered[c0:c0 + m] += 1
    assert (covered == 1).all()
    assert (ch[:, 4] == (ch[:, 0] % nz) * P).all()
    assert sum(int(u * r) for _, u, r in sched.classes) == len(ch)
    assert (sched.classes[1:, 0] == np.cumsum(
        sched.classes[:, 1] * sched.classes[:, 2])[:-1]).all()
    assert len(sched.ids) == sched.classes[:, 1].sum()
    # segments: consecutive layers of one stack, their row ids the stack's;
    # no two segments of a class share a dof
    gz = nz * P + 1
    for segs in _segments(sched, nz):
        seen = np.zeros(mesh.n2d * gz, np.int64)
        for seg, s, z0, z1, rows in segs:
            assert ((rows[:, 0] // nz) == s).all()
            assert (rows[1:, 0] == rows[:-1, 0] + rows[:-1, 1]).all()
            assert np.array_equal(sched.ids[seg], mesh.rows2d[s])
            dofs = (mesh.rows2d[s][:, None] * gz
                    + np.arange(z0 * P, z1 * P + 1)[None, :]).reshape(-1)
            seen[dofs] += 1
        assert seen.max() <= 1
    # bulk-copy spans, as the pencil kernel's
    cb = 6 * n ** 3 * itemsize
    total = ns * nz * cb
    start, end = ch[:, 0] * cb, (ch[:, 0] + ch[:, 1]) * cb
    off, nbytes = ch[:, 2], ch[:, 3]
    assert (off % 16 == 0).all() and (nbytes % 16 == 0).all()
    assert (off >= 0).all() and (off + nbytes <= total).all()
    assert (off <= start).all() and (start - off < 16).all()
    short = end - (off + nbytes)
    assert ((short <= 0) | ((end == total) & (short < 16))).all()
    assert (start - off + ch[:, 1] * cb <= sched.stage_bytes).all()
    return sched


@pytest.mark.parametrize("kind", ["structured", "unstructured"])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("P", range(2, 11))
def test_stack_schedule(tmp_path, P, itemsize, kind):
    """For the single and the pair kernel, with the model's segments and
    with stacks cut into 3: every cell once; no two segments of a class
    share a dof; each segment's row ids its stack's; a block's shared
    bytes within the card's 232,448; every bulk-copy span 16 B-aligned,
    inside G, and covering its chunk's run of G (short of it only at G's
    end, by less than 16 B)."""
    mesh = _footprint(kind, P, tmp_path)
    for pair in (False, True):
        _check_stack_schedule(mesh, P, itemsize, pair)
        s3 = _check_stack_schedule(mesh, P, itemsize, pair, segments=3)
        assert s3.segments == 3
        assert len(s3.classes) == 2 * (int(ce.colour_stacks(
            mesh.rows2d).max()) + 1)


# the H100's occupancy answers for the stack kernel at P = 4, float32
# (blocks an SM by cells a chunk, `fustpu_extruded_stack_occupancy`)
H100_STACK_BLOCKS = {1: 16, 2: 8, 3: 5, 4: 4, 5: 4, 6: 3, 7: 2, 8: 2, 9: 2,
                     10: 2}


def test_stack_schedule_follows_the_occupancy():
    """The cells a chunk and the segments follow the occupancy and the
    cost model: on the imported bowl's 1,600 stacks of 64 layers in 4
    colours (400 stacks a class) with the card's answers, 5 cells a chunk
    and whole stacks (the fastest of the schedules timed there), single
    and pair; a mesh of few stacks of many layers is cut into segments, so
    that its classes fill more of the card; the occupancy is asked once
    per cells a chunk, with the shared bytes of that shape."""
    card = lambda P, itemsize, pair, cpb, smem: H100_STACK_BLOCKS[cpb]
    colour = np.repeat(np.arange(4), 400)
    rows2d = np.zeros((1600, 25), np.int32)
    for pair in (False, True):
        bowl = ce.stack_schedule(colour, rows2d, 64, 4, 4, sms=132,
                                 pair=pair, occupancy=card)
        assert (bowl.cpb, bowl.segments, bowl.blocks_per_sm) == (5, 1, 4)
        assert bowl.classes[:, 1].tolist() == [400] * 4
        assert bowl.classes[:, 2].tolist() == [13] * 4
    few = ce.stack_schedule(np.zeros(8, np.int64),
                            np.zeros((8, 25), np.int32), 96, 4, 4, sms=132,
                            occupancy=card)
    assert few.segments > 2 and len(few.classes) == 2
    calls = []

    def occupancy(P, itemsize, pair, cpb, smem):
        calls.append((cpb, smem))
        return 2 if cpb == 3 else 0

    s = ce.stack_schedule(colour[:8], rows2d[:8], 7, 4, 8, sms=1, pair=True,
                          occupancy=occupancy)
    assert (s.cpb, s.blocks_per_sm, s.blocks) == (3, 2, 2)
    assert [int(r[1]) for r in s.chunks[:3]] == [3, 2, 2]
    assert calls == [(c, cs.pencil_smem(4, 8, c, True, ids=True)[1])
                     for c in range(1, 8)]


def _stack_emulate(op, sched, x1, x2=None):
    """Float64 torch emulation of the stack kernel on `op` under `sched`:
    each cell's contribution added into y class by class, chunk by chunk
    of each segment, even cells of a chunk, then odd, the nodes found
    through the schedule's row ids and layer column (a batch of one class,
    chunk and turn shares no dof, so its adds are exact)."""
    P, n, nz = op.P, op.P + 1, op.nz
    gz = nz * P + 1
    ids = torch.as_tensor(sched.ids, dtype=torch.long).reshape(-1, n, n)
    r = torch.arange(n)
    y = torch.zeros_like(x1)
    seg0 = 0
    for first, pencils, per in sched.classes:
        for q in range(per):
            rows = first + np.arange(pencils) * per + q
            for turn in (0, 1):
                picked = [(c, m) for m in rows
                          for c in range(int(sched.chunks[m, 0]) + turn,
                                         int(sched.chunks[m, 0]
                                             + sched.chunks[m, 1]), 2)]
                if not picked:
                    continue
                cells = torch.as_tensor([c for c, _ in picked])
                seg = torch.as_tensor([seg0 + (m - first) // per
                                       for _, m in picked])
                z = torch.as_tensor([int(sched.chunks[m, 4])
                                     + (c - int(sched.chunks[m, 0])) * P
                                     for c, m in picked])
                idx = (ids[seg][:, :, :, None] * gz
                       + (z[:, None, None, None] + r))  # (b, i, j, k)
                u = x1[idx]
                if x2 is not None:
                    cc = op.C[cells][:, :, None, None, None]
                    u = cc[:, 0] * u + cc[:, 1] * x2[idx]
                y.index_put_((idx,), idx_ops._indexed_contract(
                    u, op.G[cells].transpose(0, 1), None, op.D),
                    accumulate=True)
        seg0 += pencils
    return y


@pytest.mark.parametrize("segments", [None, 3])
@pytest.mark.parametrize("P", [2, 3, 4])
def test_stack_order_matches_pallas_interpret(ref, msh_dir, P, segments):
    """The stack kernel's schedule, emulated in float64 (its classes,
    segments, chunks and turns, its row ids), against the JAX package's
    Pallas kernel in interpret mode, single (with a coefficient) and pair,
    on the imported cylinder: with the model's schedule on a card of 132
    SMs, and with stacks cut into 3 segments on a card that holds one
    block of 2 cells (several chunks a segment)."""
    jnp, pex = ref.jnp, ref.pex
    k = _apply_case(ref, msh_dir, "cylinder", P, seed=P)
    fd, mesh = k.fdisc, k.mesh
    colour = ce.colour_stacks(mesh.rows2d)
    if segments:
        sched = ce.stack_schedule(colour, mesh.rows2d, mesh.nz, P, 8, sms=1,
                                  segments=segments,
                                  occupancy=lambda *a: int(a[3] == 2))
        assert sched.segments == 3 and sched.cpb == 2
    else:
        sched = ce.stack_schedule(colour, mesh.rows2d, mesh.nz, P, 8,
                                  sms=132)
    fop = pex.build_extruded(k.fmesh, fd._G_host, fd._D_host, jnp.float64,
                             coeff=k.c1)
    y_ref = pex.stiffness_apply_extruded_pallas(
        jnp.asarray(k.x1), fop, mesh.ndofs, interpret=True,
        precision=pex._HI)
    op = k.disc.stiffness_op(F64, "cpu", coeff=k.c1)
    assert rel(_stack_emulate(op, sched, torch.as_tensor(k.x1)), y_ref) <= TOL
    fpair = pex.build_extruded_pair(k.fmesh, fd._G_host, fd._D_host,
                                    jnp.float64, k.c1, k.c2)
    ref2 = pex.stiffness_apply_extruded_pallas_pair(
        jnp.asarray(k.x1), jnp.asarray(k.x2), fpair, mesh.ndofs,
        interpret=True, precision=pex._HI)
    pop = k.disc.stiffness_op(F64, "cpu", pair=(k.c1, k.c2))
    assert rel(_stack_emulate(pop, sched, torch.as_tensor(k.x1),
                              torch.as_tensor(k.x2)), ref2) <= TOL


# ---------------------------------------------------------------------------
# Models on the imported cylinder
# ---------------------------------------------------------------------------

MODELS = ["linear_uniform", "linear_two_layer", "westervelt_uniform",
          "westervelt_two_layer"]
PROBE_PTS = np.array([[0.0, 0.0, z] for z in (0.004, 0.01, 0.016)])


def _material(name, mesh):
    west = name.startswith("westervelt")
    kw = dict(nonlinearity=100.0, attenuation_dB=50.0) if west else {}
    if name.endswith("two_layer"):
        zc = mesh.cell_corners_flat.mean(axis=1)[:, 2]
        kw.update(sound_speed=np.where(zc < 0.01, 1500.0, 1650.0),
                  density=np.where(zc < 0.01, 1000.0, 1050.0))
    else:
        kw.update(sound_speed=1500.0, density=1000.0)
    return Material(**kw)


_REFERENCES = {}


def _model_reference(ref, directory, name, impl):
    """The JAX model on the imported cylinder (float64), its dt, a seeded
    initial state and its 10-step run with probe traces (cached)."""
    key = (directory, name, impl)
    if key not in _REFERENCES:
        _REFERENCES[key] = _run_reference(ref, directory, name, impl)
    return _REFERENCES[key]


def _run_reference(ref, directory, name, impl):
    jnp = ref.jnp
    mesh, fmesh = _meshes(ref, directory, "cylinder", 3)
    mat = _material(name, mesh)
    fmat = ref.config.Material(
        sound_speed=mat.sound_speed, density=mat.density,
        nonlinearity=mat.nonlinearity, attenuation_dB=mat.attenuation_dB)
    src = Source(frequency=0.5e6, amplitude=1e5)
    fsrc = ref.config.Source(frequency=0.5e6, amplitude=1e5)
    fcls = ref.FWest if name.startswith("westervelt") else ref.FLinear
    fmodel = fcls(fmesh, fmat, fsrc, fmesh.boundary_facets(1),
                  fmesh.boundary_facets(2), dtype=jnp.float64,
                  stiffness_impl=impl)
    assert fmodel.impl == impl
    dt, _ = fmodel.cfl_dt()
    rng = np.random.default_rng(0)
    u0 = rng.standard_normal(mesh.ndofs)
    v0 = rng.standard_normal(mesh.ndofs)
    s0 = fmodel.init_state(0.0, u0=u0, v0=v0)
    pfn = ref.un.UPointSampler(fmesh, PROBE_PTS).jax_probe()
    out, ys = fmodel.solve(s0, dt, STEPS, probe=lambda s: pfn(s.u))
    return SimpleNamespace(mesh=mesh, mat=mat, src=src, fmodel=fmodel,
                           dt=dt, u0=u0, v0=v0, s0=s0, out=out,
                           ys=np.asarray(ys))


def _port_class(name):
    return WesterveltModel if name.startswith("westervelt") \
        else LinearWaveModel


@pytest.mark.parametrize("name", MODELS)
def test_model_matches_fustpu(ref, msh_dir, name):
    r = _model_reference(ref, str(msh_dir), name, "extruded")
    mesh, jnp = r.mesh, ref.jnp
    model = _port_class(name)(mesh, r.mat, r.src, mesh.boundary_facets(1),
                              mesh.boundary_facets(2), dtype=F64,
                              device="cpu")
    assert model.impl == "mm" and isinstance(model.stiffness,
                                             ExtrudedStiffness)
    assert model.stiffness.is_pair == (name == "westervelt_two_layer")
    assert model.cfl_dt() == r.fmodel.cfl_dt()
    rng = np.random.default_rng(1)
    u, v = rng.standard_normal(mesh.ndofs), rng.standard_normal(mesh.ndofs)
    for t in (1.3e-7, 9.5e-6):
        want = r.fmodel.rhs(jnp.asarray(t), jnp.asarray(u), jnp.asarray(v))
        got = model.rhs(t, torch.as_tensor(u), torch.as_tensor(v))
        assert rel(got, want) <= MODEL_TOL
    probe = UPointSampler(mesh, PROBE_PTS).torch_probe("cpu")
    out, ys = model.solve(model.init_state(0.0, u0=r.u0, v0=r.v0), r.dt,
                          STEPS, probe=lambda s: probe(s.u))
    assert out.t == pytest.approx(float(r.out.t), rel=1e-15)
    assert rel(out.u, r.out.u) <= MODEL_TOL
    assert rel(out.v, r.out.v) <= MODEL_TOL
    assert ys.shape == (STEPS, len(PROBE_PTS))
    assert rel(ys, r.ys) <= MODEL_TOL


def _np_params(ref, fmodel):
    """The JAX model's params as numpy arrays, stiffness as the keyword
    arrays of convert.stiffness_from_fustpu."""
    p = fmodel.params
    out = {k: np.asarray(v) for k, v in p.items() if k != "stiff"}
    op = p["stiff"]
    a = np.asarray
    if isinstance(op, ref.ops.ExtrudedStiffness):
        out["stiff"] = dict(G=a(op.G6), D=a(op.D), rows=a(op.rows))
    else:
        out["stiff"] = dict(G=a(op.Gt), D=a(op.statics[0]), rows=a(op.rows))
        if isinstance(op, ref.pex.PallasExtrudedPair):
            out["stiff"]["C"] = a(op.ce)
    return out


@pytest.mark.parametrize("name,impl",
                         [(n, "extruded") for n in MODELS]
                         + [("westervelt_two_layer", "extruded_pallas")])
def test_model_from_fustpu_trajectory_matches(ref, msh_dir, name, impl):
    """A port model built from the JAX model's params (einsum-layout or
    fused-kernel-layout stiffness) runs the same trajectory."""
    r = _model_reference(ref, str(msh_dir), name, impl)
    state = tuple(np.asarray(x) for x in r.s0[:4]) + (float(r.s0.t),)
    model, st = convert.model_from_fustpu(
        _port_class(name), _np_params(ref, r.fmodel), state, mesh=r.mesh,
        material=r.mat, source=r.src,
        source_facets=r.mesh.boundary_facets(1), dtype=F64, device="cpu")
    assert isinstance(model.stiffness, ExtrudedStiffness)
    out, _ = model.solve(st, r.dt, STEPS)
    assert rel(out.u, r.out.u) <= MODEL_TOL
    assert rel(out.v, r.out.v) <= MODEL_TOL


def test_imported_bowl_matches_conformal():
    """The same discrete problem under two numberings: the conformal bowl
    and its .msh round trip (extruded along x) give the same focal u."""
    runs = {}
    for geometry in ("conformal", "unstructured"):
        args = nonlinear_bowl.parser().parse_args(
            ["--device", "cpu", "--dtype", "f64", "--elements", "16",
             "--degree", "2", "--geometry", geometry])
        model, dt, _, focus = nonlinear_bowl.build(args)
        state, _ = model.solve(model.init_state(), dt, 100)
        runs[geometry] = nonlinear_bowl.focal_pressure(model, state, focus)
    mesh = model.mesh
    assert isinstance(mesh, ExtrudedHexMesh) and mesh.axis == 0
    assert (mesh.nstacks, mesh.nz) == (64, 16)
    assert runs["conformal"] != 0.0
    assert abs(runs["unstructured"] - runs["conformal"]) <= \
        1e-10 * abs(runs["conformal"])


def test_piston_demo_cli():
    cmd = [sys.executable, "-m", "fustpu_torch.demos.linear_piston",
           "--device", "cpu", "--dtype", "f64", "--degree", "2",
           "--periods", "0.2", "--progress-every", "40"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "stiffness impl: mm (ExtrudedStiffness)" in out.stdout
    assert "Solve time per step" in out.stdout
    m = re.search(r"max on-axis deviation vs O'Neil: (\S+)%", out.stdout)
    assert m and np.isfinite(float(m.group(1)))
    assert len(re.findall(r"^\s+\d+\.\d+\s+\d+\.\d+\s+\d+\.\d+\s+",
                          out.stdout, re.M)) == 13


def _cylinder_args(tmp_path):
    v, c, t = shapes.cylinder_mesh(nz=2, **CYL)
    mesh = msh_io.read_msh(msh_io.write_msh(str(tmp_path / "c"), v, c, t),
                           2)
    return (mesh, Material(), Source(), mesh.boundary_facets(1),
            mesh.boundary_facets(2))


def test_non_prismatic_mesh_raises():
    """A non-prismatic mesh no longer raises: it builds on the indexed
    operator and steps to a finite, non-zero field."""
    um = from_box(build_box_mesh((2, 2, 2), 2, perturb=0.2, seed=4))
    model = LinearWaveModel(um, Material(), Source(), um.boundary_facets()[:4],
                            None, dtype=F64, device="cpu")
    assert isinstance(model.stiffness, IndexedStiffness)
    dt, _ = model.cfl_dt()
    u = model.solve(model.init_state(), dt, 5)[0].u
    assert bool(torch.isfinite(u).all()) and float(u.abs().max()) > 0.0


def test_models_default_to_the_card(tmp_path):
    """No device given: the model runs on the card with the kernel, or,
    with no card, raises instead of dropping to the CPU."""
    args = _cylinder_args(tmp_path)
    if torch.cuda.is_available():
        model = WesterveltModel(*args)
        assert model.device.type == "cuda" and model.impl == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            WesterveltModel(*args)


@pytest.mark.parametrize("device,resolved", [("cuda", "cuda"),
                                             ("cpu", "mm")])
def test_auto_resolves_on_an_extruded_mesh(tmp_path, device, resolved):
    """'auto' on an ExtrudedHexMesh is the kernel on a CUDA device (its
    module holds the kernel layout) and the plain version on the CPU."""
    args = _cylinder_args(tmp_path)
    assert resolve_stiffness_impl("auto", device) == resolved
    op = Discretization(args[0]).stiffness_op(F64, "cpu")
    module = ExtrudedStiffness(op, resolved)
    assert hasattr(module, "G") == (resolved == "cuda")
    assert hasattr(module, "G6") == (resolved == "mm")
    if device == "cpu":
        model = LinearWaveModel(*args, dtype=F64, device=device)
        assert model.impl == "mm"
        assert isinstance(model.stiffness, ExtrudedStiffness)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("P", range(2, 11))
def test_kernels_match_plain_on_card(tmp_path, P):
    """Extruded CUDA kernels vs the plain version on the card (float64 to
    1e-12, float32 to 1e-5 against the float64 plain version), single with
    and without a coefficient and pair, on the imported cylinder; a
    repeated apply is bitwise identical (the class-ordered scatter)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    v, c, t = shapes.cylinder_mesh(nz=4 if P <= 6 else 2, **CYL)
    mesh = msh_io.read_msh(msh_io.write_msh(str(tmp_path / "c"), v, c, t),
                           P)
    disc = Discretization(mesh)
    rng = np.random.default_rng(P)
    c1 = rng.uniform(0.5, 2.0, mesh.num_cells)
    c2 = rng.uniform(-1.5, -0.5, mesh.num_cells)
    x1 = torch.as_tensor(rng.standard_normal(mesh.ndofs), device="cuda")
    x2 = torch.as_tensor(rng.standard_normal(mesh.ndofs), device="cuda")
    cases = [dict(), dict(coeff=c1), dict(pair=(c1, c2))]
    before = dict(ce.launches)
    for kw in cases:
        pair = "pair" in kw
        run = (lambda op, a, b: ce.extruded_pair(op, a, b)) if pair \
            else (lambda op, a, b: ce.extruded(op, a))
        plain = (lambda op, a, b: ce.extruded_pair_plain(op, a, b)) if pair \
            else (lambda op, a, b: ce.extruded_plain(op, a))
        y_ref = plain(disc.stiffness_op(F64, "cuda", **kw), x1, x2).cpu()
        for dtype, tol in ((F64, TOL), (torch.float32, 1e-5)):
            op = disc.stiffness_op(dtype, "cuda", **kw)
            y = run(op, x1.to(dtype), x2.to(dtype))
            torch.cuda.synchronize()
            assert rel(y.cpu(), y_ref) <= tol
            assert torch.equal(run(op, x1.to(dtype), x2.to(dtype)), y)
    assert ce.launches["extruded"] == before["extruded"] + 8
    assert ce.launches["extruded_pair"] == before["extruded_pair"] + 4


@pytest.mark.cuda
@pytest.mark.parametrize("P", range(2, 11))
def test_stack_kernel_matches_plain_on_card(tmp_path, P):
    """The stack kernels (`extruded`, `extruded_pair`) vs the plain version
    on the card, float64 to 1e-12 and float32 to 1e-6 against the float64
    plain version, two applies bitwise equal, and against the class-launch
    kernels to 1e-14 in float64; single with and without a coefficient and
    pair, on the imported cylinder, on one cell (the bulk copy's span cut
    back at G's end) and on long odd stacks (several chunks a stack),
    there also with the stacks cut into 3 z-segments."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    v, c, t = shapes.cylinder_mesh(nz=4 if P <= 6 else 2, **CYL)
    cyl = msh_io.read_msh(msh_io.write_msh(str(tmp_path / "c"), v, c, t), P)
    meshes = [(cyl, {}), (as_extruded(from_box(build_box_mesh((1, 1, 1), P))),
                          {}),
              (as_extruded(from_box(build_box_mesh((2, 1, 29), P))), {}),
              (as_extruded(from_box(build_box_mesh((2, 1, 29), P))),
               {"segments": 3})]
    rng = np.random.default_rng(P)
    before = dict(ce.launches)
    for mesh, schedule in meshes:
        disc = Discretization(mesh)
        c1 = rng.uniform(0.5, 2.0, mesh.num_cells)
        c2 = rng.uniform(-1.5, -0.5, mesh.num_cells)
        x1 = torch.as_tensor(rng.standard_normal(mesh.ndofs), device="cuda")
        x2 = torch.as_tensor(rng.standard_normal(mesh.ndofs), device="cuda")
        for kw in (dict(), dict(coeff=c1), dict(pair=(c1, c2))):
            pair = "pair" in kw
            if pair:
                run = lambda op, a, b: ce.extruded_pair(op, a, b, **schedule)
                old = ce.extruded_classes_pair
                plain = ce.extruded_pair_plain
            else:
                run = lambda op, a, b: ce.extruded(op, a, **schedule)
                old = lambda op, a, b: ce.extruded_classes(op, a)
                plain = lambda op, a, b: ce.extruded_plain(op, a)
            y_ref = plain(disc.stiffness_op(F64, "cuda", **kw), x1, x2).cpu()
            for dtype, tol in ((F64, TOL), (torch.float32, 1e-6)):
                op = disc.stiffness_op(dtype, "cuda", **kw)
                a, b = x1.to(dtype), x2.to(dtype)
                y = run(op, a, b)
                torch.cuda.synchronize()
                assert rel(y.cpu(), y_ref) <= tol, (mesh.num_cells, kw.keys())
                assert torch.equal(run(op, a, b), y)
                if dtype == F64:
                    assert rel(y.cpu(), old(op, a, b).cpu()) <= 1e-14
            if schedule:
                assert op.plan.card(op.P, torch.float32, pair, "cuda",
                                    **schedule)[0].segments == 3
    assert ce.launches["extruded"] == before["extruded"] + 4 * 2 * 2 * 2
    assert ce.launches["extruded_pair"] == before["extruded_pair"] + 4 * 2 * 2
