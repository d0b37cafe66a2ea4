"""The port's stiffness operators against the JAX package: the plain torch
matmul version against `spectral_mm`, the dense element-matrix oracle and
the Pallas kernels in interpret mode; the kernel-layout wrappers and
`convert.stiffness_from_fustpu` on the CPU; and, on a card, the CUDA
kernels against the plain version.

The JAX package is imported inside the tests that compare against it
(they skip where JAX is missing), so that the card test also runs on a
machine without JAX:

    python -m pytest --noconftest tests/test_torch_stiffness.py -m cuda
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fustpu_torch import convert
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.models.discretization import Discretization
from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.ops import precompute as pre
from fustpu_torch.ops import spectral_mm as mm

torch.set_num_threads(1)

F64 = torch.float64
TOL = 1e-12      # f64 gate, the reference's own operator tolerance


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules; skips where JAX is missing."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from fustpu.mesh.box import BoxMesh
    from fustpu.oracle import assemble as oracle
    from fustpu.ops import pallas_stiffness as ps
    from fustpu.ops import spectral_mm as f_mm

    return SimpleNamespace(jax=jax, jnp=jnp, BoxMesh=BoxMesh, oracle=oracle,
                           ps=ps, f_mm=f_mm)


def _case(P, nc=None, seed=0):
    nc = nc or (3, 4, 5)
    mesh = build_box_mesh(nc, P, hi=(1.0, 0.8, 1.3), perturb=0.15, seed=7)
    _, G = pre.cell_geometry_factors(mesh)
    rng = np.random.default_rng(seed)
    return dict(mesh=mesh, G=G, D=mesh.element.deriv_1d,
                coeff=rng.uniform(0.5, 2.0, mesh.nc),
                c2=rng.uniform(-2.0, 2.0, mesh.nc),
                x1=rng.standard_normal(mesh.grid_shape),
                x2=rng.standard_normal(mesh.grid_shape))


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


@pytest.mark.parametrize("P,nc", [(P, (3, 4, 5)) for P in range(2, 10)]
                         + [(10, (2, 2, 2))])
def test_plain_matches_spectral_mm(ref, P, nc):
    f_mm, jnp = ref.f_mm, ref.jnp
    k = _case(P, nc)
    nc, D, G = k["mesh"].nc, k["D"], k["G"]
    fop = f_mm.build_stiffness(nc, P, D, G, jnp.float64, coeff=k["coeff"])
    y_ref = np.asarray(f_mm.stiffness_apply_mm(fop, jnp.asarray(k["x1"])))
    op = mm.build_stiffness(nc, P, D, G, F64, "cpu", coeff=k["coeff"])
    assert rel(mm.stiffness_apply_mm(op, _t(k["x1"])), y_ref) <= TOL
    # the kernel-layout wrapper on CPU tensors: the plain version, no launch
    cs.reset_launches()
    cop = cs.CellStiffness(G=_t(cs.pack_G(G, k["coeff"])), D=_t(D), nc=nc)
    assert rel(cs.stiffness(cop, _t(k["x1"])), y_ref) <= TOL
    # pair: y = A_c1(x1) + A_c2(x2) with a unit G
    fop1 = f_mm.build_stiffness(nc, P, D, G, jnp.float64)
    e = lambda c: jnp.asarray(f_mm.expand_cell_field(c, P + 1))
    ref2 = np.asarray(f_mm.stiffness_apply_mm_pair(
        fop1, jnp.asarray(k["x1"]), jnp.asarray(k["x2"]), e(k["coeff"]),
        e(k["c2"])))
    C = np.stack([k["coeff"].reshape(-1), k["c2"].reshape(-1)], axis=1)
    pop = cs.CellStiffness(G=_t(cs.pack_G(G)), D=_t(D), nc=nc, C=_t(C))
    assert rel(cs.stiffness_pair(pop, _t(k["x1"]), _t(k["x2"])),
               ref2) <= TOL
    assert cs.launches == {"stiffness": 0, "stiffness_pair": 0}


@pytest.mark.parametrize("P", [2, 4])
def test_plain_matches_oracle(ref, P):
    k = _case(P, (3, 2, 3))
    mesh = k["mesh"]
    fmesh = ref.BoxMesh(degree=P, nc=mesh.nc, lo=mesh.lo, hi=mesh.hi,
                        vertex_coords=mesh.vertex_coords)
    mats = ref.oracle.element_stiffness_matrices(fmesh)
    y_ref = ref.oracle.apply_elementwise(mats, fmesh.dofmap,
                                         k["coeff"].reshape(-1),
                                         k["x1"].reshape(-1), mesh.ndofs)
    op = mm.build_stiffness(mesh.nc, P, k["D"], k["G"], F64, "cpu",
                            coeff=k["coeff"])
    y = mm.stiffness_apply_mm(op, _t(k["x1"])).numpy().reshape(-1)
    assert rel(y, y_ref) <= TOL


@pytest.mark.parametrize("P", [2, 4])
def test_plain_matches_pallas_interpret(ref, P):
    jax, jnp, ps = ref.jax, ref.jnp, ref.ps
    k = _case(P, (3, 2, 3))
    nc, D, G = k["mesh"].nc, k["D"], k["G"]
    # single kernel, coefficient folded into G
    fop = ps.build(nc, P, D, G, jnp.float64, coeff=k["coeff"])
    y_ref = np.asarray(ps.stiffness_apply_pallas(
        fop, jnp.asarray(k["x1"]), interpret=True,
        precision=jax.lax.Precision.HIGHEST))
    cop = cs.CellStiffness(G=_t(cs.pack_G(G, k["coeff"])), D=_t(D), nc=nc)
    assert rel(cs.stiffness(cop, _t(k["x1"])), y_ref) <= TOL
    # the same operator through the converter
    host = convert.stiffness_from_fustpu(np.asarray(fop.G), nc,
                                         D=np.asarray(fop.D_host))
    assert host.coeff is None and host.C is None
    conv = host.to_device(F64, "cpu", nc)
    assert rel(cs.stiffness(conv, _t(k["x1"])), y_ref) <= TOL
    # pair kernel
    fpair = ps.build_pair(nc, P, D, G, jnp.float64, k["coeff"], k["c2"])
    ref2 = np.asarray(ps.stiffness_apply_pallas_pair(
        fpair, jnp.asarray(k["x1"]), jnp.asarray(k["x2"]), interpret=True,
        precision=jax.lax.Precision.HIGHEST))
    C = np.stack([k["coeff"].reshape(-1), k["c2"].reshape(-1)], axis=1)
    pop = cs.CellStiffness(G=_t(cs.pack_G(G)), D=_t(D), nc=nc, C=_t(C))
    assert rel(cs.stiffness_pair(pop, _t(k["x1"]), _t(k["x2"])),
               ref2) <= TOL
    host2 = convert.stiffness_from_fustpu(
        np.asarray(fpair.G), nc, D=np.asarray(fpair.D_host),
        C=np.asarray(fpair.C))
    conv2 = host2.to_device(F64, "cpu", nc)
    assert rel(cs.stiffness_pair(conv2, _t(k["x1"]), _t(k["x2"])),
               ref2) <= TOL


def test_convert_matches_own_build(ref):
    """stiffness_from_fustpu of every JAX operator kind gives the port's
    own operator data."""
    f_mm, jnp, ps = ref.f_mm, ref.jnp, ref.ps
    k = _case(3, (3, 2, 4))
    mesh, D, G = k["mesh"], k["D"], k["G"]
    nc, n = mesh.nc, mesh.degree + 1
    disc = Discretization(mesh)
    own = disc.stiffness_op(F64, "cpu", coeff=k["coeff"])
    own_pair = disc.stiffness_op(F64, "cpu", pair=(k["coeff"], k["c2"]))
    fm = f_mm.build_stiffness(nc, mesh.degree, D, G, jnp.float64)
    ce = f_mm.expand_cell_field(k["coeff"], n)
    ce2 = f_mm.expand_cell_field(k["c2"], n)
    Dt = tuple(np.asarray(d) for d in fm.Dt)
    fpal = ps.build(nc, mesh.degree, D, G, jnp.float64, coeff=k["coeff"])
    fpair = ps.build_pair(nc, mesh.degree, D, G, jnp.float64, k["coeff"],
                          k["c2"])
    single = [
        convert.stiffness_from_fustpu(np.asarray(fm.G), nc, Dt=Dt,
                                      coeff_e=ce),
        convert.stiffness_from_fustpu(np.asarray(fpal.G), nc,
                                      D=np.asarray(fpal.D_host))]
    for host in single:
        op = host.to_device(F64, "cpu", nc)
        assert rel(op.G, own.G) <= TOL and rel(op.D, own.D) == 0.0
    pairs = [
        convert.stiffness_from_fustpu(np.asarray(fm.G), nc, Dt=Dt,
                                      c1_e=ce, c2_e=ce2),
        convert.stiffness_from_fustpu(np.asarray(fpair.G), nc,
                                      D=np.asarray(fpair.D_host),
                                      C=np.asarray(fpair.C))]
    for host in pairs:
        op = host.to_device(F64, "cpu", nc)
        assert rel(op.G, own_pair.G) == 0.0 and rel(op.C, own_pair.C) == 0.0


# ---------------------------------------------------------------------------
# The pencil kernel's schedule (ops/cuda_stiffness.py `pencil_schedule`)
# ---------------------------------------------------------------------------

SCHEDULE_SHAPES = [(1, 1, 1), (3, 4, 5), (2, 1, 7), (4, 4, 6), (32, 20, 40)]


def _pencils(sched):
    """The schedule's pencils, by class: (first cell, end cell, rows)."""
    for first, pencils, per_pencil in sched.classes:
        out = []
        for u in range(pencils):
            rows = sched.chunks[first + u * per_pencil:
                                first + (u + 1) * per_pencil]
            out.append((rows[0, 0], rows[-1, 0] + rows[-1, 1], rows))
        yield out


@pytest.mark.parametrize("nc", SCHEDULE_SHAPES)
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("P", range(2, 11))
def test_pencil_schedule(P, itemsize, nc):
    """For the single and the pair kernel: every cell once per apply; no
    two pencils of a class share a node; a block's shared bytes within the
    card's 232,448; every bulk-copy span 16 B-aligned, inside G, and
    covering its chunk's run of G (short of it only at G's end, by less
    than 16 B, which the kernel reads itself)."""
    for pair in (False, True):
        _check_schedule(P, itemsize, nc, pair)


def _check_schedule(P, itemsize, nc, pair):
    ncx, ncy, ncz = nc
    n = P + 1
    cb = 6 * n ** 3 * itemsize
    total = ncx * ncy * ncz * cb
    sched = cs.pencil_schedule(nc, P, itemsize, sms=132, pair=pair)
    # shared memory: the kernel's layout, within one block's limit
    stage, smem = cs.pencil_smem(P, itemsize, sched.cpb, pair, sched.stages)
    assert (sched.stage_bytes, sched.smem) == (stage, smem)
    static = -(-n * n * itemsize // 128) * 128       # D, as ptxas rounds it
    assert sched.smem + static <= 232_448 and sched.stages >= 2
    assert 1 <= sched.cpb and n * n * sched.cpb <= 256
    assert len(sched.classes) <= 4
    # every cell once
    ch = sched.chunks
    assert ch.dtype == np.int64 and ch.shape[1] == 5
    assert sum(int(u * r) for _, u, r in sched.classes) == len(ch)
    covered = np.zeros(ncx * ncy * ncz, np.int64)
    for c0, m, _, _, _ in ch:
        assert 1 <= m <= sched.cpb
        covered[c0:c0 + m] += 1
    assert (covered == 1).all()
    # the chunk's node (0, 0, 0) in the grid
    a, b, c = np.unravel_index(ch[:, 0], nc)
    grid = tuple(m * P + 1 for m in nc)
    assert (ch[:, 4] == np.ravel_multi_index((a * P, b * P, c * P),
                                              grid)).all()
    # pencils: one (a, b), consecutive chunks along z; no shared node in a
    # class
    for pencils in _pencils(sched):
        ab, zr = [], []
        for z0, z1, rows in pencils:
            a, b = rows[0, 0] // (ncy * ncz), (rows[0, 0] // ncz) % ncy
            assert ((rows[:, 0] // ncz) == a * ncy + b).all()
            assert (rows[1:, 0] == rows[:-1, 0] + rows[:-1, 1]).all()
            ab.append((a, b))
            zr.append(((z0 % ncz) * P, ((z1 - 1) % ncz + 1) * P))
        ab, zr = np.asarray(ab), np.asarray(zr)
        near = (np.abs(ab[:, None, :] - ab[None, :, :]) <= 1).all(-1)
        meet = (zr[:, None, 0] <= zr[None, :, 1]) & \
            (zr[None, :, 0] <= zr[:, None, 1])
        np.fill_diagonal(near, False)
        assert not (near & meet).any()
    # bulk-copy spans
    start, end = ch[:, 0] * cb, (ch[:, 0] + ch[:, 1]) * cb
    off, nbytes = ch[:, 2], ch[:, 3]
    assert (off % 16 == 0).all() and (nbytes % 16 == 0).all()
    assert (off >= 0).all() and (off + nbytes <= total).all()
    assert (off <= start).all() and (start - off < 16).all()
    short = end - (off + nbytes)
    assert ((short <= 0) | ((end == total) & (short < 16))).all()
    assert (start - off + ch[:, 1] * cb <= sched.stage_bytes).all()
    assert (nbytes <= sched.stage_bytes).all()


def test_pencil_schedule_follows_the_occupancy():
    """The cells a chunk follow the card's occupancy answer and make the
    apply shortest: on the flagship, 5 cells a chunk and 5 blocks an SM put
    each class's 640 pencils on 660 blocks at once (10 cells and 3 blocks
    would take two rounds); at 32^3 (256 pencils a class) the larger
    chunk wins."""
    calls = []

    def occupancy(P, itemsize, pair, cpb, smem):
        calls.append((P, itemsize, pair, cpb, smem))
        return 2 if cpb == 3 else 0

    s = cs.pencil_schedule((3, 2, 5), 4, 8, sms=1, pair=True,
                           occupancy=occupancy)
    assert (s.cpb, s.blocks_per_sm, s.blocks) == (3, 2, 2)
    assert calls[0][:3] == (4, 8, True) and len(s.classes) == 4
    assert [int(r[1]) for r in s.chunks[:2]] == [3, 2]
    assert [c[4] for c in calls] == [cs.pencil_smem(4, 8, c[3], True)[1]
                                     for c in calls]
    flagship = cs.pencil_schedule((64, 40, 40), 4, 4, sms=132)
    assert (flagship.cpb, flagship.blocks_per_sm) == (5, 5)
    assert flagship.classes[:, 1].tolist() == [640] * 4
    assert flagship.classes[:, 2].tolist() == [8] * 4
    cube = cs.pencil_schedule((32, 32, 32), 4, 4, sms=132)
    assert cube.cpb > 5 and cube.blocks >= 256


def _cell_contrib(u, g, D):
    """D^T (c G) D u for a batch of cells, u (cells, n, n, n), g (cells, 6,
    n, n, n), sum-factorised as the kernel's body."""
    e = torch.einsum
    wx = e("ir,crjk->cijk", D, u)
    wy = e("jr,cirk->cijk", D, u)
    wz = e("kr,cijr->cijk", D, u)
    f0 = g[:, 0] * wx + g[:, 1] * wy + g[:, 2] * wz
    f1 = g[:, 1] * wx + g[:, 3] * wy + g[:, 4] * wz
    f2 = g[:, 2] * wx + g[:, 4] * wy + g[:, 5] * wz
    return (e("ri,crjk->cijk", D, f0) + e("rj,cirk->cijk", D, f1)
            + e("rk,cijr->cijk", D, f2))


def _emulate(op, sched, x1, x2=None):
    """Float64 torch emulation of the pencil kernel on `op` under `sched`:
    each cell's contribution added into y class by class, chunk by chunk
    of each pencil, even cells of a chunk, then odd (a batch of one class,
    chunk and turn shares no node, so its adds are exact)."""
    P, n = op.P, op.P + 1
    _, ncy, ncz = op.nc
    g = op.G.reshape(-1, 6, n, n, n)
    r = torch.arange(n)
    y = torch.zeros_like(x1)
    for first, pencils, per_pencil in sched.classes:
        for q in range(per_pencil):
            rows = sched.chunks[first + np.arange(pencils) * per_pencil + q]
            for turn in (0, 1):
                cells = torch.as_tensor([c for c0, m, *_ in rows
                                         for c in range(c0 + turn, c0 + m, 2)
                                         ], dtype=torch.long)
                if cells.numel() == 0:
                    continue
                a, b, c = cells // (ncy * ncz), (cells // ncz) % ncy, \
                    cells % ncz
                idx = ((a * P)[:, None, None, None] + r[:, None, None],
                       (b * P)[:, None, None, None] + r[:, None],
                       (c * P)[:, None, None, None] + r)
                u = x1[idx]
                if x2 is not None:
                    cc = op.C[cells][:, :, None, None, None]
                    u = cc[:, 0] * u + cc[:, 1] * x2[idx]
                y.index_put_(idx, _cell_contrib(u, g[cells], op.D),
                             accumulate=True)
    return y


@pytest.mark.parametrize("small_card", [False, True])
@pytest.mark.parametrize("P", [2, 4])
def test_pencil_order_matches_pallas_interpret(ref, P, small_card):
    """The pencil kernel's schedule, emulated in float64 (its classes,
    chunks and turns), against the JAX package's Pallas kernels in
    interpret mode, single and pair, on a box with odd ncz: on a card of
    132 SMs (one chunk a pencil) and on a card that holds one block of 2
    cells (chunks of 2, 2 and 1 cells)."""
    jax, jnp, ps = ref.jax, ref.jnp, ref.ps
    k = _case(P, (3, 2, 5))
    nc, D, G = k["mesh"].nc, k["D"], k["G"]
    occ = (lambda *a: int(a[3] == 2)) if small_card else \
        cs.model_occupancy
    sched = cs.pencil_schedule(nc, P, 8, sms=1 if small_card else 132,
                               occupancy=occ)
    assert sched.classes[0, 2] == (3 if small_card else 1)
    fop = ps.build(nc, P, D, G, jnp.float64, coeff=k["coeff"])
    y_ref = np.asarray(ps.stiffness_apply_pallas(
        fop, jnp.asarray(k["x1"]), interpret=True,
        precision=jax.lax.Precision.HIGHEST))
    cop = cs.CellStiffness(G=_t(cs.pack_G(G, k["coeff"])), D=_t(D), nc=nc)
    assert rel(_emulate(cop, sched, _t(k["x1"])), y_ref) <= TOL
    fpair = ps.build_pair(nc, P, D, G, jnp.float64, k["coeff"], k["c2"])
    ref2 = np.asarray(ps.stiffness_apply_pallas_pair(
        fpair, jnp.asarray(k["x1"]), jnp.asarray(k["x2"]), interpret=True,
        precision=jax.lax.Precision.HIGHEST))
    C = np.stack([k["coeff"].reshape(-1), k["c2"].reshape(-1)], axis=1)
    pop = cs.CellStiffness(G=_t(cs.pack_G(G)), D=_t(D), nc=nc, C=_t(C))
    assert rel(_emulate(pop, sched, _t(k["x1"]), _t(k["x2"])), ref2) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("P", range(2, 11))
def test_kernels_match_plain_on_card(P):
    """The pencil kernels vs the plain version on the card (float64 to 1e-12,
    float32 to 1e-6 against the float64 plain version), two applies bitwise
    equal, and against the parity-class kernel (anatomy's full and
    full_pair of its classes design) to 1e-14 in float64; on an odd box,
    one cell (the bulk copy's span cut back at G's end) and a long odd
    pencil (several chunks a pencil)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    from fustpu_torch.ops import anatomy

    before = dict(cs.launches)
    shapes = [(3, 4, 5) if P <= 6 else (2, 3, 3), (1, 1, 1), (1, 2, 29)]
    for shape in shapes:
        k = _case(P, shape)
        nc, D, G = k["mesh"].nc, k["D"], k["G"]
        C = np.stack([k["coeff"].reshape(-1), k["c2"].reshape(-1)], axis=1)

        def op(dtype, pair):
            t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
            if pair:
                return cs.CellStiffness(G=t(cs.pack_G(G)), D=t(D), nc=nc,
                                        C=t(C))
            return cs.CellStiffness(G=t(cs.pack_G(G, k["coeff"])), D=t(D),
                                    nc=nc)

        x1 = torch.as_tensor(k["x1"], device="cuda")
        x2 = torch.as_tensor(k["x2"], device="cuda")
        y_ref = cs.stiffness_plain(op(F64, False), x1).cpu()
        ref2 = cs.stiffness_pair_plain(op(F64, True), x1, x2).cpu()
        for dtype, tol in ((F64, TOL), (torch.float32, 1e-6)):
            o1, o2 = op(dtype, False), op(dtype, True)
            a, b = x1.to(dtype), x2.to(dtype)
            y = cs.stiffness(o1, a)
            y2 = cs.stiffness_pair(o2, a, b)
            torch.cuda.synchronize()
            assert rel(y.cpu(), y_ref) <= tol, (shape, dtype)
            assert rel(y2.cpu(), ref2) <= tol, (shape, dtype)
            assert torch.equal(cs.stiffness(o1, a), y)
            assert torch.equal(cs.stiffness_pair(o2, a, b), y2)
            if dtype == F64:
                old = anatomy.variant_classes(o1, a, "full")
                old2 = anatomy.full_pair_classes(o2, a, b)
                assert rel(y.cpu(), old.cpu()) <= 1e-14
                assert rel(y2.cpu(), old2.cpu()) <= 1e-14
    assert cs.launches["stiffness"] == before["stiffness"] + 4 * len(shapes)
    assert cs.launches["stiffness_pair"] == \
        before["stiffness_pair"] + 4 * len(shapes)
