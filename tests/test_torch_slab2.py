"""The port's two-slab stiffness operators (``ops/slab2``, kernels #4 and
#5) against the JAX package: the plain versions against `_apply_slab2` /
`_apply_slab2w` in interpret mode on the boxes of the JAX package's own
slab2 tests plus ncx = 2, with and without a coefficient, in float64; the
pair maps and their scatter classes; the z-pencil walk's schedule
(`cuda_slab2.slab2_schedule`) and an f64 emulation of its
order of adds against the same Pallas kernels; `convert.slab2*_from_
fustpu`; the `exp_slab2w` demo on the CPU; and, on a card, the CUDA
kernels against the plain versions and the walk against the
class-launch design.

The JAX package is imported inside the tests that compare against it, so
that the card tests also run on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_slab2.py -m cuda
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fustpu_torch import convert
from fustpu_torch.demos import exp_slab2w
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.ops import cuda_slab2 as c2
from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.ops import precompute as pre
from fustpu_torch.ops import slab2 as s2

torch.set_num_threads(1)

F64 = torch.float64
TOL = 1e-12      # f64 gate, the reference's own operator tolerance
# the JAX package's slab2 test boxes (tests/test_pallas.py), and ncx = 2,
# where both pairings put the two slabs in one pair
BOXES = [(4, 3, 2), (5, 2, 3), (2, 3, 3)]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules; skips where JAX is missing."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from fustpu.elements.hex import HexElement
    from fustpu.mesh.box import build_box_mesh as f_build_box_mesh
    from fustpu.ops import pallas_stiffness as ps
    from fustpu.ops import precompute as f_pre

    return SimpleNamespace(jax=jax, jnp=jnp, HexElement=HexElement,
                           build_box_mesh=f_build_box_mesh, ps=ps,
                           pre=f_pre)


@functools.lru_cache(maxsize=None)
def _jax_case(nc, coeff: bool):
    """The JAX package's test inputs (P=3, perturb 0.12, seed 5, x from
    seed 0), with a per-cell coefficient from seed 1 if `coeff`."""
    from fustpu.elements.hex import HexElement
    from fustpu.mesh.box import build_box_mesh as f_build_box_mesh
    from fustpu.ops import precompute as f_pre

    P = 3
    mesh = f_build_box_mesh(nc, P, perturb=0.12, seed=5)
    _, G = f_pre.cell_geometry_factors(mesh)
    x = np.random.default_rng(0).standard_normal(mesh.grid_shape)
    c = (np.random.default_rng(1).uniform(0.5, 2.0, nc) if coeff
         else None)
    return P, np.asarray(G), HexElement(P).deriv_1d, x, c


@pytest.mark.parametrize("far", [False, True], ids=["slab2", "slab2w"])
@pytest.mark.parametrize("coeff", [False, True], ids=["unit", "coeff"])
@pytest.mark.parametrize("nc", BOXES)
def test_plain_matches_pallas_interpret(ref, nc, coeff, far):
    P, G, D, x, c = _jax_case(nc, coeff)
    jnp, ps = ref.jnp, ref.ps
    build, apply = ((ps.build_slab2w, ps._apply_slab2w) if far
                    else (ps.build_slab2, ps._apply_slab2))
    want = apply(build(nc, P, D, G, jnp.float64, coeff=c),
                 jnp.asarray(x), interpret=True, precision=ps._HI)
    op = (s2.build_slab2w if far else s2.build_slab2)(nc, P, D, G, F64,
                                                      coeff=c, device="cpu")
    plain = s2.slab2w_plain if far else s2.slab2_plain
    got = plain(op, torch.as_tensor(x))
    assert rel(got, want) <= TOL
    # the wrapper takes the plain version for a CPU tensor
    wrapper = c2.slab2w if far else c2.slab2
    assert torch.equal(wrapper(op, torch.as_tensor(x)), got)


@pytest.mark.parametrize("far", [False, True], ids=["slab2", "slab2w"])
@pytest.mark.parametrize("ncx", [1, 2, 3, 4, 5, 6, 7, 8])
def test_pair_maps_and_classes(far, ncx):
    """Every cell in exactly one block slot; the ghost only for odd ncx;
    no two blocks of a scatter class share a node (checked through the
    box's dofmap); the far pairing's seam pair (slabs ncx2 - 1, ncx2) in
    different classes."""
    nc = (ncx, 2, 3)
    slabs = s2.slab_pairs(ncx, far)
    ncx2 = -(-ncx // 2)
    assert slabs.shape == (ncx2, 2)
    assert sorted(slabs[slabs >= 0].tolist()) == list(range(ncx))
    assert (slabs < 0).sum() == ncx % 2
    pairs, bounds = s2.pair_table(slabs, nc)
    ids = pairs[pairs >= 0]
    assert sorted(ids.tolist()) == list(range(ncx * 6))
    assert bounds[0] == 0 and bounds[-1] == len(pairs) == ncx2 * 6
    dofmap = build_box_mesh(nc, 2).dofmap
    for k in range(len(bounds) - 1):
        cells = pairs[bounds[k]:bounds[k + 1]]
        nodes = [np.unique(np.concatenate([dofmap[c] for c in blk
                                           if c >= 0]))
                 for blk in cells]
        if nodes:
            every = np.concatenate(nodes)
            assert np.unique(every).size == every.size, (k, cells)
    colours = s2.slab_colours(slabs)
    if far and ncx2 > 1:
        assert colours[ncx2 - 1] != colours[0]
    assert colours.max() + 1 == (3 if far and ncx2 % 2 and ncx2 > 1
                                 else min(ncx2, 2))


def test_plain_adds_the_seam():
    """The far pairing's two sweeps share the seam plane ncx2 P: each
    sweep alone misses the other's part of it, their overlap-add is the
    operator."""
    nc, P = (4, 2, 2), 2
    mesh = build_box_mesh(nc, P, perturb=0.1, seed=2)
    _, G = pre.cell_geometry_factors(mesh)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        mesh.grid_shape))
    op = s2.build_slab2w(nc, P, mesh.element.deriv_1d, G, F64, device="cpu")
    full = cs.stiffness_plain(op.cell_op, x)
    seam = 2 * P
    first = s2._slabs_apply(op, x, 0, 2)
    second = s2._slabs_apply(op, x, 2, 4)
    assert rel(first[seam] + second[0], full[seam]) <= TOL
    assert rel(first[seam], full[seam]) > 1e-3
    assert rel(s2.slab2w_plain(op, x), full) <= TOL


@pytest.mark.parametrize("far", [False, True], ids=["slab2", "slab2w"])
@pytest.mark.parametrize("nc", [(4, 3, 2), (5, 2, 3)])
def test_convert_matches_own_build(ref, nc, far):
    """A JAX-built two-slab operator (lane halves, lane padding and ghost
    slab) converts to the port's own build, bitwise."""
    P, G, D, x, c = _jax_case(nc, True)
    ps, jnp = ref.ps, ref.jnp
    if far:
        fop = ps.build_slab2w(nc, P, D, G, jnp.float64, coeff=c)
        op = convert.slab2w_from_fustpu(np.asarray(fop.G2), fop.statics,
                                        device="cpu")
        own = s2.build_slab2w(nc, P, D, G, F64, coeff=c, device="cpu")
    else:
        fop = ps.build_slab2(nc, P, D, G, jnp.float64, coeff=c)
        op = convert.slab2_from_fustpu(np.asarray(fop.G2), fop.statics,
                                       device="cpu")
        own = s2.build_slab2(nc, P, D, G, F64, coeff=c, device="cpu")
    assert op.far == far and op.nc == own.nc
    assert torch.equal(op.G, own.G) and torch.equal(op.D, own.D)
    assert np.array_equal(op.slabs, own.slabs)
    assert torch.equal(op.pairs, own.pairs) and op.bounds == own.bounds


# the walk's pairings
WALKS = [False, True]
WALK_IDS = ["slab2", "slab2w"]
SCHED_BOXES = BOXES + [(ncx, 2, 3) for ncx in range(1, 9)]


@functools.lru_cache(maxsize=None)
def _dofmap(nc):
    return build_box_mesh(nc, 2).dofmap


def _work_items(sched, nc):
    """By class entry, each work item's cells in walk order."""
    out = []
    for first, items, per in sched.classes:
        out.append([[int(c0) + i
                     for c0, m, *_ in sched.chunks[first + k * per:
                                                   first + (k + 1) * per]
                     for i in range(m)] for k in range(items)])
    return out


@pytest.mark.parametrize("far", WALKS, ids=WALK_IDS)
@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("P", range(2, 11))
def test_slab2_schedule(P, itemsize, far):
    """On the test boxes and ncx = 1..8 (a card of 132 SMs, the model
    occupancy): every cell once; a work item is one slab pair's two
    pencils (one for the ghost's pair); no node shared by two work items
    of a class; the classes (colour, b % 2), a class's ghost pairs apart;
    the chunks' bulk spans 16 B-aligned, inside G, in their stage; the
    shared bytes within a block's; the drain where a pair's pencils are
    adjacent and have at most two chunks."""
    for nc in SCHED_BOXES:
        ncx, ncy, ncz = nc
        sched = c2.slab2_schedule(nc, P, itemsize, 132, far)
        slabs = s2.slab_pairs(ncx, far)
        pairs = [{int(a) for a in p if a >= 0} for p in slabs]
        items = _work_items(sched, nc)
        every = sorted(c for cls in items for it in cls for c in it)
        assert every == list(range(ncx * ncy * ncz)), nc
        dofmap = _dofmap(nc)
        for cls in items:
            for it in cls:
                a = {c // (ncy * ncz) for c in it}
                assert len({(c // ncz) % ncy for c in it}) == 1
                assert a in pairs and len(it) == ncz * len(a), (nc, it)
            nodes = np.concatenate([np.unique(dofmap[it]) for it in cls])
            assert np.unique(nodes).size == nodes.size, nc
        colour = s2.slab_colours(slabs)
        assert sched.colours == colour.max() + 1
        # the colour classes (colour, b % 2): 4, or 6 for far pairing with
        # an odd pair count; a class's ghost pairs an entry of their own
        q_of = {frozenset(p): q for q, p in enumerate(pairs)}
        keys = [(colour[q_of[frozenset(c // (ncy * ncz) for c in cls[0])]],
                 (cls[0][0] // ncz) % ncy % 2,
                 any(len(p) == 1 and frozenset(p) == frozenset(
                     c // (ncy * ncz) for c in cls[0]) for p in pairs))
                for cls in items]
        assert len(set(keys)) == len(keys)
        assert len({k[:2] for k in keys}) == 2 * sched.colours
        cb = 6 * (P + 1) ** 3 * itemsize
        total = ncx * ncy * ncz * cb
        c0, n, off, nb = (sched.chunks[:, i] for i in range(4))
        end = (c0 + n) * cb
        assert (off % 16 == 0).all() and (nb % 16 == 0).all()
        assert (off <= c0 * cb).all() and (off + nb <= total).all()
        assert ((off + nb >= end) | (end > total - 16)).all()
        assert (c0 * cb - off + n * cb <= sched.stage_bytes).all()
        assert (n <= sched.cpb).all() and sched.sub == -(-ncz // sched.cpb)
        assert (P + 1) ** 2 * sched.cpb <= cs.MAX_THREADS
        assert sched.smem + cs._static_smem(P, itemsize) <= 232_448
        adjacent = any(b >= 0 and b - a == 1 for a, b in slabs)
        assert sched.drain == (adjacent and sched.sub <= 2)


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


def _emulate(op, sched, x):
    """Float64 torch emulation of the walk on `op` under `sched`: each
    cell's contribution added into y class by class, chunk by chunk of
    the work items (the first pencil's chunks, then the second's), and in
    each chunk by turn (even cells, then odd).  A batch of one class, chunk
    and turn shares no node, so its adds are exact."""
    P, n = op.P, op.P + 1
    _, ncy, ncz = op.nc
    g = op.G.reshape(-1, 6, n, n, n)
    r = torch.arange(n)
    y = torch.zeros_like(x)
    for first, items, per in sched.classes:
        for q in range(per):
            rows = sched.chunks[first + np.arange(items) * per + q]
            for turn in (0, 1):
                cells = torch.as_tensor(
                    [c0 + i for c0, m, *_ in rows
                     for i in range(turn, m, 2)], dtype=torch.long)
                if cells.numel() == 0:
                    continue
                a, b, c = (cells // (ncy * ncz), (cells // ncz) % ncy,
                           cells % ncz)
                idx = ((a * P)[:, None, None, None] + r[:, None, None],
                       (b * P)[:, None, None, None] + r[:, None],
                       (c * P)[:, None, None, None] + r)
                y.index_put_(idx, _cell_contrib(x[idx], g[cells], op.D),
                             accumulate=True)
    return y


@functools.lru_cache(maxsize=None)
def _pallas_slab2(nc, far):
    """The JAX package's two-slab kernel in interpret mode on
    `_jax_case(nc, coeff=True)`."""
    import jax.numpy as jnp
    from fustpu.ops import pallas_stiffness as ps

    P, G, D, x, c = _jax_case(nc, True)
    build, apply = ((ps.build_slab2w, ps._apply_slab2w) if far
                    else (ps.build_slab2, ps._apply_slab2))
    return np.asarray(apply(build(nc, P, D, G, jnp.float64, coeff=c),
                            jnp.asarray(x), interpret=True,
                            precision=ps._HI))


@pytest.mark.parametrize("small_card", [False, True],
                         ids=["132-sms", "one-cell-chunks"])
@pytest.mark.parametrize("far", WALKS, ids=WALK_IDS)
@pytest.mark.parametrize("nc", BOXES)
def test_slab2_walk_order_matches_pallas_interpret(ref, nc, far, small_card):
    """The walk's schedule, emulated in float64 (its classes, work items,
    chunks and turns), against `_apply_slab2` / `_apply_slab2w` in
    interpret mode with a coefficient: on a card of 132 SMs and on one
    whose blocks hold one cell a pencil (a chunk per cell, so that a
    pencil of two cells drains and a longer one does not)."""
    P, G, D, x, c = _jax_case(nc, True)
    occ = (lambda P, it, pair, cpb, smem: int(cpb == 1)) if small_card \
        else cs.model_occupancy
    sched = c2.slab2_schedule(nc, P, 8, 1 if small_card else 132, far,
                              occupancy=occ)
    if small_card:
        assert sched.cpb == 1 and sched.sub == nc[2]
    op = (s2.build_slab2w if far else s2.build_slab2)(nc, P, D, G, F64,
                                                      coeff=c, device="cpu")
    got = _emulate(op, sched, torch.as_tensor(x))
    assert rel(got, _pallas_slab2(nc, far)) <= TOL


class _OnCard(torch.Tensor):
    """A CPU tensor that the wrappers take for one on card 0, so that
    their checks run here; the kernel library's loader is replaced in each
    test that uses it, so nothing launches."""

    is_cpu = False
    is_cuda = True
    device = torch.device("cuda", 0)

    def get_device(self):
        return 0


def _on_card(op):
    return op._replace(**{k: v.as_subclass(_OnCard)
                          for k, v in op._asdict().items()
                          if isinstance(v, torch.Tensor)})


def test_walk_wrappers_refuse_before_any_launch(monkeypatch):
    """On card tensors the walk's wrappers launch or raise: a field of the
    wrong dtype, device or size, an operator of the other pairing and
    misaligned G raise before the kernel library is loaded or a schedule
    built."""
    from fustpu_torch import _build

    def refuse(*args, **kwargs):
        raise AssertionError("the wrapper reached the kernel library")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(c2, "_card_schedule", refuse)
    P, G, D, x, _ = _jax_case((4, 3, 2), False)
    ops = {far: (s2.build_slab2w if far else s2.build_slab2)(
        (4, 3, 2), P, D, G, F64, device="cpu") for far in (False, True)}
    xc = torch.as_tensor(x).as_subclass(_OnCard)
    for far, fn in ((False, c2.slab2), (True, c2.slab2w)):
        op = ops[far]
        card = _on_card(op)
        base = torch.zeros(op.G.numel() + 1, dtype=F64)
        base[1:].copy_(op.G.reshape(-1))
        cases = [
            (card, xc.to(torch.float32).as_subclass(_OnCard), "G is"),
            (card, xc.to(torch.float16).as_subclass(_OnCard), "dtype"),
            (op, xc, "on cpu"),
            (card, xc.reshape(-1)[1:].as_subclass(_OnCard), "shape"),
            (_on_card(op._replace(G=base[1:].view(op.G.shape))), xc,
             "16 B"),
            (_on_card(ops[not far]), xc, "paired operator")]
        for o, xx, match in cases:
            with pytest.raises(ValueError, match=match):
                fn(o, xx)


def test_exp_slab2w_demo_on_cpu(capsys):
    out = exp_slab2w.main(["f64", "2", "--nc", "3", "--design", "both",
                           "--device", "cpu", "--chain", "1", "--reps", "1"])
    assert set(out["rel"]) == {"slab2", "slab2w", "slab2_classes",
                               "slab2w_classes"}
    assert all(v <= TOL for v in out["rel"].values())
    assert len(out["times"]["production"]) == 2
    assert len(out["times"]["slab2_classes"]) == 2
    text = capsys.readouterr().out
    assert "cross-check slab2w vs production" in text
    assert "design both" in text and "class launches" in text
    assert "host clock on the CPU" in text
    out = exp_slab2w.main(["f64", "2", "--nc", "4", "3", "2", "--design",
                           "classes", "--device", "cpu", "--chain", "1",
                           "--reps", "1"])
    assert out["mesh"].nc == (4, 3, 2) and set(out["times"]) == {
        "slab2_classes", "slab2w_classes"}
    assert out["rel"]["slab2w_classes"] <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("P", range(2, 11))
def test_kernels_match_plain_on_card(P):
    """The slab2 and slab2w kernels against their plain versions on the
    card, every test box and a longer odd pencil with and without a
    coefficient (float64 to 1e-12, float32 to 1e-6 against the float64
    plain version): the walk, repeated bitwise and against the
    class-launch design to 1e-14 in float64, and that design itself;
    slab2w against the single-slab kernel on the same buffers."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    before = dict(c2.launches)
    boxes = BOXES + [(3, 2, 7)]
    for nc in boxes:
        mesh = build_box_mesh(nc, P, perturb=0.12, seed=5)
        _, G = pre.cell_geometry_factors(mesh)
        D = mesh.element.deriv_1d
        x = np.random.default_rng(0).standard_normal(mesh.grid_shape)
        for c in (None, np.random.default_rng(1).uniform(0.5, 2.0, nc)):
            for far in (False, True):
                build = s2.build_slab2w if far else s2.build_slab2
                plain = s2.slab2w_plain if far else s2.slab2_plain
                old = c2.slab2w_classes if far else c2.slab2_classes
                walk = c2.slab2w if far else c2.slab2
                op = build(nc, P, D, G, F64, coeff=c, device="cuda")
                op32 = build(nc, P, D, G, torch.float32, coeff=c,
                             device="cuda")
                xd = torch.as_tensor(x, device="cuda")
                want = plain(op, xd).cpu()
                y_old = old(op, xd)
                assert rel(y_old.cpu(), want) <= TOL
                assert rel(old(op32, xd.float()).cpu(), want) <= 1e-6
                y32 = walk(op32, xd.float())
                torch.cuda.synchronize()
                assert rel(y32.cpu(), want) <= 1e-6, (nc, far)
                y = walk(op, xd)
                torch.cuda.synchronize()
                assert rel(y.cpu(), want) <= TOL, (nc, far)
                assert rel(y.cpu(), y_old.cpu()) <= 1e-14, (nc, far)
                assert torch.equal(walk(op, xd), y)
                if far:
                    y1 = cs.stiffness(op.cell_op, xd)
                    assert rel(c2.slab2w(op, xd).cpu(), y1.cpu()) <= TOL
    k = 2 * len(boxes)
    assert c2.launches["slab2"] == before["slab2"] + 3 * k
    assert c2.launches["slab2w"] == before["slab2w"] + 4 * k
    assert c2.launches["slab2_classes"] == before["slab2_classes"] + 2 * k
    assert c2.launches["slab2w_classes"] == \
        before["slab2w_classes"] + 2 * k
