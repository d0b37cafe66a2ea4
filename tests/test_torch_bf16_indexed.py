"""The bfloat16 chunked indexed kernel redesigned for Hopper (the lean chunk
kernel, ``fustpu_torch/csrc/indexed_lean.cu``; #11 on general meshes
through ``ops/cuda_indexed``).

On the CPU: the lean kernel's launch at P = 2..10, single and pair, on the
first design's schedule (the same cells a chunk, chunks and classes, the
first design's shared layout within the card's 232,448 with its static D,
the largest chunk a degree allows fitting too), and its first-class flags
(`lead_ends`) consistent with the classes; a float32 emulation of the
lean kernel's order of adds and roundings against the JAX
package's bfloat16 fused Pallas engine in interpret mode and against the
plain version; the routing of an apply to the lean kernel or the first
design, the same degrees as the CUDA source instantiates, the counters
and kernel names by degree, and the wrappers' refusals before any launch.
On the card (`-m cuda`, skipped here): at each degree that runs the lean
kernel, its output bitwise the first design's on the same schedule (the
redesign gate), both within 2^-7 of the plain version, two applies
bitwise, each counted in its own counter; a captured bf16 solve on it
bitwise its eager steps.  The JAX package is imported
inside the tests that compare against it (the `ref` fixture):

    python -m pytest --noconftest tests/test_torch_bf16_indexed.py -m cuda
"""

from __future__ import annotations

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fustpu_torch import _build
from fustpu_torch.config import Material, Source
from fustpu_torch.mesh import msh_io, shapes
from fustpu_torch.mesh import unstructured as un
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.models.discretization import (Discretization,
                                                IndexedStiffness)
from fustpu_torch.models.westervelt import WesterveltModel
from fustpu_torch.ops import cuda_indexed as ci
from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.ops import launch

torch.set_num_threads(1)

BF16 = torch.bfloat16
# one bf16 apply of the port against one of the JAX package
APPLY_TOL = 1e-2
# a bf16 kernel, or its emulation, against its plain version on the same
# bf16 inputs (the plain version rounds y once, the kernel once a class)
CARD_TOL = 2.0 ** -7
CYL = dict(radius=0.012, length=0.02, piston_radius=0.008, m=3, mr=1,
           nr_ann=1)
SMEM_BLOCK = 232_448


def rel(a, b):
    f = lambda t: (t.double().numpy() if isinstance(t, torch.Tensor)
                   else np.asarray(t, np.float64))
    a, b = f(a).reshape(-1), f(b).reshape(-1)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's fused gather engine, built with one plan tile per
    grid step (its interpret mode traces in about a second); skips where
    JAX is missing."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from fustpu.ops import pallas_gather as pg

    old = pg.FST
    pg.FST = 1
    yield SimpleNamespace(jax=jax, jnp=jnp, pg=pg)
    pg.FST = old


def _mesh(kind, P, directory):
    """A general mesh: the imported non-prismatic cylinder, a perturbed box
    read as a general mesh in shuffled cell order, or a box in
    `locality_order`."""
    if kind == "cylinder":
        v, c, t = shapes.cylinder_mesh(nz=3 if P <= 6 else 2, **CYL)
        return msh_io.read_msh(msh_io.write_msh(
            str(Path(directory) / f"c{P}"), v, c, t), P,
            detect_extrusion=False)
    if kind == "shuffled":
        return un.from_box(build_box_mesh(
            (3, 2, 4) if P <= 4 else (2, 2, 2), P, hi=(1.0, 0.8, 1.3),
            perturb=0.2, seed=P), shuffle_seed=11)
    return un.locality_order(un.from_box(build_box_mesh((3, 3, 4), P)))


# ---------------------------------------------------------------------------
# The lean kernel's launch and tables
# ---------------------------------------------------------------------------

def _check_lean(plan, P, pair, cpb=None, sms=132):
    """The lean launch of the first design's bf16 schedule: the same cells
    a chunk, table and classes; the shared bytes its layout's, with its
    static D within a block's limit, the blocks an SM those bytes allow;
    `lead_ends` the ends, flagged exactly where no chunk of an earlier
    class holds the dof."""
    first = ci.chunk_schedule(plan, P, 2, sms, pair, cpb=cpb)
    lean = ci.lean_schedule(first, P, sms, pair, cs.model_occupancy)
    for f in ("cpb", "maxu", "stages", "stage_bytes", "smem"):
        assert getattr(lean, f) == getattr(first, f)
    assert np.array_equal(lean.classes, first.classes)
    assert np.array_equal(lean.chunks, first.chunks)
    stage, smem = ci.chunk_smem(P, 2, lean.cpb, lean.maxu, pair)
    assert (lean.stage_bytes, lean.smem) == (stage, smem) and stage % 16 == 0
    assert smem + cs._static_smem(P, 2) <= SMEM_BLOCK
    assert lean.blocks == lean.blocks_per_sm * sms
    assert lean.blocks_per_sm == cs.model_occupancy(P, 2, pair, lean.cpb,
                                                    smem)
    tab = plan.tables(lean.cpb)
    assert tab.lead_ends.dtype == np.int16
    assert np.array_equal(tab.lead_ends & 0x7fff, tab.ends)
    seen = np.zeros(plan.ndofs, bool)
    for first, count in lean.classes:
        here = []
        for c0, m, _, _, u0, nu in lean.chunks[first:first + count]:
            ids = tab.uniq[u0:u0 + nu]
            assert np.array_equal(tab.lead_ends[u0:u0 + nu] < 0, ~seen[ids])
            here.append(ids)
        for ids in here:
            seen[ids] = True
    assert seen.all() and plan.covers
    return lean


@pytest.mark.parametrize("P", range(2, 11))
def test_lean_chunk_launch(tmp_path, P):
    """The lean kernel's launch, single and pair, with the first design's
    cells a chunk and with one cell a chunk, on the imported cylinder, a
    shuffled perturbed box and a box in `locality_order`: `_check_lean`;
    and a block of the most cells a degree takes (n^2 cpb <= 256 threads),
    every position a unique dof, within a block's shared memory."""
    for kind in ("cylinder", "shuffled", "locality"):
        mesh = _mesh(kind, P, tmp_path)
        plan = ci.ChunkPlan(mesh.dofmap, mesh.ndofs)
        for pair in (False, True):
            _check_lean(plan, P, pair)
            assert _check_lean(plan, P, pair, cpb=1).cpb == 1
    cpb = 256 // (P + 1) ** 2
    for pair in (False, True):
        assert ci.chunk_smem(P, 2, cpb, cpb * (P + 1) ** 3, pair)[1] + \
            cs._static_smem(P, 2) <= SMEM_BLOCK


# ---------------------------------------------------------------------------
# The lean kernel's order of adds, emulated, against the JAX package
# ---------------------------------------------------------------------------

def _cell_contrib(u, g, D):
    """D^T (c G) D u for a batch of cells in float32, as the body's terms."""
    e = torch.einsum
    wx = e("ir,crjk->cijk", D, u)
    wy = e("jr,cirk->cijk", D, u)
    wz = e("kr,cijr->cijk", D, u)
    f0 = g[:, 0] * wx + g[:, 1] * wy + g[:, 2] * wz
    f1 = g[:, 1] * wx + g[:, 3] * wy + g[:, 4] * wz
    f2 = g[:, 2] * wx + g[:, 4] * wy + g[:, 5] * wz
    return (e("ri,crjk->cijk", D, f0) + e("rj,cirk->cijk", D, f1)
            + e("rk,cijr->cijk", D, f2))


def emulate_lean(op, sched, x1, x2=None):
    """The lean chunk kernel on the bf16 operator `op` under `sched`,
    emulated in float32: class by class, each chunk's u from its unique
    dofs' x through the inverse map (widened; for the pair c1 x1 + c2 x2
    with the position's cell's c), each cell's node sums,
    then each unique dof's positions summed in the inverse map's order from
    0, added to the bfloat16 y that earlier classes left (0 in the dof's
    first class, by `lead_ends`: y starts as NaN, uninitialised), rounded
    once."""
    n = op.P + 1
    nnn = n ** 3
    tab = op.plan.tables(sched.cpb)
    G, D = op.G.float(), op.D.float()
    y = torch.full(x1.shape, float("nan"), dtype=BF16)
    for first, count in sched.classes:
        for c0, m, _, _, u0, nu in sched.chunks[first:first + count]:
            ids = torch.as_tensor(tab.uniq[u0:u0 + nu].astype(np.int64))
            ends = tab.ends[u0:u0 + nu].astype(np.int64)
            start = np.concatenate([[0], ends[:-1]])
            pos = torch.as_tensor(tab.pos[c0 * nnn:(c0 + m) * nnn]
                                  .astype(np.int64))
            slot = torch.as_tensor(np.repeat(np.arange(nu), ends - start))
            u = torch.empty(m * nnn)
            u[pos] = x1.float()[ids][slot]
            if x2 is not None:
                cc = op.C.float()[c0 + pos // nnn]
                u[pos] = cc[:, 0] * u[pos] + cc[:, 1] * x2.float()[ids][slot]
            sums = _cell_contrib(u.reshape(m, n, n, n),
                                 G[c0:c0 + m].reshape(m, 6, n, n, n),
                                 D).reshape(-1)
            acc = torch.zeros(nu)
            for r in range(int((ends - start).max())):
                has = torch.as_tensor(start + r < ends)
                at = torch.as_tensor(np.minimum(start + r, ends - 1))
                acc += torch.where(has, sums[pos[at]], 0.0)
            lead = torch.as_tensor(tab.lead_ends[u0:u0 + nu] < 0)
            earlier = torch.where(lead, 0.0, y[ids].float())
            y[ids] = (earlier + acc).to(BF16)
    return y


@pytest.mark.parametrize("cpb", [None, 2])
@pytest.mark.parametrize("kind", ["cylinder", "shuffled"])
@pytest.mark.parametrize("P", [2, 3, 4])
def test_lean_order_matches_fused_bf16(ref, tmp_path, P, kind, cpb):
    """The lean kernel's order of adds and roundings (`emulate_lean`) on
    the first design's schedule (and on chunks of 2 cells), single (a
    coefficient in G) and pair: within APPLY_TOL of the JAX package's
    bf16 fused engine in interpret mode (`fused_apply` with a coefficient,
    `fused_apply_pair`), and within CARD_TOL of the port's plain bf16
    version."""
    jnp, pg = ref.jnp, ref.pg
    mesh = _mesh(kind, P, tmp_path)
    disc = Discretization(mesh)
    G, D = disc._G_host, disc._D_host
    dm, ndofs = mesh.dofmap.astype(np.int64), mesh.ndofs
    rng = np.random.default_rng(P)
    cells = dm.shape[0]
    c1, c2 = rng.uniform(0.5, 2.0, cells), rng.uniform(-1.5, -0.5, cells)
    b16 = lambda a: torch.as_tensor(np.asarray(a)).to(BF16)
    x1, x2 = b16(rng.standard_normal(ndofs)), b16(rng.standard_normal(ndofs))
    jx = lambda a: jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)
    fe = pg.build_fused_engine(dm, ndofs, G, D, jnp.bfloat16)
    assert fe is not None
    host = SimpleNamespace(dofmap=dm, ndofs=ndofs, num_cells=cells)
    op = ci.build(host, G, D, BF16, "cpu", coeff=c1)
    sched = ci.chunk_schedule(op.plan, P, 2, 132, cpb=cpb)
    got = emulate_lean(op, sched, x1)
    want = np.asarray(pg.fused_apply(jx(x1.float()), jx(c1), fe, ndofs,
                                     interpret=True), np.float64)
    assert rel(got, want) <= APPLY_TOL
    assert rel(got, ci.indexed_plain(op, x1)) <= CARD_TOL
    pop = ci.build(host, G, D, BF16, "cpu", pair=(c1, c2), plan=op.plan)
    sched = ci.chunk_schedule(op.plan, P, 2, 132, pair=True, cpb=cpb)
    got2 = emulate_lean(pop, sched, x1, x2)
    want2 = np.asarray(pg.fused_apply_pair(
        jx(x1.float()), jx(c1), jx(x2.float()), jx(c2), fe, ndofs,
        interpret=True), np.float64)
    assert rel(got2, want2) <= APPLY_TOL
    assert rel(got2, ci.indexed_pair_plain(pop, x1, x2)) <= CARD_TOL


# ---------------------------------------------------------------------------
# Routing, counters and the wrappers' refusals
# ---------------------------------------------------------------------------

def _degrees(macro: str) -> set:
    """The degrees that `macro` lists in ``indexed_lean.cu``."""
    text = (_build.CSRC / "indexed_lean.cu").read_text()
    line = re.search(rf"#define {macro}\(M\)(.*?)\n(?!  )", text,
                     re.S).group(1)
    return {int(d) for d in re.findall(r"M\((\d+)\)", line)}


def test_lean_instances_match_the_routing():
    """``indexed_lean.cu`` instantiates the lean kernel exactly at the
    degrees that the wrappers route to it, single and pair, and P = 4 (the
    bodyfit bowls') is among them in both forms; float32 and float64 never
    run it."""
    for pair, macro in ((False, "FUSTPU_LEAN_CHUNK_SINGLE"),
                        (True, "FUSTPU_LEAN_CHUNK_PAIR")):
        assert _degrees(macro) == {P for P in range(2, 11)
                                   if ci.lean_runs(P, pair, BF16)}
        assert (4, pair) in ci.LEAN_BF16
        for P in range(2, 11):
            assert ci.design(P, pair, BF16) == (
                "lean" if (P, pair) in ci.LEAN_BF16 else "first")
            for dtype in (torch.float32, torch.float64):
                assert not ci.lean_runs(P, pair, dtype)
                assert ci.design(P, pair, dtype) == "first"


@pytest.mark.parametrize("P", range(2, 11))
def test_kernel_names_follow_the_routing(tmp_path, P):
    """A bf16 model's indexed stiffness names the counter that its apply
    moves: `indexed[_pair]_bf16` on the lean kernel, `..._first_walk` on the
    first design (``cuda_stiffness.bf16_key``); both are counters, and the
    first design's comparison counters are among the counters a replayed
    graph adds to."""
    mesh = _mesh("shuffled", P, tmp_path)
    disc = Discretization(mesh)
    c = np.ones(mesh.num_cells)
    for pair, kw in ((False, {}), (True, {"pair": (c, c)})):
        st = IndexedStiffness(disc.stiffness_op(BF16, "cpu", **kw), "cuda")
        name = "indexed_pair" if pair else "indexed"
        assert st.kernel == cs.bf16_key(name, ci.lean_runs(P, pair, BF16))
        assert st.kernel in ci.bf16_launches
        st32 = IndexedStiffness(disc.stiffness_op(torch.float32, "cpu",
                                                  **kw), "cuda")
        assert st32.kernel == name
    assert any(d is ci.comparison_launches for d in launch.counter_dicts())
    ci.comparison_launches["indexed_first_bf16"] = 1
    ci.reset_launches()
    assert not any(ci.comparison_launches.values())


class _OnCard(torch.Tensor):
    """A CPU tensor that the wrappers take for a card tensor, so that their
    checks run; `_build.load` is replaced, so nothing launches."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_wrappers_refuse_before_any_launch(monkeypatch):
    """The first bf16 chunk kernel's comparison entry points take bfloat16
    only, single and pair; a bf16 apply on the lean kernel with G off 16 B
    (the bulk copies need it) or with a wrong degree of x, the main path's
    wrappers as the comparison's: each raises before any launch."""
    def refuse():
        raise AssertionError("launched")

    monkeypatch.setattr(_build, "load", refuse)
    on_card = lambda o: o._replace(**{
        f: v.as_subclass(_OnCard) for f, v in o._asdict().items()
        if isinstance(v, torch.Tensor)})
    mesh = _mesh("shuffled", 4, None)
    disc = Discretization(mesh)
    c = np.ones(mesh.num_cells)
    x32 = torch.zeros(mesh.ndofs).as_subclass(_OnCard)
    x16 = torch.zeros(mesh.ndofs, dtype=BF16).as_subclass(_OnCard)
    op32 = on_card(disc.stiffness_op(torch.float32, "cpu"))
    pop32 = on_card(disc.stiffness_op(torch.float32, "cpu", pair=(c, c)))
    with pytest.raises(ValueError, match="bfloat16"):
        ci.indexed_first(op32, x32)
    with pytest.raises(ValueError, match="bfloat16"):
        ci.indexed_pair_first(pop32, x32, x32)
    op16 = disc.stiffness_op(BF16, "cpu")
    pop16 = disc.stiffness_op(BF16, "cpu", pair=(c, c))
    # G one cell further on: contiguous, the right shape, not 16 B-aligned
    nnn = 125
    off = torch.zeros(mesh.num_cells + 1, 6, nnn, dtype=BF16)[1:]
    assert (6 * nnn * 2) % 16
    for wrapper, o, xs in ((ci.indexed, op16, (x16,)),
                           (ci.indexed_first, op16, (x16,)),
                           (ci.indexed_pair, pop16, (x16, x16)),
                           (ci.indexed_pair_first, pop16, (x16, x16))):
        with pytest.raises(ValueError, match="16 B-aligned"):
            wrapper(on_card(o._replace(G=off)), *xs)
        short = torch.zeros(mesh.ndofs - 1, dtype=BF16).as_subclass(_OnCard)
        with pytest.raises(ValueError, match="shape"):
            wrapper(on_card(o), *([short] * len(xs)))


def test_exp_engine_bf16_indexed_demo_on_cpu(capsys):
    """`exp_engine_bf16 --indexed` on a small box on the CPU, where both
    designs are the plain versions: at each degree, single and pair, the
    first design timed in turns, and the lean kernel beside it where the
    main path runs it, the two equal."""
    from fustpu_torch.demos import exp_engine_bf16

    out = exp_engine_bf16.main(["--indexed", "--nc", "3", "2", "2",
                                "--degrees", "2", "3", "--turns", "1",
                                "--device", "cpu"])
    assert set(out) == {(P, f) for P in (2, 3) for f in ("single", "pair")}
    for (P, form), r in out.items():
        assert len(r["old"]) == 2 and r["bound_ms"] > 0
        if ci.lean_runs(P, form == "pair", BF16):
            assert len(r["new"]) == 2 and r["differ"] == 0
        else:
            assert not r["new"]
    assert "host clock on the CPU" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card_meshes(P, tmp_path):
    """Phase 34a's general meshes at degree P: the imported cylinder and a
    shuffled perturbed box."""
    v, c, t = shapes.cylinder_mesh(nz=4 if P <= 6 else 2, **CYL)
    path = msh_io.write_msh(str(tmp_path / f"cyl{P}"), v, c, t)
    small = (5, 3, 7) if P <= 6 else (3, 3, 4)
    return [msh_io.read_msh(path, P, detect_extrusion=False),
            un.from_box(build_box_mesh(small, P, hi=(1.0, 0.8, 1.3),
                                       perturb=0.15, seed=P),
                        shuffle_seed=11)]


@pytest.mark.cuda
@pytest.mark.parametrize("P", [P for P in range(2, 11)
                               if ci.lean_runs(P, False, BF16)
                               or ci.lean_runs(P, True, BF16)])
def test_lean_chunk_matches_first_design_on_card(P, tmp_path):
    """At a degree that runs the lean kernel, the main path's output
    against the first bf16 chunk kernel's on the same bf16 inputs and the
    same schedule, single (with a coefficient) and pair, each form where
    it runs the lean kernel: bitwise (the gate allows 1e-3 with 1% of the
    values differing; the design keeps every sum's terms and order); both
    within CARD_TOL of the plain version; two applies bitwise; each
    counted in its own counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    ci.reset_launches()
    rng = np.random.default_rng(P)
    lean_keys, compared = set(), 0
    for mesh in _card_meshes(P, tmp_path):
        disc = Discretization(mesh)
        c1 = rng.uniform(0.5, 2.0, mesh.num_cells)
        c2 = rng.uniform(-1.5, -0.5, mesh.num_cells)
        xs = [torch.as_tensor(rng.standard_normal(mesh.ndofs),
                              device="cuda").to(BF16) for _ in range(2)]
        for kw in ({"coeff": c1}, {"pair": (c1, c2)}):
            pair = "pair" in kw
            if not ci.lean_runs(P, pair, BF16):
                continue
            lean, first, plain = (
                (ci.indexed_pair, ci.indexed_pair_first,
                 ci.indexed_pair_plain) if pair else
                (ci.indexed, ci.indexed_first, ci.indexed_plain))
            lean_keys.add(cs.bf16_key(lean.__name__))
            op = disc.stiffness_op(BF16, "cuda", **kw)
            a = xs[:1 + pair]
            y, y0 = lean(op, *a), first(op, *a)
            compared += 1
            yp = plain(op, *a)
            torch.cuda.synchronize()
            assert torch.equal(y, y0), (kw.keys(), int((y != y0).sum()))
            assert rel(y.cpu(), yp.cpu()) <= CARD_TOL
            assert torch.equal(lean(op, *a), y)
    assert all(bool(v) == (k in lean_keys)
               for k, v in ci.bf16_launches.items()), ci.bf16_launches
    assert sum(ci.comparison_launches.values()) == compared > 0
    assert not any(ci.launches.values())


@pytest.mark.cuda
def test_captured_solve_on_the_lean_kernel_on_card():
    """A two-layer Westervelt model in bf16 on a shuffled general box at
    P = 4 runs the lean pair kernel; 10 steps of its captured solve (CUDA
    graphs whose class launches overlap, programmatic dependent launches)
    are bitwise the same steps launched eagerly, and both count 4 launches
    a step of `indexed_pair_bf16`."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    L = 0.006
    mesh = un.from_box(build_box_mesh((5, 4, 4), 4, hi=(L, L, L),
                                      perturb=0.1, seed=3), shuffle_seed=3)
    ext = mesh.boundary_facets()
    on_x0 = mesh.facet_centroids(ext)[:, 0] < 1e-9
    x = mesh.cell_corners_flat.mean(axis=1)[:, 0]
    model = WesterveltModel(
        mesh, Material(sound_speed=np.where(x < L / 2, 1500.0, 1590.0),
                       density=np.where(x < L / 2, 1000.0, 1050.0),
                       nonlinearity=100.0, attenuation_dB=50.0),
        Source(frequency=0.5e6, amplitude=60000.0), ext[on_x0],
        ext[~on_x0], dtype=BF16, device="cuda", stiffness_impl="indexed")
    assert model.stiffness.kernel == "indexed_pair_bf16"
    dt, _ = model.cfl_dt()
    s0 = model.init_state()
    model.solve(s0, dt, 10)                    # capture
    ci.reset_launches()
    cap = model.solve(s0, dt, 10)[0]
    torch.cuda.synchronize()
    n_cap = dict(ci.bf16_launches)
    ci.reset_launches()
    eag = model.solve_eager(s0, dt, 10)[0]
    torch.cuda.synchronize()
    assert torch.equal(cap.u, eag.u) and torch.equal(cap.v, eag.v)
    assert n_cap == ci.bf16_launches and n_cap["indexed_pair_bf16"] == 40
    assert float(cap.u.float().abs().max()) > 0
