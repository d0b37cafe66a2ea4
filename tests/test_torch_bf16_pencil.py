"""The bfloat16 G-stream z-pencil walk redesigned for Hopper (the lean walk,
``fustpu_torch/csrc/pencil_lean.cuh``; #1 / #2 on box pencils through
``ops/cuda_stiffness``, #6 on extruded stacks through
``ops/cuda_extruded``).

On the CPU: the lean walk's schedules and shared-memory layout at P = 2..10,
single and pair, box and stack (every cell once, no node shared inside a
class, the block's shared bytes within the card's 232,448 with no static
part, the bulk spans 16 B-aligned inside G, the float rows 16 B-aligned); a
float32 emulation of the bfloat16 walk in the lean schedule's order of adds
against the JAX package's bfloat16 Pallas kernels in interpret mode and
against the plain version; the routing of an apply to the lean walk or the
first design, the same degrees as the CUDA sources instantiate, and the
comparison wrappers' refusals before any launch.  On the card (`-m cuda`,
skipped here): at each degree that runs the lean walk, the main path's
output against the first bfloat16 walk's, each on its own schedule (the
redesign gate), against the plain version, two applies bitwise.  The JAX
package is imported inside the tests that compare against it (the `ref`
fixture).
"""

from __future__ import annotations

import functools
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fustpu_torch import _build
from fustpu_torch.mesh import msh_io, shapes
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.mesh.extruded import as_extruded
from fustpu_torch.mesh.unstructured import from_box
from fustpu_torch.models.discretization import Discretization
from fustpu_torch.ops import cuda_extruded as ce
from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.ops import precompute as pre

torch.set_num_threads(1)

BF16 = torch.bfloat16
# one bf16 apply of the port against one of the JAX package
APPLY_TOL = 1e-2
# a bf16 kernel, or its emulation, against its plain version on the same
# bf16 inputs (the plain version rounds y once, the walk once a class)
CARD_TOL = 2.0 ** -7
# the redesign gate: the lean walk against the first bfloat16 walk on the
# same inputs (PERF.md section 2): rel-l2 and the share of values differing
GATE_TOL, GATE_SHARE = 1e-3, 0.01
CYL = dict(radius=0.012, length=0.02, piston_radius=0.008, m=3, mr=1,
           nr_ann=1)
BOX_SHAPES = [(1, 1, 1), (3, 4, 5), (2, 1, 7), (5, 3, 7), (64, 40, 40)]
SMEM_BLOCK = 232_448


def rel(a, b):
    f = lambda t: (t.double().numpy() if isinstance(t, torch.Tensor)
                   else np.asarray(t, np.float64))
    a, b = f(a).reshape(-1), f(b).reshape(-1)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's structured Pallas module; skips where JAX is
    missing."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from fustpu.ops import pallas_stiffness as ps

    return SimpleNamespace(jax=jax, jnp=jnp, ps=ps)


# ---------------------------------------------------------------------------
# The lean walk's schedules and layout
# ---------------------------------------------------------------------------

def _check_spans(ch, cb, total, stage_bytes):
    """Every bulk-copy span 16 B-aligned, inside G, covering its chunk's
    run (short of it only at G's end, by less than 16 B) and inside its
    stage."""
    start, end = ch[:, 0] * cb, (ch[:, 0] + ch[:, 1]) * cb
    off, nbytes = ch[:, 2], ch[:, 3]
    assert (off % 16 == 0).all() and (nbytes % 16 == 0).all()
    assert (off >= 0).all() and (off + nbytes <= total).all()
    assert (off <= start).all() and (start - off < 16).all()
    short = end - (off + nbytes)
    assert ((short <= 0) | ((end == total) & (short < 16))).all()
    assert (start - off + ch[:, 1] * cb <= stage_bytes).all()


def _check_layout(P, sched, pair, ids):
    """The schedule's shared bytes are the lean walk's layout and fit a
    block with nothing static; the float rows after the head and the
    stages start on 16 B (their float4 reads)."""
    n = P + 1
    stage, smem = cs.lean_smem(P, sched.cpb, pair, sched.stages, ids)
    assert (sched.stage_bytes, sched.smem) == (stage, smem)
    assert smem <= SMEM_BLOCK and sched.stages >= 2
    assert 1 <= sched.cpb and n * n * sched.cpb <= 256
    head = cs._round16(8 * sched.stages) + cs._round16(8 * 3 * 5) + (
        cs._round16(4 * 3 * n * n) if ids else 0)
    kp = -(-n // 4) * 4
    assert (head + sched.stages * stage) % 16 == 0 and (n * n * kp) % 4 == 0
    rows = n * n * (sched.cpb * P + 1)
    floats = 4 * sched.cpb * n * n * kp + 2 * rows + (
        2 * rows + 4 * sched.cpb if pair else 0)
    assert smem == head + sched.stages * stage + 4 * floats


@pytest.mark.parametrize("P", range(2, 11))
def test_lean_box_schedule(P):
    """The lean walk's box schedule, single and pair, on boxes of 1 to
    102,400 cells: its layout; every cell once; no two pencils of a class
    share a node; the chunk's node (0, 0, 0) in the grid; the spans."""
    for nc in BOX_SHAPES:
        ncx, ncy, ncz = nc
        for pair in (False, True):
            sched = cs.pencil_schedule(nc, P, 2, sms=132, pair=pair,
                                       design="lean")
            _check_layout(P, sched, pair, ids=False)
            ch = sched.chunks
            covered = np.zeros(ncx * ncy * ncz, np.int64)
            for c0, m, *_ in ch:
                assert 1 <= m <= sched.cpb
                covered[c0:c0 + m] += 1
            assert (covered == 1).all()
            a, b, c = np.unravel_index(ch[:, 0], nc)
            grid = tuple(m * P + 1 for m in nc)
            assert (ch[:, 4] == np.ravel_multi_index(
                (a * P, b * P, c * P), grid)).all()
            for first, pencils, per in sched.classes:
                rows = ch[first:first + pencils * per].reshape(pencils, per,
                                                               5)
                ab = np.stack(np.unravel_index(rows[:, 0, 0] // ncz,
                                               (ncx, ncy)), 1)
                near = (np.abs(ab[:, None] - ab[None]) <= 1).all(-1)
                np.fill_diagonal(near, False)
                assert not near.any()          # whole pencils: z always meets
            _check_spans(ch, 6 * (P + 1) ** 3 * 2, ncx * ncy * ncz * 6
                         * (P + 1) ** 3 * 2, sched.stage_bytes)


def _footprint(kind, P, directory):
    """A structured footprint (3 x 2 stacks of 7 layers) or the imported
    cylinder (4 layers)."""
    if kind == "structured":
        return as_extruded(from_box(build_box_mesh((3, 2, 7), P),
                                    shuffle_seed=11))
    v, c, t = shapes.cylinder_mesh(nz=4, **CYL)
    return msh_io.read_msh(msh_io.write_msh(str(Path(directory) / "f"), v, c,
                                            t), P)


@pytest.mark.parametrize("P", range(2, 11))
def test_lean_stack_schedule(tmp_path, P):
    """The lean walk's stack schedule, single and pair, with the chosen
    segments and with stacks cut in 3, on a structured and an imported
    footprint: its layout; every cell once; each segment's row ids its
    stack's; no two segments of a class share a dof; the spans."""
    for kind in ("structured", "imported"):
        mesh = _footprint(kind, P, tmp_path)
        nz, ns = mesh.nz, mesh.rows2d.shape[0]
        gz = nz * P + 1
        colour = ce.colour_stacks(mesh.rows2d)
        for pair in (False, True):
            for segments in (None, 3):
                sched = ce.stack_schedule(colour, mesh.rows2d, nz, P, 2,
                                          sms=132, pair=pair,
                                          segments=segments, design="lean")
                _check_layout(P, sched, pair, ids=True)
                ch = sched.chunks
                covered = np.zeros(ns * nz, np.int64)
                for c0, m, *_ in ch:
                    covered[c0:c0 + m] += 1
                assert (covered == 1).all()
                assert (ch[:, 4] == (ch[:, 0] % nz) * P).all()
                seg = 0
                for first, count, per in sched.classes:
                    seen = np.zeros(mesh.n2d * gz, np.int64)
                    for u in range(count):
                        rows = ch[first + u * per:first + (u + 1) * per]
                        s = rows[0, 0] // nz
                        assert ((rows[:, 0] // nz) == s).all()
                        assert np.array_equal(sched.ids[seg], mesh.rows2d[s])
                        z0 = rows[0, 0] % nz
                        z1 = (rows[-1, 0] + rows[-1, 1] - 1) % nz + 1
                        dofs = (mesh.rows2d[s][:, None] * gz + np.arange(
                            z0 * P, z1 * P + 1)[None, :]).reshape(-1)
                        seen[dofs] += 1
                        seg += 1
                    assert seen.max() <= 1
                _check_spans(ch, 6 * (P + 1) ** 3 * 2,
                             ns * nz * 6 * (P + 1) ** 3 * 2,
                             sched.stage_bytes)


# ---------------------------------------------------------------------------
# The walk's order of adds, emulated, against the JAX package
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


def emulate_bf16(op, sched, x1, x2=None):
    """The bfloat16 walk on the bf16 operator `op` under `sched`, emulated
    in float32: class by class, each node of a class starts from the
    bfloat16 y that the earlier classes left, each cell's contribution
    (widened inputs, float32 arithmetic) is added chunk by chunk of each
    pencil, even cells of a chunk, then odd, and the class's nodes round
    to bfloat16 once at its end (a pencil's nodes belong to one block,
    whose carried faces stay float)."""
    P, n = op.P, op.P + 1
    _, ncy, ncz = op.nc
    g = op.G.float().reshape(-1, 6, n, n, n)
    D = op.D.float()
    xf1 = x1.float()
    xf2 = None if x2 is None else x2.float()
    r = torch.arange(n)
    y = torch.zeros(x1.shape, dtype=BF16)
    for first, pencils, per in sched.classes:
        yf, mine = y.float(), torch.zeros(x1.shape, dtype=torch.bool)
        for q in range(per):
            rows = sched.chunks[first + np.arange(pencils) * per + q]
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
                u = xf1[idx]
                if xf2 is not None:
                    cc = op.C.float()[cells][:, :, None, None, None]
                    u = cc[:, 0] * u + cc[:, 1] * xf2[idx]
                yf.index_put_(idx, _cell_contrib(u, g[cells], D),
                              accumulate=True)
                mine[idx] = True
        y = torch.where(mine, yf.to(BF16), y)
    return y


@functools.lru_cache(maxsize=None)
def _case(P, nc):
    mesh = build_box_mesh(nc, P, hi=(1.0, 0.8, 1.3), perturb=0.15, seed=7)
    _, G = pre.cell_geometry_factors(mesh)
    rng = np.random.default_rng(P)
    return dict(mesh=mesh, G=G, D=mesh.element.deriv_1d,
                coeff=rng.uniform(0.5, 2.0, mesh.nc),
                c2=rng.uniform(-2.0, 2.0, mesh.nc),
                x1=rng.standard_normal(mesh.grid_shape),
                x2=rng.standard_normal(mesh.grid_shape))


@pytest.mark.parametrize("small_card", [False, True])
@pytest.mark.parametrize("P", [2, 4])
def test_lean_order_matches_fustpu_bf16(ref, P, small_card):
    """The lean schedule's order of adds and roundings (`emulate_bf16`),
    single (a coefficient in G) and pair, on a box with odd ncz, on a card
    of 132 SMs (one chunk a pencil) and on one that holds a block of 2
    cells (chunks of 2, 2 and 1): within APPLY_TOL of the JAX package's
    bf16 Pallas kernels in interpret mode, and within CARD_TOL of the
    port's plain bf16 version."""
    jnp, ps = ref.jnp, ref.ps
    k = _case(P, (3, 2, 5))
    nc, D, G = k["mesh"].nc, k["D"], k["G"]
    occ = ((lambda *a: int(a[3] == 2)) if small_card
           else cs.model_occupancy)
    sched = cs.pencil_schedule(nc, P, 2, sms=1 if small_card else 132,
                               occupancy=occ, design="lean")
    assert sched.classes[0, 2] == (3 if small_card else 1)
    b16 = lambda a: torch.as_tensor(np.asarray(a)).to(BF16)
    x1, x2 = b16(k["x1"]), b16(k["x2"])
    jx = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    fop = ps.build(nc, P, D, G, jnp.bfloat16, coeff=k["coeff"])
    want = np.asarray(ps.stiffness_apply_pallas(fop, jx(x1), interpret=True)
                      ).astype(np.float64)
    op = cs.CellStiffness(G=b16(cs.pack_G(G, k["coeff"])), D=b16(D), nc=nc)
    got = emulate_bf16(op, sched, x1)
    assert rel(got, want.reshape(got.shape)) <= APPLY_TOL
    assert rel(got, cs.stiffness_plain(op, x1)) <= CARD_TOL
    fpair = ps.build_pair(nc, P, D, G, jnp.bfloat16, k["coeff"], k["c2"])
    want2 = np.asarray(ps.stiffness_apply_pallas_pair(
        fpair, jx(x1), jx(x2), interpret=True)).astype(np.float64)
    C = np.stack([k["coeff"].reshape(-1), k["c2"].reshape(-1)], axis=1)
    pop = cs.CellStiffness(G=b16(cs.pack_G(G)), D=b16(D), nc=nc, C=b16(C))
    got2 = emulate_bf16(pop, sched, x1, x2)
    assert rel(got2, want2.reshape(got2.shape)) <= APPLY_TOL
    assert rel(got2, cs.stiffness_pair_plain(pop, x1, x2)) <= CARD_TOL


# ---------------------------------------------------------------------------
# Routing and the wrappers' refusals
# ---------------------------------------------------------------------------

def test_bf16_applies_run_the_lean_walk():
    """A bfloat16 apply on box pencils runs the lean walk unless its degree
    keeps the first design (`FIRST_DESIGN_BF16`), one on stacks at
    `LEAN_STACK_DEGREES` only (P = 4); float32 and float64 never do."""
    for P in range(2, 11):
        for pair in (False, True):
            assert cs.lean_runs(P, pair, BF16) == (
                (P, pair) not in cs.FIRST_DESIGN_BF16)
            assert not cs.lean_runs(P, pair, torch.float32)
            assert not cs.lean_runs(P, pair, torch.float64)
        assert ce.lean_runs(P, BF16) == (P == 4)
        assert not ce.lean_runs(P, torch.float32)
        assert not ce.lean_runs(P, torch.float64)
    assert (4, False) not in cs.FIRST_DESIGN_BF16
    assert (4, True) not in cs.FIRST_DESIGN_BF16


def _degrees(source: str, macro: str) -> set:
    """The degrees that `macro` lists in the CUDA source `source`."""
    text = (_build.CSRC / source).read_text()
    line = re.search(rf"#define {macro}\(M\)(.*)", text).group(1)
    return {int(d) for d in re.findall(r"M\((\d+)\)", line)}


def test_lean_instances_match_the_routing():
    """The CUDA sources instantiate the lean walk exactly at the degrees
    that the wrappers route to it: box single and pair
    (``stiffness_lean.cu``), stacks (``extruded_lean.cu``)."""
    for pair, macro in ((False, "FUSTPU_LEAN_SINGLE"),
                        (True, "FUSTPU_LEAN_PAIR")):
        assert _degrees("stiffness_lean.cu", macro) == {
            P for P in range(2, 11) if cs.lean_runs(P, pair, BF16)}
    assert _degrees("extruded_lean.cu", "FUSTPU_LEAN_STACKS") == set(
        ce.LEAN_STACK_DEGREES)


class _OnCard(torch.Tensor):
    """A CPU tensor that the wrappers take for a card tensor, so that their
    checks run; `_build.load` is replaced, so nothing launches."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_wrappers_refuse_before_any_launch(monkeypatch):
    """The first bfloat16 walk's comparison entry points take bfloat16
    only, box pencils and stacks, single and pair: given float32 they
    raise before any launch."""
    def refuse():
        raise AssertionError("launched")

    monkeypatch.setattr(_build, "load", refuse)
    on_card = lambda o: o._replace(**{
        f: v.as_subclass(_OnCard) for f, v in o._asdict().items()
        if isinstance(v, torch.Tensor)})
    box = build_box_mesh((3, 2, 5), 4)
    stacks = as_extruded(from_box(build_box_mesh((3, 2, 5), 4),
                                  shuffle_seed=11))
    for mesh, single, pair in (
            (box, cs.stiffness_first, cs.stiffness_pair_first),
            (stacks, ce.extruded_first, ce.extruded_pair_first)):
        disc = Discretization(mesh)
        x = torch.zeros(mesh.grid_shape).as_subclass(_OnCard)
        with pytest.raises(ValueError, match="bfloat16"):
            single(on_card(disc.stiffness_op(torch.float32, "cpu")), x)
        c = np.ones(mesh.nc if hasattr(mesh, "nc") else mesh.num_cells)
        op2 = on_card(disc.stiffness_op(torch.float32, "cpu", pair=(c, c)))
        with pytest.raises(ValueError, match="bfloat16"):
            pair(op2, x, x)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card_meshes(P, tmp_path):
    """(route, mesh) of phase 34a's box and stacks at degree P."""
    v, c, t = shapes.cylinder_mesh(nz=4 if P <= 6 else 2, **CYL)
    path = msh_io.write_msh(str(tmp_path / f"cyl{P}"), v, c, t)
    small = (5, 3, 7) if P <= 6 else (3, 3, 5)
    return [("box", build_box_mesh(small, P, hi=(1.0, 0.8, 1.3),
                                   perturb=0.15, seed=P)),
            ("stacks", msh_io.read_msh(path, P)),
            ("stacks", as_extruded(from_box(build_box_mesh(
                (5, 3, 7) if P <= 6 else (3, 3, 4), P), shuffle_seed=11)))]


@pytest.mark.cuda
@pytest.mark.parametrize("P", [P for P in range(2, 11)
                               if cs.lean_runs(P, False, BF16)])
def test_lean_walk_matches_first_design_on_card(P, tmp_path):
    """At a degree that runs the lean walk, the main path's output (the
    lean walk on its own schedule) against the first bfloat16 walk's on
    its own schedule on the same bf16 inputs, box and stacks, single (with
    a coefficient) and pair, each form where it runs the lean walk: within
    the redesign gate (GATE_TOL, at most GATE_SHARE of the values
    differing), as under the lean walk's schedule; both within CARD_TOL of
    the plain version; two applies bitwise; each counted in its own
    counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    forms = {"box": ((cs.stiffness, cs.stiffness_pair),
                     (cs.stiffness_first, cs.stiffness_pair_first),
                     (cs.stiffness_plain, cs.stiffness_pair_plain)),
             "stacks": ((ce.extruded, ce.extruded_pair),
                        (ce.extruded_first, ce.extruded_pair_first),
                        (ce.extruded_plain, ce.extruded_pair_plain))}
    runs = {"box": lambda pair: cs.lean_runs(P, pair, BF16),
            "stacks": lambda pair: ce.lean_runs(P, BF16)}
    for mod in (cs, ce):
        mod.reset_launches()
    rng = np.random.default_rng(P)
    lean_keys, compared = set(), {"box": 0, "stacks": 0}
    for route, mesh in _card_meshes(P, tmp_path):
        disc = Discretization(mesh)
        shape = mesh.nc if hasattr(mesh, "nc") else (mesh.num_cells,)
        c1 = rng.uniform(0.5, 2.0, shape)
        c2 = rng.uniform(-1.5, -0.5, shape)
        xs = [torch.as_tensor(rng.standard_normal(mesh.grid_shape),
                              device="cuda").to(BF16) for _ in range(2)]
        for kw in ({"coeff": c1}, {"pair": (c1, c2)}):
            pair = "pair" in kw
            if not runs[route](pair):
                continue
            lean, first, plain = (f[pair] for f in forms[route])
            lean_keys.add(cs.bf16_key(lean.__name__))
            op = disc.stiffness_op(BF16, "cuda", **kw)
            a = xs[:1 + pair]
            if route == "box":
                mine = dict(cpb=cs.card_schedule(op, a[0], pair).cpb)
            else:
                s = ce.card_schedule(op, a[0], pair)
                mine = dict(cpb=s.cpb, segments=s.segments)
            y, y0, y1 = lean(op, *a), first(op, *a), first(op, *a, **mine)
            compared[route] += 2
            yp = plain(op, *a)
            torch.cuda.synchronize()
            for yf, where in ((y0, "own"), (y1, "lean's")):
                share = float((y != yf).double().mean())
                assert rel(y.cpu(), yf.cpu()) <= GATE_TOL and \
                    share <= GATE_SHARE, (route, kw, where, mine, share)
            assert rel(y.cpu(), yp.cpu()) <= CARD_TOL
            assert rel(y0.cpu(), yp.cpu()) <= CARD_TOL
            assert torch.equal(lean(op, *a), y)
    counted = {**cs.bf16_launches, **ce.bf16_launches}
    assert all(bool(v) == (k in lean_keys) for k, v in counted.items()), \
        counted
    assert sum(cs.comparison_launches.values()) == compared["box"] > 0
    assert sum(ce.comparison_launches.values()) == compared["stacks"]
