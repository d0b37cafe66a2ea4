"""The port's measurement kernels against the JAX package: the kernel
anatomy variants (``ops/anatomy``, kernel #13, on the z-pencil walk and
on the parity-class design), the G layout sum and the relayout
permutations (``ops/probes``, kernels #12 and #14).  Their plain versions
against the JAX package's matmul operator, the JAX demos' own kernels in
interpret mode and numpy, on the CPU; the anatomy's dispatch by design,
its pencil schedule against #1's, and an f64 emulation of `gstream` in
the walk's order; the three experiment demos on the CPU; and, on a card,
the CUDA kernels against the plain versions.

``demos/exp_kernel_anatomy.make_variant`` cannot run as committed (it
unpacks 11 refs where ``_split_mats`` gives 4 matrices), so the anatomy
variants are held against what they compute: the operator, or the
operator with the constant metric (0, 0, 0, 1, 0, 1).

    python -m pytest --noconftest tests/test_torch_probes.py -m cuda
"""

import functools

import numpy as np
import pytest
import torch

from fustpu_torch.demos import (exp_g_layout, exp_kernel_anatomy,
                                exp_mosaic_relayout)
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.ops import anatomy
from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.ops import precompute as pre
from fustpu_torch.ops import probes

torch.set_num_threads(1)

F64 = torch.float64
TOL = 1e-12      # f64 gate, the reference's own operator tolerance
F32_TOL = 1e-6   # the reference's f32 operator gate


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@functools.lru_cache(maxsize=None)
def _case(P, nc=(3, 2, 4)):
    mesh = build_box_mesh(nc, P, hi=(1.0, 0.8, 1.3), perturb=0.15, seed=P)
    _, G = pre.cell_geometry_factors(mesh)
    x = np.random.default_rng(P).standard_normal(mesh.grid_shape)
    return mesh, G, x


def _op(mesh, G, dtype=F64, device="cpu"):
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return cs.CellStiffness(G=t(cs.pack_G(G)), D=t(mesh.element.deriv_1d),
                            nc=mesh.nc)


@pytest.mark.parametrize("name", ["full", "ywin", "contract"])
@pytest.mark.parametrize("P", [2, 3, 4])
def test_anatomy_plain_matches_spectral_mm(P, name):
    """full and ywin compute the operator, contract the operator with the
    constant metric (0, 0, 0, 1, 0, 1) (what `mxu` computes): each against
    the JAX package's matmul formulation."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fustpu.ops import spectral_mm as f_mm

    mesh, G, x = _case(P)
    if name == "contract":
        G = np.zeros_like(G)
        G[..., 3] = G[..., 5] = 1.0
    fop = f_mm.build_stiffness(mesh.nc, P, mesh.element.deriv_1d, G,
                               jnp.float64)
    want = f_mm.stiffness_apply_mm(fop, jnp.asarray(x))
    got = anatomy.variant(_op(mesh, _case(P)[1]), torch.as_tensor(x), name)
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("P", [2, 4])
def test_gstream_plain_matches_numpy(P):
    """gstream: per cell, y_node += (G00 + 2 G01 + 2 G02 + G11 + 2 G12 +
    G22) u_node, summed into the shared nodes."""
    mesh, G, x = _case(P)
    w = G @ np.array([1.0, 2.0, 2.0, 1.0, 2.0, 1.0])      # (cells, n^3)
    dofmap = mesh.dofmap
    want = np.zeros(mesh.ndofs)
    np.add.at(want, dofmap.ravel(), (w * x.reshape(-1)[dofmap]).ravel())
    got = anatomy.variant(_op(mesh, G), torch.as_tensor(x), "gstream")
    assert rel(got.reshape(-1), want) <= TOL


def test_anatomy_rejects_an_unknown_variant():
    mesh, G, x = _case(2)
    with pytest.raises(ValueError, match="expected one of"):
        anatomy.variant(_op(mesh, G), torch.as_tensor(x), "vpu")


@pytest.mark.parametrize("design", anatomy.DESIGNS)
@pytest.mark.parametrize("name", anatomy.VARIANTS)
def test_anatomy_dispatch_on_cpu(name, design):
    """Either design's wrapper takes the plain version for a CPU tensor;
    `variant_classes` / `full_pair_classes` are the classes design."""
    mesh, G, x = _case(2)
    op, xt = _op(mesh, G), torch.as_tensor(x)
    y = anatomy.variant(op, xt, name, design)
    assert torch.equal(y, anatomy.variant_plain(op, xt, name))
    assert torch.equal(anatomy.variant_classes(op, xt, name), y)
    C = torch.as_tensor(np.random.default_rng(1).uniform(
        0.5, 2.0, (mesh.num_cells, 2)))
    pop = op._replace(C=C)
    want = cs.stiffness_pair_plain(pop, xt, 2 * xt)
    assert torch.equal(anatomy.full_pair(pop, xt, 2 * xt, design), want)
    assert torch.equal(anatomy.full_pair_classes(pop, xt, 2 * xt), want)
    assert anatomy.counter(name, design) in anatomy.launches


def test_anatomy_rejects_an_unknown_design():
    mesh, G, x = _case(2)
    op, xt = _op(mesh, G), torch.as_tensor(x)
    with pytest.raises(ValueError, match="design 'lanes'"):
        anatomy.variant(op, xt, "full", "lanes")
    with pytest.raises(ValueError, match="design 'lanes'"):
        anatomy.full_pair(op, xt, xt, "lanes")
    with pytest.raises(ValueError, match="expected one of"):
        anatomy.variant_schedule((2, 2, 2), 2, 8, 132, "vpu")


def test_pencil_variants_refuse_before_any_launch(monkeypatch):
    """On card tensors the walk's variants launch or raise: misaligned G
    or x, a field of the wrong dtype or shape raise before the kernel
    library is loaded or a schedule built."""
    from fustpu_torch import _build

    class OnCard(torch.Tensor):
        is_cpu = False
        is_cuda = True
        device = torch.device("cuda", 0)

        def get_device(self):
            return 0

    def refuse(*args, **kwargs):
        raise AssertionError("the variant reached the kernel library")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(anatomy, "_card_schedule", refuse)
    mesh, G, x = _case(2)
    op = _op(mesh, G)
    card = op._replace(G=op.G.as_subclass(OnCard), D=op.D.as_subclass(OnCard))
    xc = torch.as_tensor(x).as_subclass(OnCard)
    base = torch.zeros(op.G.numel() + 1, dtype=F64)
    base[1:].copy_(op.G.reshape(-1))
    shifted = card._replace(G=base[1:].view(op.G.shape).as_subclass(OnCard))
    xbase = torch.zeros(xc.numel() + 1, dtype=F64)
    xbase[1:].copy_(torch.as_tensor(x).reshape(-1))
    xshift = xbase[1:].view(xc.shape).as_subclass(OnCard)
    for name in anatomy.VARIANTS:
        for o, xx, match in (
                (card, xc.to(torch.float32).as_subclass(OnCard), "G is"),
                (card, xc.reshape(-1)[1:].as_subclass(OnCard), "shape"),
                (shifted, xc, "16 B"), (card, xshift, "16 B")):
            with pytest.raises(ValueError, match=match):
                anatomy.variant(o, xx, name)


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("P", range(2, 11))
def test_variant_schedules_follow_the_pencil_schedule(P, itemsize):
    """full, gstream and ywin run #1's chunk table and classes
    (`pencil_schedule` of the box); gstream in #1's shared bytes, ywin in
    more (an area of x's z-line runs); contract reserves no ring (no
    stage, fewer shared bytes than #1's block of the same cells) and takes
    its own cells a chunk, the fewest chunk steps and on a tie the smaller
    chunk: its table is #1's at that cpb.  Stated: at the flagship's 64 x
    40 x 40 cells, P = 4, float32, under the model occupancy, contract
    takes 10 cells a chunk, #1 5 (on the card the occupancy answer, which
    counts registers, decides)."""
    for nc in ((3, 2, 4), (1, 1, 1), (2, 3, 29), (32, 32, 32), (64, 40, 40)):
        base = cs.pencil_schedule(nc, P, itemsize, 132)
        for name in anatomy.VARIANTS:
            s = anatomy.variant_schedule(nc, P, itemsize, 132, name)
            assert s.smem + cs._static_smem(P, itemsize) <= 232_448
            if name == "contract":
                assert s.stages == 0 and s.stage_bytes == 0
                assert s.smem < cs.pencil_smem(P, itemsize, s.cpb)[1]
                ref = cs.pencil_schedule(
                    nc, P, itemsize, 132, cpb=s.cpb, stages=0,
                    layout=lambda c: anatomy.variant_smem(
                        P, itemsize, c, "contract")[1:])
                steps = {c: cs._steps(nc, c, anatomy.variant_schedule(
                    nc, P, itemsize, 132, name, cpb=c).blocks)
                    for c in range(1, min(nc[2], 256 // (P + 1) ** 2) + 1)}
                assert (steps[s.cpb], s.cpb) == min(
                    (v, c) for c, v in steps.items())
                assert np.array_equal(s.classes, ref.classes)
                assert np.array_equal(s.chunks[:, [0, 1, 4]],
                                      ref.chunks[:, [0, 1, 4]])
                continue
            assert s.cpb == base.cpb and s.stages == base.stages
            assert np.array_equal(s.classes, base.classes)
            assert np.array_equal(s.chunks, base.chunks)
            assert s.stage_bytes == base.stage_bytes
            assert (s.smem > base.smem) == (name == "ywin")
    if P == 4 and itemsize == 4:
        assert anatomy.variant_schedule((64, 40, 40), 4, 4, 132,
                                        "contract").cpb == 10
        assert cs.pencil_schedule((64, 40, 40), 4, 4, 132).cpb == 5


@pytest.mark.parametrize("small_card", [False, True],
                         ids=["132-sms", "two-cell-chunks"])
@pytest.mark.parametrize("P", [2, 4])
def test_gstream_walk_order_matches_plain(P, small_card):
    """gstream's adds in the walk's order (its schedule's classes, chunks
    and turns: even cells of a chunk, then odd), emulated in float64,
    against `gstream_plain`: on a card of 132 SMs (one chunk a pencil) and
    on one that holds a block of 2 cells (chunks of 2, 2 and 1)."""
    mesh, G, x = _case(P, (3, 2, 5))
    op, xt = _op(mesh, G), torch.as_tensor(x)
    occ = (lambda *a: int(a[3] == 2)) if small_card else cs.model_occupancy
    sched = anatomy.variant_schedule(mesh.nc, P, 8, 1 if small_card else 132,
                                     "gstream", occ, occ)
    assert sched.classes[0, 2] == (3 if small_card else 1)
    n = P + 1
    _, ncy, ncz = mesh.nc
    g = op.G.reshape(-1, 6, n, n, n)
    w = g[:, 0] + 2 * g[:, 1] + 2 * g[:, 2] + g[:, 3] + 2 * g[:, 4] + g[:, 5]
    r = torch.arange(n)
    y = torch.zeros_like(xt)
    for first, pencils, per in sched.classes:
        for q in range(per):
            rows = sched.chunks[first + np.arange(pencils) * per + q]
            for turn in (0, 1):
                cells = torch.as_tensor([c0 + i for c0, m, *_ in rows
                                         for i in range(turn, m, 2)])
                if cells.numel() == 0:
                    continue
                a, b, c = cells // (ncy * ncz), (cells // ncz) % ncy, \
                    cells % ncz
                idx = ((a * P)[:, None, None, None] + r[:, None, None],
                       (b * P)[:, None, None, None] + r[:, None],
                       (c * P)[:, None, None, None] + r)
                y.index_put_(idx, w[cells] * xt[idx], accumulate=True)
    assert rel(y, anatomy.gstream_plain(op, xt)) <= TOL


@pytest.fixture
def g_layout_demo(monkeypatch):
    """The JAX demo's module at a small G (3 x-cells, n = 3, a 6 x 12
    plane), its `pl.pallas_call` in interpret mode for this test only."""
    pytest.importorskip("jax")
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "demos" / "exp_g_layout.py"
    spec = importlib.util.spec_from_file_location("jax_exp_g_layout", path)
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    monkeypatch.setattr(demo.pl, "pallas_call", functools.partial(
        demo.pl.pallas_call, interpret=True))
    for name, v in (("NCX", 3), ("NP", 3), ("EY", 6), ("EZ", 12)):
        monkeypatch.setattr(demo, name, v)
    return demo


@pytest.mark.parametrize("layout", probes.LAYOUTS)
def test_g_weighted_sum_plain_matches_jax_demo(g_layout_demo, layout):
    """The plain version in either layout against the JAX demo's padded
    (2-D) and flat kernels, float32."""
    import jax.numpy as jnp

    demo, nc, n = g_layout_demo, (3, 2, 4), 3
    rng = np.random.default_rng(4)
    Gx = (rng.standard_normal((3, n, 6, 6, 12)) * 1e-3).astype(np.float32)
    c = rng.standard_normal((6, 12)).astype(np.float32)
    padded = np.asarray(demo.padded_sum(jnp.asarray(Gx), jnp.asarray(c)))
    flat = np.asarray(demo.flat_sum(jnp.asarray(Gx.reshape(3, n, 6, 72)),
                                    jnp.asarray(c)))
    G = probes.to_layout(probes.to_cells(torch.as_tensor(Gx), nc), layout)
    got = probes.g_weighted_sum(G, torch.as_tensor(c), nc, layout)
    assert got.dtype == torch.float32 and got.shape == (6, 12)
    assert rel(got, padded) <= F32_TOL
    assert rel(got, flat) <= F32_TOL


def test_g_layouts_hold_the_same_values():
    G = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (24, 6, 27)))
    comp = probes.to_layout(G, "components")
    assert comp.shape == (6, 24, 27)
    assert torch.equal(comp.transpose(0, 1), G)


@pytest.mark.parametrize("kind", probes.KINDS)
def test_relayout_plain_matches_numpy(kind):
    """Each permutation bitwise, on 3 tiles of (8192, 1)."""
    xn = np.random.default_rng(6).standard_normal((3 * 8192, 1)).astype(
        np.float32)
    want = {"reshape": xn.reshape(-1, 128),
            "reverse": xn.reshape(-1, 128).reshape(-1, 1),
            "transpose": xn.reshape(3, 64, 128).transpose(0, 2, 1)
            .reshape(3 * 128, 64),
            "copy": xn}[kind]
    got = probes.relayout(torch.as_tensor(xn), kind)
    assert tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)


def test_relayout_rejects_a_partial_tile():
    with pytest.raises(ValueError, match="expected"):
        probes.relayout(torch.zeros(8192 + 1, 1), "copy")


def test_demos_on_cpu(capsys):
    """The three experiment demos at small sizes on the CPU: every result
    against its plain version, and the CPU named as the clock."""
    a = exp_kernel_anatomy.main(["--nc", "2", "--degree", "2", "--device",
                                 "cpu", "--chain", "1", "--reps", "1"])
    assert set(a["outs"]["pencil"]) == set(exp_kernel_anatomy.NAMES)
    g = exp_g_layout.main(["--nc", "2", "--degree", "2", "--device", "cpu",
                           "--chain", "1", "--reps", "1"])
    assert rel(g["outs"]["cells"], g["outs"]["components"]) <= F32_TOL
    r = exp_mosaic_relayout.main(["--tiles", "2", "--device", "cpu",
                                  "--chain", "1", "--reps", "1"])
    assert all(torch.equal(r["outs"][k], r["plains"][k])
               for k in probes.KINDS)
    text = capsys.readouterr().out
    assert "full - gstream - contract" in text
    assert "not measured on the CPU" in text
    assert text.count("host clock on the CPU") == 3


def test_exp_kernel_anatomy_designs_on_cpu(capsys):
    """The anatomy demo on three cell counts with both designs in turns
    (classes, pencil, pencil, classes) on the CPU: every variant and
    full_pair its plain version's output, two turns a design."""
    out = exp_kernel_anatomy.main(["--device", "cpu", "--nc", "4", "3", "2",
                                   "--design", "both", "--chain", "1",
                                   "--reps", "1"])
    assert out["mesh"].nc == (4, 3, 2)
    for design in anatomy.DESIGNS:
        assert set(out["outs"][design]) == set(exp_kernel_anatomy.NAMES)
        for name in exp_kernel_anatomy.NAMES:
            assert torch.equal(out["outs"][design][name],
                               out["plains"][name])
            assert len(out["times"][design][name]) == 2
    text = capsys.readouterr().out
    assert "pencil: full - gstream - contract" in text
    assert "classes: full - gstream - contract" in text
    with pytest.raises(SystemExit):
        exp_kernel_anatomy.main(["--device", "cpu", "--design", "lanes"])


@pytest.mark.cuda
@pytest.mark.parametrize("P", range(2, 11))
def test_anatomy_kernels_match_plain_on_card(P):
    """Each anatomy variant's kernel, in both designs, against its plain
    version (float64 to 1e-12, float32 to 1e-6 against the float64 plain
    version), two applies bitwise; on the walk full and ywin bitwise the
    production kernel (`cuda_stiffness.stiffness`) and full_pair bitwise
    `stiffness_pair` on the same buffers; ywin of the classes design
    against the production kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    mesh, G, x = _case(P, (3, 4, 5) if P <= 6 else (2, 3, 3))
    before = dict(anatomy.launches)
    for name in anatomy.VARIANTS:
        want = anatomy.variant_plain(_op(mesh, G, F64, "cuda"),
                                     torch.as_tensor(x, device="cuda"),
                                     name).cpu()
        for dtype, tol in ((F64, TOL), (torch.float32, F32_TOL)):
            op = _op(mesh, G, dtype, "cuda")
            xd = torch.as_tensor(x, dtype=dtype, device="cuda")
            prod = cs.stiffness(op, xd)
            for design in anatomy.DESIGNS:
                y = anatomy.variant(op, xd, name, design)
                torch.cuda.synchronize()
                assert rel(y.cpu(), want) <= tol, (name, design, dtype)
                assert torch.equal(anatomy.variant(op, xd, name, design), y)
                if design == "pencil" and name in ("full", "ywin"):
                    assert torch.equal(y, prod), (name, dtype)
                elif name == "ywin":
                    assert rel(y.cpu(), prod.cpu()) <= tol
    for dtype in (F64, torch.float32):
        C = np.random.default_rng(P).uniform(0.5, 2.0, (mesh.num_cells, 2))
        op = _op(mesh, G, dtype, "cuda")._replace(
            C=torch.as_tensor(C, dtype=dtype, device="cuda"))
        xd = torch.as_tensor(x, dtype=dtype, device="cuda")
        y2 = anatomy.full_pair(op, xd, 2 * xd)
        assert torch.equal(y2, cs.stiffness_pair(op, xd, 2 * xd))
        want = cs.stiffness_pair_plain(op, xd, 2 * xd)
        assert rel(anatomy.full_pair_classes(op, xd, 2 * xd).cpu(),
                   want.cpu()) <= (TOL if dtype == F64 else F32_TOL)
    for name in (*anatomy.VARIANTS, "full_pair"):
        for design in anatomy.DESIGNS:
            k = anatomy.counter(name, design)
            assert anatomy.launches[k] == before[k] + (
                2 if name == "full_pair" else 4), k


@pytest.mark.cuda
@pytest.mark.parametrize("layout", probes.LAYOUTS)
def test_g_layout_kernel_matches_plain_on_card(layout):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    nc, n = (7, 5, 6), 5
    rng = np.random.default_rng(7)
    G = torch.as_tensor(rng.standard_normal((7 * 5 * 6, 6, n ** 3)),
                        device="cuda")
    c = torch.as_tensor(rng.standard_normal((5 * n, 6 * n)), device="cuda")
    Ga = probes.to_layout(G, layout)
    want = probes.g_weighted_sum_plain(Ga, c, nc, layout)
    assert rel(probes.g_weighted_sum(Ga, c, nc, layout).cpu(),
               want.cpu()) <= TOL
    got32 = probes.g_weighted_sum(Ga.float(), c.float(), nc, layout)
    torch.cuda.synchronize()
    assert rel(got32.cpu(), want.cpu()) <= F32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("kind", probes.KINDS)
def test_relayout_kernels_bitwise_on_card(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    for dtype in (torch.float32, torch.float64):
        x = torch.randn((5 * 8192, 1), dtype=dtype, device="cuda")
        got = probes.relayout(x, kind)
        torch.cuda.synchronize()
        assert torch.equal(got, probes.relayout_plain(x, kind))


# ---------------------------------------------------------------------------
# The relayouts' host side: the lean launch path, the copy's grid and the
# wrappers' checks (no card needed)
# ---------------------------------------------------------------------------

COUNTS = [1, 3, 27, 125, 12_800_000]


class _OnCard(torch.Tensor):
    """A CPU tensor that the wrappers take for one on card 0, so that
    their checks and launch arguments run here; `launch.launch` is
    replaced in each test that uses it, so nothing launches."""

    is_cpu = False
    is_cuda = True
    device = torch.device("cuda", 0)

    def get_device(self):
        return 0


@pytest.fixture
def no_card_launch(monkeypatch):
    """`launch.launch` recording its calls."""
    from fustpu_torch.ops import launch

    calls = []
    monkeypatch.setattr(launch, "launch",
                        lambda name, dev, *args: calls.append(
                            (name, dev, args)))
    return calls


def _copy_walk(nvec, blocks):
    """How often `relayout_copy` (csrc/probes.cu) touches each vector:
    block b takes the span [b U T, (b + 1) U T) of U = COPY_UNROLL rounds
    of T = COPY_THREADS vectors, thread t the vectors b U T + u T + t that
    lie below nvec."""
    from fustpu_torch.ops import launch

    T, U = launch.COPY_THREADS, launch.COPY_UNROLL
    v = (np.arange(blocks)[:, None, None] * U * T
         + np.arange(U)[None, :, None] * T + np.arange(T)[None, None, :])
    return np.bincount(v[v < nvec], minlength=nvec)


@pytest.mark.parametrize("nvec", COUNTS)
def test_copy_grid_covers_every_vector_once(nvec):
    from fustpu_torch.ops import launch

    blocks = launch.copy_blocks(nvec)
    assert blocks >= 1
    assert np.array_equal(_copy_walk(nvec, blocks), np.ones(nvec, np.int64))


def test_launch_resolves_each_entry_point_once(monkeypatch):
    """Two launches of one entry point resolve it once, pass the stream of
    the current card last, and raise on a non-zero return."""
    from fustpu_torch import _build
    from fustpu_torch.ops import launch

    resolved, calls = [], []

    class Lib:
        def __getattr__(self, name):
            resolved.append(name)
            return lambda *a: calls.append(a) or (7 if a[0] == "bad" else 0)

    monkeypatch.setattr(launch, "_entries", {})
    monkeypatch.setattr(_build, "load", lambda: Lib())
    monkeypatch.setattr(launch, "_api", (lambda: 0, lambda dev: 1234))
    launch.launch("fustpu_x", 0, 1, 2)
    launch.launch("fustpu_x", 0, 3, 4)
    assert resolved == ["fustpu_x"]
    assert calls == [(1, 2, 1234), (3, 4, 1234)]
    with pytest.raises(RuntimeError, match="fustpu_x kernel launch failed: "
                                           "error 7"):
        launch.launch("fustpu_x", 0, "bad")
    assert resolved == ["fustpu_x"]


@pytest.mark.parametrize("kind", probes.KINDS)
def test_relayout_launch_arguments(no_card_launch, kind):
    """On a card the wrapper launches the new kernel (the first design
    for `relayout_flat`) with its pointers, sizes and grid, and counts it
    apart from the first design."""
    probes.reset_launches()
    x = torch.zeros(3 * probes.TM, 1).as_subclass(_OnCard)
    y = probes.relayout(x, kind)
    probes.relayout_flat(x, kind)
    assert tuple(y.shape) == probes.relayout_shape(x.numel(), kind)
    (name, dev, args), (fname, _, fargs) = no_card_launch
    nbytes = x.numel() * 4
    if kind == "transpose":
        assert name == "fustpu_relayout_transpose" and args[2:] == (4, 3)
        assert fname == "fustpu_relayout_transpose_padded"
        assert fargs[2:] == (4, 3, 64, 128)
    else:
        assert name == "fustpu_relayout_copy"
        assert args[2:] == (nbytes, 12)          # 6,144 vectors, 512 a block
        assert fname == "fustpu_relayout_copy_flat" and fargs[2:] == (nbytes,)
    assert dev == 0 and args[0] == x.data_ptr()
    new = "relayout_transpose" if kind == "transpose" else "relayout_copy"
    assert probes.launches[new] == 1 and sum(probes.launches.values()) == 1
    assert sum(probes.comparison_launches.values()) == 1


@pytest.mark.parametrize("flat", [False, True])
def test_relayout_refuses_before_any_launch(no_card_launch, flat):
    """Misaligned, non-contiguous or 2-byte values on a card raise before
    the wrapper launches anything."""
    run = probes.relayout_flat if flat else probes.relayout
    n = 2 * probes.TM
    misaligned = torch.zeros(n + 1)[1:].reshape(n, 1)
    strided = torch.zeros(n, 2)[:, :1]
    assert misaligned.data_ptr() % 16 and not strided.is_contiguous()
    for bad, match in ((misaligned, "16-byte aligned"),
                       (strided, "contiguous"),
                       (torch.zeros(n, 1, dtype=torch.float16), "4- or 8")):
        for kind in probes.KINDS:
            with pytest.raises(ValueError, match=match):
                run(bad.as_subclass(_OnCard), kind)
    assert no_card_launch == []


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", [1, 3, 5, 128, 1000])
@pytest.mark.parametrize("kind", probes.KINDS)
def test_relayout_kernels_match_first_design_on_card(kind, tiles):
    """The relayout kernels bitwise equal to their plain versions and to
    the first design's kernels, float32 and float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    for dtype in (torch.float32, torch.float64):
        x = torch.randn((tiles * probes.TM, 1), dtype=dtype, device="cuda")
        got = probes.relayout(x, kind)
        torch.cuda.synchronize()
        assert torch.equal(got, probes.relayout_plain(x, kind))
        assert torch.equal(got, probes.relayout_flat(x, kind))
