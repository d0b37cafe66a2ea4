"""The port's measurement kernels against the JAX package: the kernel
anatomy variants (``ops/anatomy``, kernel #13), the G layout sum and the
relayout permutations (``ops/probes``, kernels #12 and #14).  Their plain
versions against the JAX package's matmul operator, the JAX demos' own
kernels in interpret mode and numpy, on the CPU; the three experiment
demos on the CPU; and, on a card, the CUDA kernels against the plain
versions.

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
    assert set(a["outs"]) == set(anatomy.VARIANTS)
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


@pytest.mark.cuda
@pytest.mark.parametrize("P", range(2, 11))
def test_anatomy_kernels_match_plain_on_card(P):
    """Each anatomy variant's kernel against its plain version (float64 to
    1e-12, float32 to 1e-6 against the float64 plain version); ywin against
    the production kernel on the same buffers."""
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
            y = anatomy.variant(op, xd, name)
            torch.cuda.synchronize()
            assert rel(y.cpu(), want) <= tol, (name, dtype)
            if name == "ywin":
                assert rel(y.cpu(), cs.stiffness(op, xd).cpu()) <= tol
    for name in ("gstream", "contract", "ywin"):
        assert anatomy.launches[f"anatomy_{name}"] == \
            before[f"anatomy_{name}"] + 2


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
