"""The port's two-slab stiffness operators (``ops/slab2``, kernels #4 and
#5) against the JAX package: the plain versions against `_apply_slab2` /
`_apply_slab2w` in interpret mode on the boxes of the JAX package's own
slab2 tests plus ncx = 2, with and without a coefficient, in float64; the
pair maps and their scatter classes; `convert.slab2*_from_fustpu`; the
`exp_slab2w` demo on the CPU; and, on a card, the CUDA kernel against the
plain versions.

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


def test_exp_slab2w_demo_on_cpu(capsys):
    out = exp_slab2w.main(["f64", "2", "3", "--device", "cpu", "--chain",
                           "1", "--reps", "1"])
    assert out["rel"]["slab2"] <= TOL and out["rel"]["slab2w"] <= TOL
    text = capsys.readouterr().out
    assert "cross-check slab2w vs production" in text
    assert "host clock on the CPU" in text


@pytest.mark.cuda
@pytest.mark.parametrize("P", range(2, 11))
def test_kernels_match_plain_on_card(P):
    """The slab2 and slab2w kernels against their plain versions on the
    card, every test box with and without a coefficient (float64 to 1e-12,
    float32 to 1e-6 against the float64 plain version), and slab2w against
    the single-slab kernel on the same buffers."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    before = dict(c2.launches)
    for nc in BOXES:
        mesh = build_box_mesh(nc, P, perturb=0.12, seed=5)
        _, G = pre.cell_geometry_factors(mesh)
        D = mesh.element.deriv_1d
        x = np.random.default_rng(0).standard_normal(mesh.grid_shape)
        for c in (None, np.random.default_rng(1).uniform(0.5, 2.0, nc)):
            for far in (False, True):
                build = s2.build_slab2w if far else s2.build_slab2
                plain = s2.slab2w_plain if far else s2.slab2_plain
                kernel = c2.slab2w if far else c2.slab2
                op = build(nc, P, D, G, F64, coeff=c, device="cuda")
                xd = torch.as_tensor(x, device="cuda")
                want = plain(op, xd).cpu()
                assert rel(kernel(op, xd).cpu(), want) <= TOL
                op32 = build(nc, P, D, G, torch.float32, coeff=c,
                             device="cuda")
                y32 = kernel(op32, xd.float())
                torch.cuda.synchronize()
                assert rel(y32.cpu(), want) <= 1e-6
                if far:
                    y1 = cs.stiffness(op.cell_op, xd)
                    assert rel(kernel(op, xd).cpu(), y1.cpu()) <= TOL
    assert c2.launches["slab2"] == before["slab2"] + 12
    assert c2.launches["slab2w"] == before["slab2w"] + 18
