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


@pytest.mark.cuda
@pytest.mark.parametrize("P", range(2, 11))
def test_kernels_match_plain_on_card(P):
    """CUDA kernels vs the plain version on the card (float64 to 1e-12,
    float32 to 1e-5 against the float64 plain version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    k = _case(P, (3, 4, 5) if P <= 6 else (2, 3, 3))
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
    before = dict(cs.launches)
    for dtype, tol in ((F64, TOL), (torch.float32, 1e-5)):
        y = cs.stiffness(op(dtype, False), x1.to(dtype))
        y2 = cs.stiffness_pair(op(dtype, True), x1.to(dtype), x2.to(dtype))
        torch.cuda.synchronize()
        assert rel(y.cpu(), y_ref) <= tol
        assert rel(y2.cpu(), ref2) <= tol
    assert cs.launches["stiffness"] == before["stiffness"] + 2
    assert cs.launches["stiffness_pair"] == before["stiffness_pair"] + 2
