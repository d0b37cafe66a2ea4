"""The port's windowed structured operators and their layout helpers, the
BLAS-1 vocabulary and the dense oracle against the JAX package on the CPU
in float64: `windows3d` / `fold3d` / `windows2d` / `fold2d` and
`to_structured_layout` bitwise; `mass_apply`, `stiffness_apply` and
`plane_facet_mass_apply` against ``fustpu.ops.operators`` at P = 2..6 on
small odd boxes (1e-12), the metric carried across by
`convert.windows_from_fustpu`; the oracle (``fustpu_torch.oracle``)
bitwise ``fustpu.oracle.assemble``'s at P = 2..4, and the windowed
stiffness against it; `copy`, `fill`, `dot` and `norm` against
``fustpu.ops.vector``.  The JAX package is imported inside the fixture
(it skips where JAX is missing).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fustpu_torch import convert
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.ops import gather_scatter as gs
from fustpu_torch.ops import operators as ops
from fustpu_torch.ops import precompute as pre
from fustpu_torch.ops import vector
from fustpu_torch.oracle import assemble

torch.set_num_threads(1)

F64 = torch.float64
TOL = 1e-12           # operator gate, the reference's own f64 tolerance
BOXES = {P: (3, 2, 5) if P <= 4 else (3, 1, 3) for P in range(2, 7)}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules; skips where JAX is missing."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from fustpu.mesh import box as f_box
    from fustpu.models.discretization import Discretization as FDisc
    from fustpu.ops import gather_scatter as f_gs
    from fustpu.ops import operators as f_ops
    from fustpu.ops import precompute as f_pre
    from fustpu.ops import vector as f_vec
    from fustpu.oracle import assemble as f_asm

    return SimpleNamespace(jnp=jnp, jit=jax.jit, box=f_box, FDisc=FDisc,
                           gs=f_gs, ops=f_ops, pre=f_pre, vec=f_vec,
                           asm=f_asm)


@pytest.mark.parametrize("P,nc", [(2, (3, 2, 4)), (3, (1, 3, 2)),
                                  (4, (2, 1, 1)), (6, (3, 2, 1))])
def test_windows_and_folds_are_bitwise_fustpus(ref, P, nc):
    rng = np.random.default_rng(P)
    g = tuple(c * P + 1 for c in nc)
    x = rng.standard_normal(g)
    A = rng.standard_normal(sum(((c, P + 1) for c in nc), ()))
    for fn, arg in ((gs.windows3d, x), (gs.fold3d, A),
                    (gs.windows2d, x[0]), (gs.fold2d, A[0, 0])):
        got = fn(torch.as_tensor(arg), P).numpy()
        want = np.asarray(ref.jit(getattr(ref.gs, fn.__name__),
                                  static_argnums=1)(ref.jnp.asarray(arg), P))
        assert got.shape == want.shape
        assert np.array_equal(got, want), fn.__name__


def test_fold_is_the_adjoint_of_the_window():
    rng = np.random.default_rng(1)
    P, nc = 3, (2, 3, 2)
    x = torch.as_tensor(rng.standard_normal(tuple(c * P + 1 for c in nc)))
    A = torch.as_tensor(rng.standard_normal(sum(((c, P + 1) for c in nc),
                                                ())))
    lhs = float((gs.windows3d(x, P) * A).sum())
    rhs = float((x * gs.fold3d(A, P)).sum())
    assert lhs == pytest.approx(rhs, rel=1e-13)


@pytest.mark.parametrize("P", [2, 4])
def test_to_structured_layout_is_bitwise_fustpus(ref, P):
    nc = BOXES[P]
    mesh = build_box_mesh(nc, P, perturb=0.2, seed=2)
    fmesh = ref.box.build_box_mesh(nc, P, perturb=0.2, seed=2)
    detJ, G = pre.cell_geometry_factors(mesh)
    for a in (detJ, G):
        assert np.array_equal(pre.to_structured_layout(a, mesh),
                              ref.pre.to_structured_layout(a, fmesh))


@pytest.fixture(scope="module")
def structured(ref):
    """Per degree: the port's box, the JAX package's discretisation of the
    same (perturbed, odd) box, its windowed detJ and G carried across, and
    per-cell coefficients."""
    out = {}
    for P, nc in BOXES.items():
        mesh = build_box_mesh(nc, P, perturb=0.15, seed=P)
        fdisc = ref.FDisc(ref.box.build_box_mesh(nc, P, perturb=0.15,
                                                 seed=P), ref.jnp.float64)
        coeff = np.random.default_rng(P).uniform(0.5, 2.0, nc)
        out[P] = SimpleNamespace(
            mesh=mesh, fdisc=fdisc, coeff=coeff,
            G=convert.windows_from_fustpu(np.asarray(fdisc.G_s)),
            detJ=convert.windows_from_fustpu(np.asarray(fdisc.detJ_s)),
            x=np.random.default_rng(10 + P).standard_normal(
                mesh.grid_shape))
    return out


@pytest.mark.parametrize("P", sorted(BOXES))
def test_stiffness_apply_matches_fustpu(ref, structured, P):
    s = structured[P]
    D = s.mesh.element.deriv_1d
    got = ops.stiffness_apply(torch.as_tensor(s.x), s.G,
                              torch.as_tensor(s.coeff), torch.as_tensor(D), P)
    want = ref.jit(ref.ops.stiffness_apply, static_argnums=4)(
        ref.jnp.asarray(s.x), s.fdisc.G_s, ref.jnp.asarray(s.coeff),
        s.fdisc.D, P)
    assert got.shape == s.mesh.grid_shape
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("P", sorted(BOXES))
def test_mass_apply_matches_fustpu(ref, structured, P):
    s = structured[P]
    got = ops.mass_apply(torch.as_tensor(s.x), s.detJ,
                         torch.as_tensor(s.coeff), P)
    want = ref.jit(ref.ops.mass_apply, static_argnums=3)(
        ref.jnp.asarray(s.x), s.fdisc.detJ_s, ref.jnp.asarray(s.coeff), P)
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("P", sorted(BOXES))
def test_plane_facet_mass_apply_matches_fustpu(ref, P):
    ncs, nct = BOXES[P][1:]
    n = P + 1
    rng = np.random.default_rng(20 + P)
    x = rng.standard_normal((ncs * P + 1, nct * P + 1))
    detJ_f = rng.uniform(0.1, 1.0, (ncs, n, nct, n))
    coeff = rng.uniform(0.5, 2.0, (ncs, nct))
    got = ops.plane_facet_mass_apply(*(torch.as_tensor(a) for a in
                                       (x, detJ_f, coeff)), P)
    want = ref.jit(ref.ops.plane_facet_mass_apply, static_argnums=3)(
        *(ref.jnp.asarray(a) for a in (x, detJ_f, coeff)), P)
    assert got.shape == x.shape
    assert rel(got, want) <= TOL


def test_windows_from_fustpu_refuses_other_layouts():
    with pytest.raises(ValueError):
        convert.windows_from_fustpu(np.zeros((2, 3, 2, 3, 2, 4, 6)))
    with pytest.raises(ValueError):
        convert.windows_from_fustpu(np.zeros((6, 2, 3, 2, 3)))
    assert convert.windows_from_fustpu(
        np.zeros((2, 3, 1, 3, 2, 3))).dtype == F64


@pytest.mark.parametrize("P", [2, 3, 4])
def test_oracle_is_bitwise_fustpus(ref, P):
    nc = (2, 1, 2)
    mesh = build_box_mesh(nc, P, perturb=0.2, seed=5)
    fmesh = ref.box.build_box_mesh(nc, P, perturb=0.2, seed=5)
    for name in ("element_mass_matrices", "element_stiffness_matrices"):
        assert np.array_equal(getattr(assemble, name)(mesh),
                              getattr(ref.asm, name)(fmesh)), name
    bd = mesh.all_boundary_facets()
    M_f = assemble.element_facet_mass_matrices(mesh, bd)
    assert np.array_equal(M_f, ref.asm.element_facet_mass_matrices(
        fmesh, fmesh.all_boundary_facets()))
    K = assemble.element_stiffness_matrices(mesh)
    rng = np.random.default_rng(P)
    coeff = rng.uniform(0.5, 2.0, mesh.num_cells)
    x = rng.standard_normal(mesh.ndofs)
    assert np.array_equal(
        assemble.apply_elementwise(K, mesh.dofmap, coeff, x, mesh.ndofs),
        ref.asm.apply_elementwise(K, fmesh.dofmap, coeff, x, fmesh.ndofs))


@pytest.mark.parametrize("P", [2, 3, 4])
def test_windowed_stiffness_matches_the_oracle(P):
    nc = (2, 3, 1)
    mesh = build_box_mesh(nc, P, perturb=0.2, seed=7)
    _, G = pre.cell_geometry_factors(mesh)
    coeff = np.random.default_rng(P).uniform(0.5, 2.0, nc)
    x = np.random.default_rng(30 + P).standard_normal(mesh.ndofs)
    got = ops.stiffness_apply(
        torch.as_tensor(x.reshape(mesh.grid_shape)),
        torch.as_tensor(pre.to_structured_layout(G, mesh)),
        torch.as_tensor(coeff), torch.as_tensor(mesh.element.deriv_1d), P)
    K = assemble.element_stiffness_matrices(mesh)
    want = assemble.apply_elementwise(K, mesh.dofmap, coeff.reshape(-1), x,
                                      mesh.ndofs)
    assert rel(got.reshape(-1), want) <= TOL


def test_vector_vocabulary_matches_fustpu(ref):
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((2, 7, 5))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    ja, jb = ref.jnp.asarray(a), ref.jnp.asarray(b)
    c = vector.copy(ta)
    assert np.array_equal(c, np.asarray(ref.vec.copy(ja)))
    c[0, 0] = 0.0                        # a new tensor, not a view
    assert ta[0, 0] == a[0, 0]
    assert np.array_equal(vector.fill(2.5, ta),
                          np.asarray(ref.vec.fill(2.5, ja)))
    assert float(vector.dot(ta, tb)) == pytest.approx(
        float(ref.vec.dot(ja, jb)), rel=1e-14)
    assert float(vector.norm(ta)) == pytest.approx(
        float(ref.vec.norm(ja)), rel=1e-14)
