"""The set-up kernels (``fustpu_torch/csrc/setup.cu``, ``ops/cuda_setup``):
their plain versions against the JAX package's native set-up runtime, the
card's set-up path of `Discretization` (run here on CPU tensors, where
every wrapper takes its plain version) against the host set-up bitwise,
the host set-up unchanged, the box facet dofmap without the whole dofmap,
and the wrappers' checks and launch arguments.  The kernels themselves run
in the `cuda`-marked tests, on the card."""

import numpy as np
import pytest
import torch

from fustpu_torch import _build
from fustpu_torch.config import Material, Source
from fustpu_torch.demos.nonlinear_bowl import bowl_mapping
from fustpu_torch.elements.hex import hex8_tabulate
from fustpu_torch.mesh import shapes
from fustpu_torch.mesh.box import (build_box_mesh, build_mapped_mesh,
                                   dofmap_rows)
from fustpu_torch.mesh.extruded import as_extruded
from fustpu_torch.mesh.unstructured import from_box
from fustpu_torch.models import linear, westervelt
from fustpu_torch.models.discretization import Discretization
from fustpu_torch.ops import cuda_setup as setup
from fustpu_torch.ops import precompute as pre
from fustpu_torch.ops import spectral_mm as mm

torch.set_num_threads(1)

TOL = 1e-14        # float64, the same formulas summed in another order
KINDS = ("box", "bowl", "uniform", "general", "hex27")


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _mesh(kind, P=3):
    """A small mesh of one kind: a perturbed box, a mapped bowl, a uniform
    box of 4352 cells (the congruence dedup), a shuffled general import,
    a curved hex27 prism."""
    if kind == "box":
        return build_box_mesh((3, 4, 5), P, hi=(1.0, 0.8, 1.3),
                              perturb=0.15, seed=7)
    if kind == "bowl":
        return build_mapped_mesh((16, 8, 8), 2,
                                 bowl_mapping(0.035, 0.016, 0.025, 0.025,
                                              0.08), hi=(0.08, 0.05, 0.05))
    if kind == "uniform":
        return build_box_mesh((17, 16, 16), 2, hi=(1.7, 1.6, 1.6))
    if kind == "general":
        return from_box(build_box_mesh((3, 3, 2), P, perturb=0.2, seed=1),
                        shuffle_seed=3)
    return as_extruded(shapes.hex27_lattice(
        from_box(build_box_mesh((2, 2, 3), P), shuffle_seed=11),
        shapes.curved_prism_map))


def _facets(mesh):
    return (mesh.all_boundary_facets() if hasattr(mesh, "nc")
            else mesh.boundary_facets())


def _on_card_path(mesh):
    """`Discretization`'s card path on CPU tensors: every set-up wrapper
    then runs its plain version, so the data flow of the card's set-up
    runs here."""
    disc = Discretization(mesh, "cpu")
    disc.on_card = True
    disc._card = setup.CardGeometry(mesh, "cpu")
    return disc


# ---------------------------------------------------------------------------
# The plain versions against the JAX package's native library
# ---------------------------------------------------------------------------

def _native():
    from fustpu import native_bindings

    if not native_bindings.available():
        pytest.skip("the JAX package's native library is not built")
    return native_bindings


@pytest.mark.parametrize("kind", ["box", "bowl"])
@pytest.mark.parametrize("fn", ["cell_geometry", "facet_geometry",
                                "box_dofmap", "mass_diagonal"])
def test_plain_setup_matches_native(kind, fn):
    """The port's plain set-up (numpy) equals the JAX package's native
    C++ runtime: geometry and diagonals <= 1e-14 relative, the dofmap
    bitwise (all rows, and a subset of rows on its own)."""
    nb = _native()
    mesh = _mesh(kind)
    elem, P = mesh.element, mesh.degree
    corners = mesh.cell_corners_flat
    rng = np.random.default_rng(5)
    if fn == "cell_geometry":
        ndJ, nG = nb.cell_geometry(corners, elem.quad_points,
                                   elem.quad_weights)
        dJ, G = pre.geometry_of(corners, hex8_tabulate(elem.quad_points)[1],
                                elem.quad_weights)
        assert rel(dJ, ndJ) <= TOL and rel(G, nG) <= TOL
        assert rel(pre.detJ_of(corners, hex8_tabulate(elem.quad_points)[1],
                               elem.quad_weights), ndJ) <= TOL
    elif fn == "facet_geometry":
        bd = _facets(mesh)
        qpts_f = np.stack([elem.facet_quad_points(f) for f in range(6)])
        ref = nb.facet_geometry(corners, qpts_f, elem.facet_quad_weights, bd)
        gdofs, fgrads = pre.facet_grads(mesh)
        assert rel(pre.facet_geometry_of(gdofs, fgrads,
                                         elem.facet_quad_weights, bd),
                   ref) <= TOL
    elif fn == "box_dofmap":
        ref = nb.box_dofmap(mesh.nc, P)
        assert np.array_equal(dofmap_rows(mesh.nc, P,
                                          np.arange(mesh.num_cells)), ref)
        rows = rng.choice(mesh.num_cells, 17, replace=False)
        assert np.array_equal(dofmap_rows(mesh.nc, P, rows), ref[rows])
    else:
        detJ = pre.cell_detJ(mesh)
        coeff = rng.uniform(0.5, 2.0, mesh.num_cells)
        ref = nb.mass_diagonal(detJ, coeff, mesh.dofmap, mesh.ndofs)
        box = mm.mass_diagonal(mesh.nc, P, detJ, coeff.reshape(mesh.nc))
        pos, ptr = setup.inverse_map(torch.as_tensor(mesh.dofmap),
                                     mesh.ndofs)
        imp = setup.mass_diagonal_map(torch.as_tensor(detJ).reshape(-1),
                                      torch.as_tensor(coeff),
                                      detJ.shape[1], pos, ptr)
        assert rel(box.reshape(-1), ref) <= TOL
        assert rel(imp, ref) <= TOL


# ---------------------------------------------------------------------------
# The card's set-up path against the host set-up
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_card_setup_path_equals_host_setup(kind):
    """`Discretization`'s card path (CardGeometry, the congruence dedup
    indexed on the device, `box_facet_dofmap`, the inverse maps, the
    diagonals through `mass_diagonal_box` / `_map`), run on CPU tensors,
    equals the host set-up bitwise: the metric, the mass diagonal, the
    facet blocks and a weighted facet diagonal."""
    mesh = _mesh(kind)
    host, card = Discretization(mesh), _on_card_path(mesh)
    rng = np.random.default_rng(2)
    coeff = rng.uniform(0.5, 2.0, mesh.num_cells)
    assert torch.equal(card._metric(), torch.as_tensor(host._G_host))
    for c in (None, coeff):
        m = card.mass_diag(c)
        assert isinstance(m, torch.Tensor)
        assert np.array_equal(m.numpy(), host.mass_diag(c))
    bd = _facets(mesh)
    hb, cb = host.facet_block(bd), card.facet_block(bd)
    assert np.array_equal(cb.dofmap.numpy(), hb.dofmap)
    assert np.array_equal(cb.detJ.numpy(), hb.detJ)
    fc = rng.uniform(0.5, 2.0, len(bd))
    w = rng.uniform(0.5, 2.0, hb.dofmap.shape)
    assert np.array_equal(card.facet_diag(cb, fc, w).numpy(),
                          host.facet_diag(hb, fc, w))
    assert set(card.host_seconds) == {"geometry", "mass", "facets"}


def _model(cls, mesh, impl, two_layer):
    if two_layer:
        shape = mesh.nc if hasattr(mesh, "nc") else (mesh.num_cells,)
        tissue = np.arange(int(np.prod(shape))).reshape(shape) % 2 == 1
        mat = Material(sound_speed=np.where(tissue, 1560.0, 1480.0),
                       density=np.where(tissue, 1045.0, 1000.0),
                       nonlinearity=3.5, attenuation_dB=0.2)
    else:
        mat = Material(nonlinearity=3.5, attenuation_dB=0.2)
    bd = _facets(mesh)
    return cls(mesh, mat, Source(), bd[: len(bd) // 3], bd[len(bd) // 3:],
               dtype=torch.float64, device="cpu", stiffness_impl=impl)


@pytest.mark.parametrize("kind,cls,impl,two_layer", [
    ("box", linear.LinearWaveModel, "auto", True),
    ("box", westervelt.WesterveltModel, "auto", True),
    ("hex27", westervelt.WesterveltModel, "auto", False),
    ("general", linear.LinearWaveModel, "auto", True),
    ("general", westervelt.WesterveltModel, "indexed_engine", True),
])
def test_models_built_on_the_card_path_equal_host_models(monkeypatch, kind,
                                                         cls, impl,
                                                         two_layer):
    """A model whose set-up takes the card's path (on CPU tensors: the
    stiffness builders take a tensor metric, the vectors come as tensors)
    holds every buffer bitwise equal to the host-set-up model's, on a box
    (structured and pair), a curved prism (extruded), a general import
    (indexed) and the staged engine."""
    mesh = _mesh(kind)
    ref = _model(cls, mesh, impl, two_layer)
    module = linear if cls is linear.LinearWaveModel else westervelt
    monkeypatch.setattr(module, "Discretization",
                        lambda m, device: _on_card_path(m))
    got = _model(cls, mesh, impl, two_layer)
    assert got.disc.on_card and not ref.disc.on_card
    a, b = ref.state_dict(), got.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_setup_device_cpu_is_the_host_setup():
    """`setup_device='cpu'` builds the same model as the default on the CPU
    (the host set-up); a CUDA set-up for a CPU model is refused."""
    mesh = _mesh("box")
    bd = _facets(mesh)
    args = (mesh, Material(), Source(), bd[:5], bd[5:])
    a = linear.LinearWaveModel(*args, dtype=torch.float64, device="cpu")
    b = linear.LinearWaveModel(*args, dtype=torch.float64, device="cpu",
                               setup_device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    with pytest.raises(ValueError, match="setup_device"):
        linear.LinearWaveModel(*args, dtype=torch.float64, device="cpu",
                               setup_device="cuda")


def _parent_facet_geometry(mesh, bd):
    """The host facet geometry as the port computed it before the set-up
    kernels (one einsum per local facet on that facet's gradients)."""
    elem = mesh.element
    out = np.empty((bd.shape[0], elem.facet_quad_weights.size))
    for lf in range(6):
        sel = np.nonzero(bd[:, 1] == lf)[0]
        if sel.size == 0:
            continue
        gdofs, grads = pre._geom_dofs_grads(mesh, elem.facet_quad_points(lf))
        free = [ax for ax in range(3) if ax != lf // 2]
        J = np.einsum("cvp,qvr->cqpr", gdofs[bd[sel, 0]], grads,
                      optimize=True)
        out[sel] = np.linalg.norm(np.cross(J[..., free[0]], J[..., free[1]]),
                                  axis=-1) * elem.facet_quad_weights
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_host_setup_unchanged(kind):
    """The host set-up (a `Discretization` on the CPU) is bitwise what the
    port computed before the set-up kernels: detJ and G chunk by chunk,
    the facet geometry per local facet, the facet dofmap from the whole
    dofmap, the diagonals by strided adds, bincount and add.at."""
    mesh = _mesh(kind)
    disc = Discretization(mesh)
    elem = mesh.element
    gdofs, grads = pre._geom_dofs_grads(mesh, elem.quad_points)
    if getattr(mesh, "geom_nodes", None) is None and mesh.num_cells > 4096:
        inv, rep = pre.congruence_groups(gdofs)
        dJ, G = (a[inv] for a in pre._metric(
            pre._jacobians(gdofs[rep], grads), elem.quad_weights))
    else:
        dJ, G = pre._metric(pre._jacobians(gdofs, grads), elem.quad_weights)
    assert np.array_equal(disc._detJ_host, dJ)
    assert np.array_equal(disc._G_host, G)
    coeff = np.random.default_rng(1).uniform(0.5, 2.0, mesh.num_cells)
    if hasattr(mesh, "nc"):
        m = mm.mass_diagonal(mesh.nc, mesh.degree, dJ, coeff.reshape(mesh.nc))
    else:
        m = np.bincount(mesh.dofmap.ravel(), (dJ * coeff[:, None]).ravel(),
                        minlength=mesh.ndofs)
    assert np.array_equal(disc.mass_diag(coeff), m)
    bd = np.asarray(_facets(mesh), np.int64)
    blk = disc.facet_block(bd)
    dofs = mesh.dofmap[bd[:, 0]][np.arange(len(bd))[:, None],
                                 elem.all_facet_dofs[bd[:, 1]]]
    assert np.array_equal(blk.dofmap, dofs)
    detJ_f = _parent_facet_geometry(mesh, bd)
    assert np.array_equal(blk.detJ, detJ_f)
    fc = np.linspace(0.5, 2.0, len(bd))
    y = np.zeros(mesh.ndofs)
    np.add.at(y, dofs.ravel(), (detJ_f * fc[:, None]).ravel())
    assert np.array_equal(disc.facet_diag(blk, fc).reshape(-1), y)


@pytest.mark.parametrize("plane", ["x-", "x+", "y-", "y+", "z-", "z+"])
def test_box_facet_dofmap_matches_the_whole_dofmap(plane):
    """The box facet dofmap from the facet cells' rows alone equals the one
    cut from the whole (cells, n^3) dofmap, on every boundary plane (and
    a predicate's sub-patch of it), and so does the card's path."""
    mesh = build_box_mesh((5, 3, 4), 3, hi=(1.0, 0.6, 0.8), perturb=0.1,
                          seed=2)
    elem = mesh.element
    for bd in (mesh.boundary_facets(plane),
               mesh.boundary_facets(plane, lambda c: np.arange(len(c)) % 3
                                    == 1)):
        bd = np.asarray(bd, np.int64)
        whole = mesh.dofmap[bd[:, 0]][np.arange(len(bd))[:, None],
                                      elem.all_facet_dofs[bd[:, 1]]]
        assert len(bd) > 0
        assert np.array_equal(mesh.facet_dofmap(bd), whole)
        assert np.array_equal(
            setup.box_facet_dofmap(mesh, bd, "cpu").numpy(), whole)


def test_h_cfl_in_chunks_equals_the_whole():
    """The CFL length over the cells in chunks (18,000 cells: two chunks)
    equals the all-pairs minimum over every cell at once, bitwise."""
    mesh = build_box_mesh((30, 30, 20), 2, perturb=0.2, seed=3)
    c = mesh.cell_corners_flat
    d = np.linalg.norm(c[:, :, None, :] - c[:, None, :, :], axis=-1)
    d[:, np.arange(8), np.arange(8)] = np.inf
    assert mesh.num_cells > pre._CHUNK
    assert mesh.h_cfl() == float(np.sqrt(3.0) * d.min())
    assert from_box(mesh).h_cfl() == mesh.h_cfl()


# ---------------------------------------------------------------------------
# The wrappers' checks and launch arguments (no card: a CPU tensor stands in)
# ---------------------------------------------------------------------------

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
def launches(monkeypatch):
    """`launch.launch` recording its calls instead of launching."""
    from fustpu_torch.ops import launch

    calls = []
    monkeypatch.setattr(launch, "launch", lambda name, dev, *args:
                        calls.append((name, dev, args)))
    return calls


def _card_inputs(P=3, ng=8):
    mesh = _mesh("box" if ng == 8 else "hex27", P)
    gdofs, grads = pre._geom_dofs_grads(mesh, mesh.element.quad_points)
    _, fgrads = pre.facet_grads(mesh)
    c = lambda a: torch.as_tensor(np.ascontiguousarray(a)).as_subclass(
        _OnCard)
    bd = np.asarray(_facets(mesh), np.int64)
    return mesh, dict(gdofs=c(gdofs), grads=c(grads),
                      wts=c(mesh.element.quad_weights), fgrads=c(fgrads),
                      fwts=c(mesh.element.facet_quad_weights), bd=c(bd))


@pytest.mark.parametrize("ng", [8, 27])
def test_setup_launch_arguments(launches, ng):
    """Each wrapper launches its entry point once, on card 0, with as many
    arguments as the entry point declares before the stream
    (`_build.SETUP_ENTRIES`), its sizes in place, and counts the launch."""
    setup.reset_launches()
    mesh, a = _card_inputs(ng=ng)
    cells, nq = a["gdofs"].shape[0], a["wts"].shape[0]
    setup.cell_geometry(a["gdofs"], a["grads"], a["wts"])
    setup.cell_geometry(a["gdofs"], a["grads"], a["wts"], with_G=False)
    setup.facet_geometry(a["gdofs"], a["fgrads"], a["fwts"], a["bd"])
    expect = [("cell_geometry", (cells, nq, ng, 1)),
              ("cell_geometry", (cells, nq, ng, 0)),
              ("facet_geometry", (len(a["bd"]), a["fwts"].shape[0], ng))]
    if ng == 8:
        setup.box_dofmap(a["bd"][:, 0].contiguous(), mesh.nc, mesh.degree)
        detJ = a["gdofs"].new_empty((cells, nq))
        setup.mass_diagonal_box(detJ, None, mesh.nc, mesh.degree)
        pos = torch.zeros(cells * nq, dtype=torch.int32).as_subclass(_OnCard)
        ptr = torch.zeros(mesh.ndofs + 1,
                          dtype=torch.int32).as_subclass(_OnCard)
        setup.mass_diagonal_map(detJ.reshape(-1), a["gdofs"].new_empty(
            cells), nq, pos, ptr)
        expect += [("box_dofmap", (len(a["bd"]), mesh.nc[1], mesh.nc[2],
                                   mesh.degree)),
                   ("mass_diagonal_box", (*mesh.nc, mesh.degree)),
                   ("mass_diagonal_map", (nq, mesh.ndofs))]
    assert len(launches) == len(expect)
    for (name, dev, args), (kernel, sizes) in zip(launches, expect):
        entry = f"fustpu_setup_{kernel}"
        assert name == entry and dev == 0
        assert len(args) == len(_build.SETUP_ENTRIES[entry])
        ints = tuple(x for x, t in zip(args, _build.SETUP_ENTRIES[entry])
                     if t is not _build._P)
        assert ints == sizes, (kernel, ints)
    assert setup.launches["setup_cell_geometry"] == 1
    assert setup.launches["setup_cell_detJ"] == 1
    assert sum(setup.launches.values()) == len(expect)


def test_setup_wrappers_refuse_before_any_launch(launches):
    """Wrong dtype, shape, geometry dofs a cell or a non-contiguous input
    raise before any launch."""
    mesh, a = _card_inputs()
    g, gr, w = a["gdofs"], a["grads"], a["wts"]
    bad = [
        lambda: setup.cell_geometry(g.float(), gr, w),
        lambda: setup.cell_geometry(g, gr[1:], w),
        lambda: setup.cell_geometry(g[:, :4].contiguous(), gr[:, :4]
                                    .contiguous(), w),
        lambda: setup.cell_geometry(g.transpose(0, 1).contiguous()
                                    .transpose(0, 1), gr, w),
        lambda: setup.facet_geometry(g, a["fgrads"], a["fwts"],
                                     a["bd"].int()),
        lambda: setup.box_dofmap(a["bd"][:, 0], mesh.nc, mesh.degree),
        lambda: setup.mass_diagonal_box(g.new_empty((3, 5)), None, mesh.nc,
                                        mesh.degree),
    ]
    for fn in bad:
        with pytest.raises(ValueError, match="kernel"):
            fn()
    assert launches == []


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("P", [2, 4, 7, 10])
def test_setup_kernels_match_plain_on_card(P):
    """Every set-up kernel against its plain version on the same inputs:
    geometry <= 1e-14 relative, the dofmap and the diagonals bitwise, two
    launches bitwise equal (the detJ-only form is another kernel, rounded
    apart: each form against itself); trilinear, hex27, a box and a
    general mesh;
    and a `Discretization` on the card against one on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(P)
    for kind in ("box", "hex27", "general"):
        mesh = _mesh(kind, P)
        elem = mesh.element
        gdofs, grads = pre._geom_dofs_grads(mesh, elem.quad_points)
        t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)
        dJ, G = setup.cell_geometry(t(gdofs), t(grads), t(elem.quad_weights))
        dJ2, G2 = setup.cell_geometry(t(gdofs), t(grads),
                                      t(elem.quad_weights))
        d1, _ = setup.cell_geometry(t(gdofs), t(grads), t(elem.quad_weights),
                                    with_G=False)
        d2, _ = setup.cell_geometry(t(gdofs), t(grads), t(elem.quad_weights),
                                    with_G=False)
        pdJ, pG = pre.geometry_of(gdofs, grads, elem.quad_weights)
        assert rel(dJ.cpu(), pdJ) <= TOL and rel(G.cpu(), pG) <= TOL
        assert rel(d1.cpu(), pdJ) <= TOL
        assert torch.equal(dJ, dJ2) and torch.equal(G, G2)
        assert torch.equal(d1, d2)
        bd = np.asarray(_facets(mesh), np.int64)
        _, fgrads = pre.facet_grads(mesh)
        f1 = setup.facet_geometry(t(gdofs), t(fgrads),
                                  t(elem.facet_quad_weights), t(bd))
        f2 = setup.facet_geometry(t(gdofs), t(fgrads),
                                  t(elem.facet_quad_weights), t(bd))
        assert torch.equal(f1, f2)
        assert rel(f1.cpu(), pre.facet_geometry_of(
            gdofs, fgrads, elem.facet_quad_weights, bd)) <= TOL
        coeff = rng.uniform(0.5, 2.0, mesh.num_cells)
        if hasattr(mesh, "nc"):
            cells = rng.choice(mesh.num_cells, 7)
            assert np.array_equal(
                setup.box_dofmap(t(cells), mesh.nc, P).cpu().numpy(),
                dofmap_rows(mesh.nc, P, cells))
            m = setup.mass_diagonal_box(dJ, t(coeff), mesh.nc, P)
            assert np.array_equal(m.cpu().numpy(), mm.mass_diagonal(
                mesh.nc, P, dJ.cpu().numpy(), coeff.reshape(mesh.nc)))
        pos, ptr = setup.inverse_map(t(mesh.dofmap), mesh.ndofs)
        m1 = setup.mass_diagonal_map(dJ.reshape(-1), t(coeff), dJ.shape[1],
                                     pos, ptr)
        m2 = setup.mass_diagonal_map(dJ.reshape(-1).cpu(),
                                     torch.as_tensor(coeff), dJ.shape[1],
                                     pos.cpu(), ptr.cpu())
        assert torch.equal(m1.cpu(), m2)
        host, card = Discretization(mesh), Discretization(mesh, dev)
        assert rel(card.mass_diag(coeff).cpu(), host.mass_diag(coeff)) <= TOL
        assert rel(card._metric().cpu(), host._G_host) <= TOL
        hb, cb = host.facet_block(bd), card.facet_block(bd)
        assert np.array_equal(cb.dofmap.cpu().numpy(), hb.dofmap)
        assert rel(card.facet_diag(cb, coeff[bd[:, 0]]).cpu(),
                   host.facet_diag(hb, coeff[bd[:, 0]])) <= TOL
