"""The port's corner-streamed capacity mode against the JAX package on the
CPU in float64: the vendored channel functions (`jacobian_coefficients`,
`corner_stream`), the plain corner apply (single and pair, trilinear and
hex27) against the JAX package's corner kernels in interpret mode and
against the port's own G-stream apply, `convert` of the JAX corner
operators, the models (linear and Westervelt, uniform and two-layer, on a
box and on an imported cylinder) with ``stiffness_impl="pallas_corner"``,
the capacity property (no host metric), the routing of a general mesh, and
the two capacity demos' CLIs; and, on a card, the corner CUDA kernels
against their plain version.

The JAX package is imported inside the fixtures that compare against it
(they skip where JAX is missing), so that the card tests also run on a
machine without JAX:

    python -m pytest --noconftest tests/test_torch_corner.py -m cuda
"""

import dataclasses
import functools
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fustpu_torch import convert
from fustpu_torch.config import Material, Source
from fustpu_torch.elements.hex import hex8_tabulate
from fustpu_torch.mesh import msh_io, shapes
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.mesh.extruded import as_extruded
from fustpu_torch.mesh.unstructured import from_box
from fustpu_torch.models.discretization import (CornerStiffness,
                                                Discretization,
                                                IndexedStiffness,
                                                resolve_stiffness_impl)
from fustpu_torch.models.linear import LinearWaveModel
from fustpu_torch.models.westervelt import WesterveltModel
from fustpu_torch.ops import corner as cn
from fustpu_torch.ops import cuda_corner as cc
from fustpu_torch.ops import cuda_extruded as ce
from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.ops import precompute as pre

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
F64 = torch.float64
SETUP_TOL = 1e-14     # channels: the same float64 numpy arithmetic
TOL = 1e-12           # operator gate, the reference's own f64 tolerance
MODEL_TOL = 1e-11     # 10 RK4 steps of the operator gate
STEPS = 10
CYL = dict(radius=0.012, length=0.02, piston_radius=0.008, m=3, mr=1,
           nr_ann=1)
KINDS = ["box", "cylinder", "shuffled", "curved"]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules; skips where JAX is missing."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from fustpu import config as f_config
    from fustpu.mesh import box as f_box
    from fustpu.mesh import extruded as f_ext
    from fustpu.mesh import msh_io as f_msh
    from fustpu.mesh import unstructured as f_un
    from fustpu.models import discretization as f_disc
    from fustpu.models.linear import LinearWaveModel as FLinear
    from fustpu.models.westervelt import WesterveltModel as FWest
    from fustpu.ops import pallas_extruded as pex
    from fustpu.ops import pallas_stiffness as ps

    return SimpleNamespace(jax=jax, jnp=jnp, config=f_config, box=f_box,
                           ext=f_ext, msh=f_msh, un=f_un,
                           disc=f_disc, FLinear=FLinear, FWest=FWest,
                           pex=pex, ps=ps)


@pytest.fixture(scope="module")
def msh_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("msh")


@functools.lru_cache(maxsize=None)
def _cyl_file(directory, nz):
    v, c, t = shapes.cylinder_mesh(nz=nz, **CYL)
    return msh_io.write_msh(str(Path(directory) / f"cyl{nz}"), v, c, t)


def _port_mesh(directory, kind, P):
    """A small mesh of one kind: a perturbed odd box; the imported
    cylinder, the shuffled box (rotated corner orders) and the curved
    hex27 prism, all extruded."""
    if kind == "box":
        return build_box_mesh((4, 3, 2), P, hi=(1.0, 0.8, 1.3),
                              perturb=0.15, seed=7)
    if kind == "cylinder":
        return msh_io.read_msh(_cyl_file(str(directory), 4 if P <= 4 else 2),
                               P)
    if kind == "shuffled":
        return as_extruded(from_box(build_box_mesh((3, 2, 4), P,
                                                   hi=(1.0, 0.8, 1.3)),
                                    shuffle_seed=11))
    return as_extruded(shapes.hex27_lattice(
        from_box(build_box_mesh((2, 2, 3), P), shuffle_seed=11),
        shapes.curved_prism_map))


def _jax_mesh(ref, directory, kind, P):
    """The JAX package's twin of `_port_mesh`."""
    if kind == "box":
        m = _port_mesh(directory, kind, P)
        return ref.box.BoxMesh(degree=P, nc=m.nc, lo=m.lo, hi=m.hi,
                               vertex_coords=m.vertex_coords)
    if kind == "cylinder":
        return ref.msh.read_msh(_cyl_file(str(directory),
                                          4 if P <= 4 else 2), P)
    if kind == "shuffled":
        return ref.ext.as_extruded(ref.un.from_box(ref.box.build_box_mesh(
            (3, 2, 4), P, hi=(1.0, 0.8, 1.3)), shuffle_seed=11))
    return ref.ext.as_extruded(shapes.hex27_lattice(
        ref.un.from_box(ref.box.build_box_mesh((2, 2, 3), P),
                        shuffle_seed=11), shapes.curved_prism_map))


def _case(directory, kind, P, seed=0):
    mesh = _port_mesh(directory, kind, P)
    rng = np.random.default_rng(seed)
    shape = mesh.nc if kind == "box" else (mesh.num_cells,)
    return SimpleNamespace(
        mesh=mesh, disc=Discretization(mesh),
        x1=rng.standard_normal(mesh.grid_shape),
        x2=rng.standard_normal(mesh.grid_shape),
        c1=rng.uniform(0.5, 2.0, shape), c2=rng.uniform(-1.5, -0.5, shape))


def _corner_apply(k, **kw):
    """The port's plain corner apply (CPU tensors) of case `k`: the pair
    form when `kw` holds `pair`."""
    pair = "pair" in kw
    op = k.disc.stiffness_op(F64, "cpu", corner=True, **kw)
    assert isinstance(op, cc.CornerCellStiffness)
    x1, x2 = torch.as_tensor(k.x1), torch.as_tensor(k.x2)
    if op.box:
        return cc.corner_pair(op, x1, x2) if pair else cc.corner(op, x1)
    return (cc.extruded_corner_pair(op, x1, x2) if pair
            else cc.extruded_corner(op, x1))


# ---------------------------------------------------------------------------
# Channels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_channels_match(ref, msh_dir, kind):
    """jacobian_coefficients (box) and corner_stream (37 channels
    trilinear, 163 hex27) against the JAX package's."""
    mesh, fmesh = _port_mesh(msh_dir, kind, 3), _jax_mesh(ref, msh_dir,
                                                          kind, 3)
    coeff = np.random.default_rng(2).uniform(0.5, 2.0, mesh.num_cells)
    if kind == "box":
        for c in (None, coeff):
            got = cn.jacobian_coefficients(mesh.cell_corners_flat, c)
            want = ref.ps.jacobian_coefficients(fmesh.cell_corners_flat, c)
            assert got.shape == (mesh.num_cells, 37)
            assert rel(got, want) <= SETUP_TOL
        return
    assert cn._monomial_table(cn.geom_degree(mesh)) == \
        ref.pex._monomial_table(cn.geom_degree(mesh))
    for c in (None, coeff):
        got, want = cn.corner_stream(mesh, c), ref.pex.corner_stream(fmesh, c)
        assert got.shape == (mesh.nstacks, mesh.nz,
                             163 if kind == "curved" else 37)
        assert rel(got, want) <= SETUP_TOL


def test_box_table_is_the_structured_layout():
    """The structured layout written as a monomial table evaluates the
    trilinear Jacobian: at a node, J from the channels equals J of the
    corner map (the table the structured kernel's corner_channel
    mirrors)."""
    mesh = build_box_mesh((2, 2, 2), 2, perturb=0.2, seed=1)
    T = cn.jacobian_coefficients(mesh.cell_corners_flat)
    _, table = cn.channel_table(1, True)
    pt = np.array([0.3, 0.7, 0.2])
    _, grads = hex8_tabulate(pt[None])             # (1, 8, 3)
    J = np.einsum("cvp,vr->cpr", mesh.cell_corners_flat, grads[0])
    for q in range(3):
        for p in range(3):
            got = sum(T[:, ch] * pt[0] ** mx * pt[1] ** my * pt[2] ** mz
                      for ch, mx, my, mz in table[q][p])
            assert np.abs(got - J[:, p, q]).max() <= 1e-14


# ---------------------------------------------------------------------------
# The plain apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,P", [("box", 2), ("box", 3), ("box", 4),
                                    ("cylinder", 2), ("cylinder", 3),
                                    ("cylinder", 4), ("shuffled", 3),
                                    ("curved", 2)])
def test_plain_apply_matches_pallas_interpret(ref, msh_dir, kind, P):
    """Single (per-cell coefficient) and pair applies of the port's plain
    corner version against the JAX package's corner kernels in interpret
    mode; the box pair against the sum of two folded corner operators (the
    JAX package has no structured corner pair kernel)."""
    jnp, ps, pex = ref.jnp, ref.ps, ref.pex
    k = _case(msh_dir, kind, P, seed=P)
    fmesh = _jax_mesh(ref, msh_dir, kind, P)
    D = k.mesh.element.deriv_1d
    x1, x2 = jnp.asarray(k.x1), jnp.asarray(k.x2)
    cc.reset_launches()
    if kind == "box":
        def fapply(coeff, x):
            op = ps.build_auto(fmesh.nc, P, D, None, jnp.float64,
                               coeff=coeff.reshape(-1),
                               corners=fmesh.cell_corners_flat)
            assert isinstance(op, ps.PallasStiffnessCorner)
            return ps.stiffness_apply_pallas(op, x, interpret=True,
                                             precision=ps._HI)
        want = fapply(k.c1, x1)
        want_pair = fapply(k.c1, x1) + fapply(k.c2, x2)
    else:
        nd = k.mesh.ndofs
        op = pex.build_extruded_corner(fmesh, D, jnp.float64, coeff=k.c1)
        want = pex.stiffness_apply_extruded_pallas(
            x1, op, nd, interpret=True, precision=pex._HI)
        opp = pex.build_extruded_corner(fmesh, D, jnp.float64,
                                        c1_cells=k.c1, c2_cells=k.c2)
        want_pair = pex.stiffness_apply_extruded_pallas_pair(
            x1, x2, opp, nd, interpret=True, precision=pex._HI)
    assert rel(_corner_apply(k, coeff=k.c1), want) <= TOL
    assert rel(_corner_apply(k, pair=(k.c1, k.c2)),
               want_pair) <= TOL
    assert all(v == 0 for v in cc.launches.values())


@pytest.mark.parametrize("kind,P", [(kind, P) for kind in ("box",
                                                           "cylinder")
                                    for P in range(2, 11)]
                         + [("curved", P) for P in (2, 4, 6)])
def test_plain_apply_matches_g_stream(msh_dir, kind, P):
    """The corner operator equals the G-stream operator on the same mesh
    (the geometry map is exactly trilinear or triquadratic), P = 2..10:
    single with and without a coefficient, and pair."""
    k = _case(msh_dir, kind, P, seed=10 + P)
    x1, x2 = torch.as_tensor(k.x1), torch.as_tensor(k.x2)
    box = kind == "box"
    single = cs.stiffness if box else ce.extruded
    pair = cs.stiffness_pair if box else ce.extruded_pair
    for kw in ({}, {"coeff": k.c1}):
        want = single(k.disc.stiffness_op(F64, "cpu", **kw), x1)
        assert rel(_corner_apply(k, **kw), want) <= TOL
    want = pair(k.disc.stiffness_op(F64, "cpu", pair=(k.c1, k.c2)), x1, x2)
    assert rel(_corner_apply(k, pair=(k.c1, k.c2)), want) <= TOL


def test_left_handed_cells(msh_dir):
    """|det J|: mirroring the box (every cell left-handed) leaves the
    operator unchanged."""
    k = _case(msh_dir, "box", 3, seed=4)
    mirrored = dataclasses.replace(
        k.mesh, vertex_coords=k.mesh.vertex_coords * np.array([-1, 1, 1]))
    x = torch.as_tensor(k.x1)
    y = cc.corner(cc.build_box(k.mesh, k.mesh.element.deriv_1d, F64, "cpu"),
                  x)
    ym = cc.corner(cc.build_box(mirrored, k.mesh.element.deriv_1d, F64,
                                "cpu"), x)
    assert rel(ym, y) <= TOL


def test_convert_matches_own_build(ref, msh_dir):
    """corner_from_fustpu of the JAX corner operators (box single, the
    box pair of two folded operators, extruded single and pair) gives the
    port's own channels and applies."""
    jnp, ps, pex = ref.jnp, ref.ps, ref.pex
    a = np.asarray
    for kind in ("box", "cylinder"):
        k = _case(msh_dir, kind, 3, seed=5)
        fmesh = _jax_mesh(ref, msh_dir, kind, 3)
        D = k.mesh.element.deriv_1d
        x1, x2 = torch.as_tensor(k.x1), torch.as_tensor(k.x2)
        own = k.disc.stiffness_op(F64, "cpu", coeff=k.c1, corner=True)
        own_pair = k.disc.stiffness_op(F64, "cpu", pair=(k.c1, k.c2),
                                       corner=True)
        if kind == "box":
            jc = lambda c: a(ps.build_corner(
                fmesh.nc, 3, D, fmesh.cell_corners_flat, jnp.float64,
                coeff=c.reshape(-1)).JC)
            single = convert.corner_from_fustpu(jc(k.c1), D=D)
            pair = convert.corner_from_fustpu((jc(k.c1), jc(k.c2)), D=D)
            where = k.mesh.nc
        else:
            op = pex.build_extruded_corner(fmesh, D, jnp.float64,
                                           coeff=k.c1)
            opp = pex.build_extruded_corner(fmesh, D, jnp.float64,
                                            c1_cells=k.c1, c2_cells=k.c2)
            single = convert.corner_from_fustpu(
                T=a(op.T), D=a(op.statics[0]), ns=k.mesh.nstacks)
            pair = convert.corner_from_fustpu(
                T=a(opp.T), D=a(opp.statics[0]), C=a(opp.ce),
                ns=k.mesh.nstacks)
            where = k.mesh
        got = single.to_device(F64, "cpu", where)
        assert rel(got.T, own.T) <= SETUP_TOL
        assert rel(cc.corner_plain(got, x1), cc.corner_plain(own, x1)) <= TOL
        got = pair.to_device(F64, "cpu", where)
        assert rel(got.T, own_pair.T) <= SETUP_TOL
        assert rel(got.C, own_pair.C) == 0.0
        assert rel(cc.corner_pair_plain(got, x1, x2),
                   cc.corner_pair_plain(own_pair, x1, x2)) <= TOL


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

MODELS = ["linear_uniform", "linear_two_layer", "westervelt_uniform",
          "westervelt_two_layer"]


def _model_config(directory, mesh_kind, name):
    """(port class, port mesh, material, source, source facets, absorbing
    facets) of one model on the small box or the imported cylinder."""
    west = name.startswith("westervelt")
    kw = dict(nonlinearity=100.0, attenuation_dB=50.0) if west else {}
    if mesh_kind == "box":
        L = 0.006
        mesh = build_box_mesh((4, 3, 3), 3, hi=(L, L, L), perturb=0.1,
                              seed=3)
        second = mesh.cell_corners_flat.mean(axis=1)[:, 0] > L / 2
        second = second.reshape(mesh.nc)
        facets = (mesh.boundary_facets("x-"), mesh.all_boundary_facets())
    else:
        mesh = msh_io.read_msh(_cyl_file(str(directory), 4), 3)
        second = mesh.cell_corners_flat.mean(axis=1)[:, 2] > 0.01
        facets = (mesh.boundary_facets(1), mesh.boundary_facets(2))
    if name.endswith("two_layer"):
        kw.update(sound_speed=np.where(second, 1650.0, 1500.0),
                  density=np.where(second, 1050.0, 1000.0))
    else:
        kw.update(sound_speed=1500.0, density=1000.0)
    cls = WesterveltModel if west else LinearWaveModel
    return (cls, mesh, Material(**kw), Source(frequency=0.5e6,
                                              amplitude=6e4)) + facets


_REFERENCES = {}


def _model_reference(ref, directory, mesh_kind, name):
    """The JAX model in corner mode (float64; the structured corner kernel
    in interpret mode, as the JAX package's own tests run it), its dt, a
    seeded initial state and its 10-step run (cached)."""
    key = (str(directory), mesh_kind, name)
    if key in _REFERENCES:
        return _REFERENCES[key]
    jnp, ps = ref.jnp, ref.ps
    cls, mesh, mat, src, sfac, afac = _model_config(directory, mesh_kind,
                                                    name)
    if mesh_kind == "box":
        fmesh = ref.box.BoxMesh(degree=3, nc=mesh.nc, lo=mesh.lo, hi=mesh.hi,
                                vertex_coords=mesh.vertex_coords)
    else:
        fmesh = ref.msh.read_msh(_cyl_file(str(directory), 4), 3)
    fmat = ref.config.Material(
        sound_speed=mat.sound_speed, density=mat.density,
        nonlinearity=mat.nonlinearity, attenuation_dB=mat.attenuation_dB)
    fsrc = ref.config.Source(frequency=0.5e6, amplitude=6e4)
    fcls = ref.FWest if cls is WesterveltModel else ref.FLinear
    fmodel = fcls(fmesh, fmat, fsrc, sfac, afac, dtype=jnp.float64,
                  stiffness_impl="pallas_corner")
    assert (fmodel._corner if mesh_kind == "box" else fmodel._ext_corner)
    dt, _ = fmodel.cfl_dt()
    rng = np.random.default_rng(0)
    u0 = rng.standard_normal(mesh.grid_shape)
    v0 = rng.standard_normal(mesh.grid_shape)
    s0 = fmodel.init_state(0.0, u0=u0, v0=v0)
    orig = ps.stiffness_apply_pallas
    ps.stiffness_apply_pallas = functools.partial(orig, interpret=True)
    try:
        out, _ = fmodel.solve(s0, dt, STEPS)
        out = ref.jax.block_until_ready(out)
    finally:
        ps.stiffness_apply_pallas = orig
    _REFERENCES[key] = SimpleNamespace(
        cls=cls, mesh=mesh, mat=mat, src=src, sfac=sfac, afac=afac,
        fmodel=fmodel, dt=dt, u0=u0, v0=v0, s0=s0, out=out)
    return _REFERENCES[key]


@pytest.mark.parametrize("mesh_kind", ["box", "cylinder"])
@pytest.mark.parametrize("name", MODELS)
def test_model_matches_fustpu(ref, msh_dir, mesh_kind, name):
    """stiffness_impl="pallas_corner": the corner operator (pair for the
    two-layer Westervelt), no host metric, and the JAX corner model's
    10-step trajectory."""
    r = _model_reference(ref, msh_dir, mesh_kind, name)
    model = r.cls(r.mesh, r.mat, r.src, r.sfac, r.afac, dtype=F64,
                  device="cpu", stiffness_impl="pallas_corner")
    assert model.impl == "mm" and isinstance(model.stiffness,
                                             CornerStiffness)
    assert model.stiffness.is_pair == (name == "westervelt_two_layer")
    assert model.cfl_dt() == r.fmodel.cfl_dt()
    out, _ = model.solve(model.init_state(0.0, u0=r.u0, v0=r.v0), r.dt, STEPS)
    assert out.t == pytest.approx(float(r.out.t), rel=1e-15)
    assert rel(out.u, r.out.u) <= MODEL_TOL
    assert rel(out.v, r.out.v) <= MODEL_TOL
    # the capacity mode never computes the host metric
    assert "_G_host" not in model.disc.__dict__


def _np_params(ref, fmodel):
    """The JAX corner model's params as numpy arrays, stiffness as the
    keyword arrays of convert.corner_from_fustpu."""
    p = fmodel.params
    out = {k: np.asarray(v) for k, v in p.items() if k != "stiff"}
    op = p["stiff"]
    if isinstance(op, tuple):                  # two folded box operators
        out["stiff"] = dict(JC=tuple(np.asarray(o.JC) for o in op),
                            D=np.asarray(op[0].statics[0]))
    elif isinstance(op, ref.ps.PallasStiffnessCorner):
        out["stiff"] = dict(JC=np.asarray(op.JC),
                            D=np.asarray(op.statics[0]))
    else:
        assert isinstance(op, ref.pex.PallasExtrudedCorner)
        out["stiff"] = dict(T=np.asarray(op.T), D=np.asarray(op.statics[0]))
        if op.ce is not None:
            out["stiff"]["C"] = np.asarray(op.ce)
    return out


@pytest.mark.parametrize("mesh_kind", ["box", "cylinder"])
@pytest.mark.parametrize("name", MODELS)
def test_model_from_fustpu_trajectory_matches(ref, msh_dir, mesh_kind,
                                              name):
    """A port model built from the JAX corner model's params runs the same
    trajectory on the corner operator."""
    r = _model_reference(ref, msh_dir, mesh_kind, name)
    state = tuple(np.asarray(x) for x in r.s0[:4]) + (float(r.s0.t),)
    model, st = convert.model_from_fustpu(
        r.cls, _np_params(ref, r.fmodel), state, mesh=r.mesh,
        material=r.mat, source=r.src, source_facets=r.sfac, dtype=F64,
        device="cpu")
    assert isinstance(model.stiffness, CornerStiffness)
    assert model.stiffness.is_pair == (name == "westervelt_two_layer")
    out, _ = model.solve(st, r.dt, STEPS)
    assert rel(out.u, r.out.u) <= MODEL_TOL
    assert rel(out.v, r.out.v) <= MODEL_TOL


def test_hex27_model_matches_g_stream():
    """The two-layer Westervelt model on the curved hex27 prism: corner
    mode (163 channels, the pair operator) against the G-stream model,
    10 steps, and no host metric."""
    mesh = _port_mesh(None, "curved", 3)
    zc = mesh.cell_corners_flat.mean(axis=1)[:, 2]
    # a metre-scale mesh: 1 kHz and a weak attenuation keep the explicit
    # steps stable (the diffusivity grows as 1 / frequency^2)
    mat = Material(sound_speed=np.where(zc > 1.5, 1650.0, 1500.0),
                   density=np.where(zc > 1.5, 1050.0, 1000.0),
                   nonlinearity=3.5, attenuation_dB=0.2)
    bd = mesh.boundary_facets()
    args = (mesh, mat, Source(frequency=1e3, amplitude=6e4), bd[:4], bd[4:])
    a = WesterveltModel(*args, dtype=F64, device="cpu")
    b = WesterveltModel(*args, dtype=F64, device="cpu",
                        stiffness_impl="extruded_pallas_corner")
    assert isinstance(b.stiffness, CornerStiffness) and b.stiffness.is_pair
    assert b.stiffness.geom_deg == 2 and b.stiffness.T.shape[1] == 163
    dt, _ = a.cfl_dt()
    rng = np.random.default_rng(3)
    u0, v0 = rng.standard_normal(mesh.ndofs), rng.standard_normal(mesh.ndofs)
    sa, _ = a.solve(a.init_state(0.0, u0=u0, v0=v0), dt, STEPS)
    sb, _ = b.solve(b.init_state(0.0, u0=u0, v0=v0), dt, STEPS)
    assert rel(sb.u, sa.u) <= MODEL_TOL and rel(sb.v, sa.v) <= MODEL_TOL
    assert "_G_host" not in b.disc.__dict__


@pytest.mark.parametrize("two_layer", [False, True])
@pytest.mark.parametrize("kind", ["box", "curved"])
def test_corner_model_never_builds_the_metric(monkeypatch, kind, two_layer):
    """A corner-mode Westervelt model on the box (trilinear) and on the
    curved hex27 prism builds and steps without calling the host metric
    builder or its metric step, which both maps share (the mass diagonals
    take detJ alone)."""
    def refuse(*args, **kwargs):
        raise AssertionError("the corner mode built the host metric")

    monkeypatch.setattr(pre, "cell_geometry_factors", refuse)
    monkeypatch.setattr(pre, "_metric", refuse)
    mesh = _port_mesh(None, kind, 3)
    zc = mesh.cell_corners_flat.mean(axis=1)[:, 2]
    second = zc > np.median(zc)
    if kind == "box":
        second = second.reshape(mesh.nc)
        facets = (mesh.boundary_facets("x-"), mesh.all_boundary_facets())
    else:
        bd = mesh.boundary_facets()
        facets = (bd[:4], bd[4:])
    c, rho = (np.where(second, 1650.0, 1500.0),
              np.where(second, 1050.0, 1000.0)) if two_layer \
        else (1500.0, 1000.0)
    model = WesterveltModel(
        mesh, Material(sound_speed=c, density=rho, nonlinearity=3.5,
                       attenuation_dB=0.2),
        Source(frequency=1e3, amplitude=6e4), *facets, dtype=F64,
        device="cpu", stiffness_impl="pallas_corner")
    assert isinstance(model.stiffness, CornerStiffness)
    assert model.stiffness.is_pair == two_layer
    dt, _ = model.cfl_dt()
    rng = np.random.default_rng(6)
    u0 = rng.standard_normal(mesh.grid_shape)
    out, _ = model.solve(model.init_state(0.0, u0=u0), dt, 2)
    assert bool(torch.isfinite(out.u).all())
    assert "_G_host" not in model.disc.__dict__


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["pallas_corner", "extruded_pallas_corner"])
@pytest.mark.parametrize("device,resolved", [("cuda", "cuda"),
                                             ("cpu", "mm")])
def test_corner_names_resolve(impl, device, resolved):
    """Both corner-mode names resolve as 'auto' does: the kernel on a CUDA
    device, the plain version elsewhere."""
    assert resolve_stiffness_impl(impl, device) == resolved


def test_general_mesh_takes_the_indexed_operator(ref):
    """"pallas_corner" on a non-prismatic mesh runs the indexed operator,
    as the JAX package routes it; on a box and an extruded mesh it runs
    the corner operator."""
    um = from_box(build_box_mesh((2, 2, 2), 2, perturb=0.2, seed=4))
    assert as_extruded(um) is None
    fum = ref.un.from_box(ref.box.build_box_mesh((2, 2, 2), 2, perturb=0.2,
                                                 seed=4))
    fdisc = ref.disc.Discretization(fum, ref.jnp.float64)
    assert ref.disc.resolve_stiffness_impl("pallas_corner", fdisc) == \
        "indexed"
    model = LinearWaveModel(um, Material(), Source(),
                            um.boundary_facets()[:4], None, dtype=F64,
                            device="cpu", stiffness_impl="pallas_corner")
    assert isinstance(model.stiffness, IndexedStiffness)
    ex = as_extruded(from_box(build_box_mesh((2, 2, 2), 2)))
    for mesh in (ex, build_box_mesh((2, 2, 2), 2)):
        facets = (mesh.boundary_facets()[:4] if mesh is ex
                  else mesh.boundary_facets("x-"))
        model = LinearWaveModel(mesh, Material(), Source(), facets, None,
                                dtype=F64, device="cpu",
                                stiffness_impl="pallas_corner")
        assert isinstance(model.stiffness, CornerStiffness)
        assert "_G_host" not in model.disc.__dict__


# ---------------------------------------------------------------------------
# The capacity demos
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("demo,argv", [
    ("capacity", ["--cells", "6", "3", "3", "--degree", "2"]),
    ("capacity_imported", ["--m", "3", "--mr", "1", "--nr-ann", "1",
                           "--nz", "3", "--degree", "2"])])
def test_capacity_demo_cli(demo, argv):
    cmd = [sys.executable, "-m", f"fustpu_torch.demos.{demo}", "--device",
           "cpu", "--dtype", "f64", "--steps", "3", *argv]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "CornerStiffness" in out.stdout and "corner mode True" in \
        out.stdout
    assert "ms/step" in out.stdout
    m = re.search(r"\|u\| max \(finite check\): (\S+)", out.stdout)
    assert m and np.isfinite(float(m.group(1))) and float(m.group(1)) > 0


def test_exp_pencil_corner_demo_on_cpu(capsys):
    """The exp_pencil demo with --corner at a small size on the CPU: #3's
    class-launch design and walk, single and pair, each equal to the plain
    version (on the CPU each wrapper runs it), and the CPU named as the
    clock."""
    from fustpu_torch.demos import exp_pencil

    out = exp_pencil.main(["--device", "cpu", "--nc", "4", "3", "5",
                           "--degree", "2", "--chain", "1", "--reps", "1",
                           "--corner"])
    assert set(out) == {"mesh", "single", "pair"}
    for form in ("single", "pair"):
        f = out[form]
        assert f["op"].box and set(f["ys"]) == {"classes", "walk"}
        assert all(rel(y, f["plain"]) <= TOL for y in f["ys"].values())
        assert len(f["times"]["walk"]) == len(f["times"]["classes"]) == 2
    assert capsys.readouterr().out.count("host clock on the CPU") == 1


# ---------------------------------------------------------------------------
# The walk's schedules (box pencils and stacks with the corner's channels)
# ---------------------------------------------------------------------------

def _covered(chunks, ncells):
    covered = np.zeros(ncells, np.int64)
    for c0, m, *_ in chunks:
        covered[c0:c0 + m] += 1
    return covered


def _check_spans(sched, ncells, cell_bytes):
    """Every chunk's bulk-copy span of channels 16 B-aligned, inside the
    array, covering the chunk's run of channels (short of it only at the
    array's end, by less than 16 B, which the kernel reads itself), and
    within a stage."""
    ch = sched.chunks
    total = ncells * cell_bytes
    start, end = ch[:, 0] * cell_bytes, (ch[:, 0] + ch[:, 1]) * cell_bytes
    off, nbytes = ch[:, 2], ch[:, 3]
    assert (off % 16 == 0).all() and (nbytes % 16 == 0).all()
    assert (off >= 0).all() and (off + nbytes <= total).all()
    assert (off <= start).all() and (start - off < 16).all()
    short = end - (off + nbytes)
    assert ((short <= 0) | ((end == total) & (short < 16))).all()
    assert (start - off + ch[:, 1] * cell_bytes <= sched.stage_bytes).all()
    return short


def test_corner_smem_layout():
    """The walk's shared memory with the corner's channels: a stage holds
    cpb cells of channels (and 16 B of slack) instead of G, and the block
    keeps every cell's f1, f2 and the GLL nodes and weights after the
    buffers."""
    n, cpb = 5, 5
    stage_g, smem_g = cs.pencil_smem(4, 4, cpb)
    stage, smem = cs.pencil_smem(4, 4, cpb, channels=37)
    assert stage == -(-(cpb * 37 * 4 + 16) // 16) * 16 == 768
    assert smem - stage * cs.STAGES == \
        smem_g - stage_g * cs.STAGES + (2 * n ** 3 * cpb + 2 * n) * 4
    assert [cs.corner_channels(g) for g in (1, 2)] == [37, 163]
    assert cs.pencil_smem(4, 8, 2, pair=True, ids=True, channels=163)[0] == \
        -(-(2 * 163 * 8 + 16) // 16) * 16


@pytest.mark.parametrize("nc", [(4, 3, 5), (1, 1, 1), (2, 3, 29)])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("P", range(2, 11))
def test_corner_pencil_schedule(P, itemsize, nc):
    """The box walk's schedule with 37 channels a cell, single and pair:
    every cell once, 4 classes at most, a block's shared bytes within the
    card's 232,448 and 256 threads, and the channel spans aligned and cut
    back at the array's end (148 B a cell in float32 is 4 mod 16)."""
    ncells = nc[0] * nc[1] * nc[2]
    for pair in (False, True):
        s = cs.pencil_schedule(nc, P, itemsize, sms=132, pair=pair,
                               channels=37)
        assert (s.stage_bytes, s.smem) == cs.pencil_smem(
            P, itemsize, s.cpb, pair, channels=37)
        static = -(-(P + 1) ** 2 * itemsize // 128) * 128
        assert s.smem + static <= 232_448
        assert (P + 1) ** 2 * s.cpb <= cs.MAX_THREADS == 256
        assert len(s.classes) <= 4
        assert (_covered(s.chunks, ncells) == 1).all()
        short = _check_spans(s, ncells, 37 * itemsize)
        if itemsize == 4 and ncells % 4:
            assert short.max() > 0          # cut back at the array's end


@pytest.mark.parametrize("geo", [1, 2])
@pytest.mark.parametrize("kind", ["structured", "unstructured"])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("P", [2, 4, 7, 10])
def test_corner_stack_schedule(msh_dir, P, itemsize, kind, geo):
    """The stack walk's schedule with 37 (hex8) or 163 (hex27) channels a
    cell, single and pair, with the model's segments and with stacks cut
    into 3: every cell once, no two segments of a class sharing a dof, the
    channel spans aligned and cut back at the array's end."""
    if kind == "structured":
        mesh = as_extruded(from_box(build_box_mesh((3, 2, 7), P)))
    else:
        mesh = msh_io.read_msh(_cyl_file(str(msh_dir), 4), P)
    ch = cs.corner_channels(geo)
    colour = ce.colour_stacks(mesh.rows2d)
    ncells, gz = mesh.rows2d.shape[0] * mesh.nz, mesh.nz * P + 1
    for pair in (False, True):
        for segments in (None, 3):
            s = ce.stack_schedule(colour, mesh.rows2d, mesh.nz, P, itemsize,
                                  sms=132, pair=pair, segments=segments,
                                  channels=ch)
            assert (s.stage_bytes, s.smem) == cs.pencil_smem(
                P, itemsize, s.cpb, pair, ids=True, channels=ch)
            assert (P + 1) ** 2 * s.cpb <= cs.MAX_THREADS
            assert (_covered(s.chunks, ncells) == 1).all()
            _check_spans(s, ncells, ch * itemsize)
            first = 0
            for _, segs, per in s.classes:
                seen = np.zeros(mesh.n2d * gz, np.int64)
                for u in range(segs):
                    rows = s.chunks[first + u * per:first + (u + 1) * per]
                    z0 = rows[0, 0] % mesh.nz
                    z1 = (rows[-1, 0] + rows[-1, 1] - 1) % mesh.nz + 1
                    stack = rows[0, 0] // mesh.nz
                    seen[(mesh.rows2d[stack][:, None] * gz + np.arange(
                        z0 * P, z1 * P + 1)[None, :]).reshape(-1)] += 1
                assert seen.max() <= 1
                first += segs * per


def test_corner_schedules_follow_the_occupancy():
    """The cells a chunk follow the occupancy answer, which is asked with
    the corner layout's shared bytes: with one block of 3 cells an SM, 3
    cells a chunk and that many blocks, on box pencils and on stacks; a
    block beyond the kernel's launch bounds, which the card's answer
    refuses with 0 (the float32 single-field trilinear walk at P <= 4:
    128 threads), is never chosen, and a fixed cpb there is refused; on
    the flagship's box pencils, with 5 blocks of 5 cells an SM, 5 cells a
    chunk (each class's 640 pencils on 660 blocks at once, 8 chunks a
    pencil)."""
    calls = []

    def occupancy(P, itemsize, pair, cpb, smem):
        calls.append((cpb, smem))
        return 1 if cpb == 3 else 0

    s = cs.pencil_schedule((3, 2, 5), 4, 4, sms=7, occupancy=occupancy,
                           channels=37)
    assert (s.cpb, s.blocks_per_sm, s.blocks) == (3, 1, 7)
    # at most ncz = 5 cells a chunk
    assert calls == [(c, cs.pencil_smem(4, 4, c, channels=37)[1])
                     for c in range(1, 6)]
    calls.clear()

    def card(P, itemsize, pair, cpb, smem):
        calls.append(cpb)
        return 0 if (P + 1) ** 2 * cpb > 128 else {5: 5}.get(cpb, 1)

    flagship = cs.pencil_schedule((64, 40, 40), 4, 4, sms=132,
                                  occupancy=card, channels=37)
    assert (flagship.cpb, flagship.blocks) == (5, 660)
    assert flagship.classes[:, 2].tolist() == [8] * 4
    assert calls == list(range(1, 11))      # 256 threads: 10 cells of 25
    wide = cs.pencil_schedule((64, 40, 40), 2, 4, sms=132,
                              occupancy=card, channels=37)
    assert 9 * wide.cpb <= 128
    with pytest.raises(ValueError, match="fits an SM"):
        cs.pencil_schedule((64, 40, 40), 4, 4, sms=132, occupancy=card,
                           channels=37, cpb=6)
    with pytest.raises(ValueError, match="more than 256 threads"):
        cs.pencil_schedule((64, 40, 40), 4, 4, sms=132, channels=37,
                           cpb=11)
    fixed = cs.pencil_schedule((64, 40, 40), 4, 4, sms=132, occupancy=card,
                               channels=37, cpb=3)
    assert fixed.cpb == 3 and (_covered(fixed.chunks, 64 * 40 * 40)
                               == 1).all()
    with pytest.raises(ValueError, match="fits an SM"):
        ce.stack_schedule(np.zeros(4, np.int64), np.zeros((4, 25), np.int32),
                          8, 4, 4, sms=1, occupancy=card, channels=37,
                          cpb=6)
    calls.clear()
    s = ce.stack_schedule(np.zeros(4, np.int64), np.zeros((4, 9), np.int32),
                          5, 2, 8, sms=1, occupancy=occupancy, channels=163)
    assert (s.cpb, s.blocks) == (3, 1)
    assert calls[0] == (1, cs.pencil_smem(2, 8, 1, ids=True,
                                          channels=163)[1])


# ---------------------------------------------------------------------------
# The walk's order of adds against the JAX package's corner kernels
# ---------------------------------------------------------------------------

def _walk_meshes(ref, directory, kind, P):
    """(port mesh, JAX mesh) with an odd number of cells along the walk:
    a perturbed box of 5 cells in z, the imported cylinder of 5 layers, a
    curved hex27 prism of 5 layers."""
    if kind == "box":
        m = build_box_mesh((3, 2, 5), P, hi=(1.0, 0.8, 1.3), perturb=0.15,
                           seed=7)
        return m, ref.box.BoxMesh(degree=P, nc=m.nc, lo=m.lo, hi=m.hi,
                                  vertex_coords=m.vertex_coords)
    if kind == "cylinder":
        f = _cyl_file(str(directory), 5)
        return msh_io.read_msh(f, P), ref.msh.read_msh(f, P)
    return (as_extruded(shapes.hex27_lattice(
        from_box(build_box_mesh((2, 2, 5), P), shuffle_seed=11),
        shapes.curved_prism_map)),
        ref.ext.as_extruded(shapes.hex27_lattice(
            ref.un.from_box(ref.box.build_box_mesh((2, 2, 5), P),
                            shuffle_seed=11), shapes.curved_prism_map)))


@pytest.mark.parametrize("small_card", [False, True])
@pytest.mark.parametrize("kind,P", [("box", 3), ("cylinder", 2),
                                    ("curved", 2)])
def test_walk_order_matches_pallas_interpret(ref, msh_dir, kind, P,
                                             small_card):
    """The walk's schedule, emulated in float64 (its classes, segments,
    chunks and turns; the emulators of the G-stream walks on the metric
    that the channels give), against the JAX package's corner kernels in
    interpret mode, single (with a coefficient) and pair: the box against
    `_apply_corner` (its pair against two folded corner operators), the
    imported hex8 and curved hex27 stacks against the extruded kernel with
    `corner` set; on a card of 132 SMs (the model's schedule) and on a
    card that holds one block of 2 cells (chunks of 2, 2 and 1)."""
    from test_torch_extruded import _stack_emulate
    from test_torch_stiffness import _emulate

    jnp, ps, pex = ref.jnp, ref.ps, ref.pex
    mesh, fmesh = _walk_meshes(ref, msh_dir, kind, P)
    D = mesh.element.deriv_1d
    rng = np.random.default_rng(P)
    shape = mesh.nc if kind == "box" else (mesh.num_cells,)
    c1, c2 = rng.uniform(0.5, 2.0, shape), rng.uniform(-1.5, -0.5, shape)
    x1, x2 = (rng.standard_normal(mesh.grid_shape) for _ in range(2))
    disc = Discretization(mesh)
    op = disc.stiffness_op(F64, "cpu", coeff=c1, corner=True)
    pop = disc.stiffness_op(F64, "cpu", pair=(c1, c2), corner=True)
    small = dict(sms=1, occupancy=lambda *a: int(a[3] == 2))
    big = dict(sms=132)
    card = small if small_card else big
    X1, X2 = torch.as_tensor(x1), torch.as_tensor(x2)
    if kind == "box":
        sched = cs.pencil_schedule(mesh.nc, P, 8, channels=op.channels,
                                   **card)

        def fapply(coeff, x):
            fop = ps.build_auto(fmesh.nc, P, D, None, jnp.float64,
                                coeff=coeff.reshape(-1),
                                corners=fmesh.cell_corners_flat)
            assert isinstance(fop, ps.PallasStiffnessCorner)
            return np.asarray(ps.stiffness_apply_pallas(
                fop, jnp.asarray(x), interpret=True, precision=ps._HI))

        want, want_pair = fapply(c1, x1), fapply(c1, x1) + fapply(c2, x2)
        got = _emulate(cc.to_g_stream(op), sched, X1)
        got_pair = _emulate(cc.to_g_stream(pop), sched, X1, X2)
    else:
        sched = ce.stack_schedule(
            op.plan.colour, mesh.rows2d, mesh.nz, P, 8, channels=op.channels,
            segments=1 if small_card else None, **card)
        fo = pex.build_extruded_corner(fmesh, D, jnp.float64, coeff=c1)
        want = np.asarray(pex.stiffness_apply_extruded_pallas(
            jnp.asarray(x1), fo, mesh.ndofs, interpret=True,
            precision=pex._HI))
        fp = pex.build_extruded_corner(fmesh, D, jnp.float64, c1_cells=c1,
                                       c2_cells=c2)
        want_pair = np.asarray(pex.stiffness_apply_extruded_pallas_pair(
            jnp.asarray(x1), jnp.asarray(x2), fp, mesh.ndofs, interpret=True,
            precision=pex._HI))
        got = _stack_emulate(cc.to_g_stream(op), sched, X1)
        got_pair = _stack_emulate(cc.to_g_stream(pop), sched, X1, X2)
    if small_card:
        assert sched.cpb == 2 and sorted(
            set(sched.chunks[:, 1].tolist())) == [1, 2]
    assert rel(got, want) <= TOL
    assert rel(got_pair, want_pair) <= TOL


# ---------------------------------------------------------------------------
# The wrappers' checks, before any launch (no card needed)
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("kind", ["box", "cylinder"])
def test_wrappers_refuse_before_any_launch(monkeypatch, msh_dir, kind):
    """A field of the wrong dtype, device or size, an operator of a degree
    outside 2..10 or of the wrong channel count, a pair apply without
    pair coefficients, and misaligned channels: each raises in the walk's
    wrappers and the class-launch designs' before the kernel library is
    loaded or a schedule built."""
    from fustpu_torch import _build

    def refuse(*args, **kwargs):
        raise AssertionError("the wrapper reached the kernel library")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(cc, "_card", refuse)
    k = _case(msh_dir, kind, 3)
    op = k.disc.stiffness_op(F64, "cpu", corner=True)
    single = (cc.corner, cc.corner_classes) if kind == "box" else \
        (cc.extruded_corner, cc.extruded_corner_classes)
    pair = (cc.corner_pair, cc.corner_classes_pair) if kind == "box" else \
        (cc.extruded_corner_pair, cc.extruded_corner_classes_pair)
    card = _on_card(op)
    x = torch.as_tensor(k.x1).as_subclass(_OnCard)
    T = op.T
    base = torch.zeros(T.numel() + 1, dtype=F64)
    base[1:].copy_(T.reshape(-1))
    cases = [
        (card, x.to(torch.float32).as_subclass(_OnCard), "T is"),
        (card, x.to(torch.float16).as_subclass(_OnCard), "dtype"),
        (op, x, "on cpu"),
        (card, x.reshape(-1)[1:].as_subclass(_OnCard), "shape"),
        (_on_card(op._replace(T=T[:, :-1].contiguous())), x, "T has shape"),
        (_on_card(k.disc.stiffness_op(F64, "cpu", corner=True)._replace(
            D=torch.zeros(12, 12, dtype=F64))), x, "degree 11"),
        (_on_card(op._replace(T=base[1:].view(T.shape))), x, "16 B")]
    for o, xx, match in cases:
        for fn in single:
            if match == "16 B" and fn in (cc.corner_classes,
                                          cc.extruded_corner_classes):
                continue             # the class-launch design takes it
            with pytest.raises(ValueError, match=match):
                fn(o, xx)
    for fn in pair:
        with pytest.raises(ValueError, match="pair coefficients"):
            fn(card, x, x)
    other = cc.extruded_corner if kind == "box" else cc.corner
    with pytest.raises(ValueError, match="operator"):
        other(card, x)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("P", range(2, 11))
def test_kernels_match_plain_on_card(tmp_path, kind, P):
    """Corner CUDA kernels vs their plain version on the card (float64 to
    1e-12, float32 to 1e-5 against the float64 plain version), single with
    and without a coefficient and pair; a repeated apply is bitwise
    identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    k = _case(tmp_path, kind, P, seed=P)
    x1 = torch.as_tensor(k.x1, device="cuda")
    x2 = torch.as_tensor(k.x2, device="cuda")
    before = dict(cc.launches)
    for kw in (dict(), dict(coeff=k.c1), dict(pair=(k.c1, k.c2))):
        pair = "pair" in kw
        ref_op = k.disc.stiffness_op(F64, "cuda", corner=True, **kw)
        y_ref = (cc.corner_pair_plain(ref_op, x1, x2) if pair
                 else cc.corner_plain(ref_op, x1)).cpu()
        for dtype, tol in ((F64, TOL), (torch.float32, 1e-5)):
            op = k.disc.stiffness_op(dtype, "cuda", corner=True, **kw)
            mod = CornerStiffness(op, "cuda")
            run = (lambda: mod.pair(x1.to(dtype), x2.to(dtype))) if pair \
                else (lambda: mod(x1.to(dtype)))
            y = run()
            torch.cuda.synchronize()
            assert rel(y.cpu(), y_ref) <= tol
            assert torch.equal(run(), y)
    name = "corner" if kind == "box" else (
        "extruded_corner_hex27" if kind == "curved" else "extruded_corner")
    assert cc.launches[name] == before[name] + 8
    assert cc.launches[name + "_pair"] == before[name + "_pair"] + 4


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS + ["long"])
@pytest.mark.parametrize("P", range(2, 11))
def test_walk_matches_class_launch_on_card(tmp_path, kind, P):
    """The walk (box pencils, hex8 and hex27 stacks) against the
    class-launch design it replaced, single with a coefficient and pair:
    float64 to 1e-14 (they differ in the order of their sums), float32 to
    1e-6 (the float32 walk also divides by a reciprocal), each also against
    the float64 plain version (1e-12, 1e-6); a repeated apply bitwise
    equal; "long" is a box of one long odd pencil (several chunks a
    pencil)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    if kind == "long":
        mesh = build_box_mesh((1, 2, 29), P, perturb=0.15, seed=P)
        rng = np.random.default_rng(P)
        k = SimpleNamespace(mesh=mesh, disc=Discretization(mesh),
                            x1=rng.standard_normal(mesh.grid_shape),
                            x2=rng.standard_normal(mesh.grid_shape),
                            c1=rng.uniform(0.5, 2.0, mesh.nc),
                            c2=rng.uniform(-1.5, -0.5, mesh.nc))
    else:
        k = _case(tmp_path, kind, P, seed=P)
    box = kind in ("box", "long")
    x1 = torch.as_tensor(k.x1, device="cuda")
    x2 = torch.as_tensor(k.x2, device="cuda")
    walk = (cc.corner, cc.corner_pair) if box else \
        (cc.extruded_corner, cc.extruded_corner_pair)
    old = (cc.corner_classes, cc.corner_classes_pair) if box else \
        (cc.extruded_corner_classes, cc.extruded_corner_classes_pair)
    before = dict(cc.class_launches)
    for kw in (dict(coeff=k.c1), dict(pair=(k.c1, k.c2))):
        i = 1 if "pair" in kw else 0
        args = (x1, x2) if i else (x1,)
        ref_op = k.disc.stiffness_op(F64, "cuda", corner=True, **kw)
        y_ref = (cc.corner_pair_plain(ref_op, *args) if i
                 else cc.corner_plain(ref_op, *args)).cpu()
        for dtype, tol, tol_old in ((F64, TOL, 1e-14),
                                    (torch.float32, 1e-6, 1e-6)):
            op = k.disc.stiffness_op(dtype, "cuda", corner=True, **kw)
            a = tuple(t.to(dtype) for t in args)
            y = walk[i](op, *a)
            y_old = old[i](op, *a)
            torch.cuda.synchronize()
            assert rel(y.cpu(), y_ref) <= tol
            assert rel(y.cpu(), y_old.cpu()) <= tol_old
            assert torch.equal(walk[i](op, *a), y)
    name = "corner" if box else (
        "extruded_corner_hex27" if kind == "curved" else "extruded_corner")
    assert cc.class_launches[name + "_classes"] == \
        before[name + "_classes"] + 2
    assert cc.class_launches[name + "_classes_pair"] == \
        before[name + "_classes_pair"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("P", range(2, 11))
def test_occupancy_answers_follow_the_launch_bounds_on_card(P):
    """Each pencil kernel's occupancy query answers 0 for a block beyond
    its launch bounds, so that the schedules take the limit from the
    kernel: 128 threads for the float32 single-field trilinear corner walk
    at P <= 4 (box pencils and hex8 stacks), 256 for every other
    instantiation (the G stream, the pair and hex27 forms, float64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    from fustpu_torch import _build

    lib = _build.load()
    n = P + 1
    entries = [(name, geo, False) for geo, name in enumerate(cs.OCCUPANCY)]
    entries += [(name, geo, True) for geo, name in enumerate(ce.OCCUPANCY)]
    for name, geo, ids in entries:
        channels = cs.corner_channels(geo) if geo else 0
        for itemsize in (4, 8):
            for pair in (False, True):
                capped = (geo == 1 and itemsize == 4 and not pair and P <= 4)
                most = 128 if capped else 256
                for cpb in range(1, 256 // (n * n) + 1):
                    smem = cs.pencil_smem(P, itemsize, cpb, pair, ids=ids,
                                          channels=channels)[1]
                    if smem + cs._static_smem(P, itemsize) > cs.SMEM_BLOCK:
                        break
                    got = getattr(lib, name)(P, int(itemsize == 8),
                                             int(pair), cpb, smem)
                    assert (got == 0) == (n * n * cpb > most), \
                        (name, itemsize, pair, cpb, got)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [2, 4, 6])
def test_box_walk_at_every_cpb_on_card(P):
    """The box walk under every cells a chunk that its kernel takes
    (`cpb`, the sweep of ``demos/exp_pencil --corner --sweep``), single and
    pair, against the float64 plain version (float64 to 1e-12, float32 to
    1e-6) and bitwise repeatable; a cells a chunk beyond the launch bounds
    (the float32 single-field walk at P <= 4: 128 threads) or the
    pencil's 23 cells is refused before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    mesh = build_box_mesh((3, 2, 23), P, perturb=0.15, seed=P)
    rng = np.random.default_rng(P)
    disc = Discretization(mesh)
    xs = [torch.as_tensor(rng.standard_normal(mesh.grid_shape),
                          device="cuda") for _ in range(2)]
    c1, c2 = rng.uniform(0.5, 2.0, mesh.nc), rng.uniform(-2.0, 2.0, mesh.nc)
    for kw, fn in ((dict(coeff=c1), cc.corner),
                   (dict(pair=(c1, c2)), cc.corner_pair)):
        pair = "pair" in kw
        a64 = xs if pair else xs[:1]
        y_ref = (cc.corner_pair_plain if pair else cc.corner_plain)(
            disc.stiffness_op(F64, "cuda", corner=True, **kw), *a64).cpu()
        for dtype, tol in ((F64, TOL), (torch.float32, 1e-6)):
            op = disc.stiffness_op(dtype, "cuda", corner=True, **kw)
            a = tuple(t.to(dtype) for t in a64)
            capped = dtype == torch.float32 and not pair and P <= 4
            ran = []
            for cpb in range(1, 256 // (P + 1) ** 2 + 1):
                try:
                    cc.card_schedule(op, a[0], pair, cpb=cpb)
                except ValueError:
                    before = dict(cc.launches)
                    with pytest.raises(ValueError):
                        fn(op, *a, cpb=cpb)
                    assert cc.launches == before
                    continue
                y = fn(op, *a, cpb=cpb)
                assert rel(y.cpu(), y_ref) <= tol
                assert torch.equal(fn(op, *a, cpb=cpb), y)
                ran.append(cpb)
            most = min((128 if capped else 256) // (P + 1) ** 2, mesh.nc[2])
            assert ran == list(range(1, most + 1)), (dtype, pair, ran)
