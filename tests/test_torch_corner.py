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
