"""bfloat16 in the corner-streamed capacity mode (the JAX package's
``--dtype bf16`` with ``stiffness_impl="pallas_corner"`` /
``"extruded_pallas_corner"``): the port's bf16 corner applies, models,
conversions, schedules and demos against the JAX package's bf16 corner
operators and models, on the CPU, and, on a card, the bf16 forms of the
corner walk (#3 on box pencils, #6c on hex8 and hex27 stacks) against
their plain versions.

The helpers, the `ref` fixture (the JAX package imported inside it) and
the tolerances are ``tests/test_torch_bf16.py``'s, where they are
explained; the stand-in for a card tensor is
``tests/test_torch_corner.py``'s.  The card tests run on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_bf16_corner.py -m cuda
"""

import functools
import importlib

import numpy as np
import pytest
import torch

from fustpu_torch import convert
from fustpu_torch.config import Material
from fustpu_torch.mesh import msh_io, shapes
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.mesh.extruded import as_extruded
from fustpu_torch.mesh.unstructured import from_box
from fustpu_torch.models import discretization as dz
from fustpu_torch.ops import cuda_corner as cc
from fustpu_torch.ops import cuda_extruded as ce
from fustpu_torch.ops import cuda_stiffness as cs
from test_torch_bf16 import (APPLY_TOL, BF16, CARD_TOL, CYL, DRIFT_FACTOR,
                             TRAJ_TOL, _box_config, _cylinder, _f_kwargs,
                             _fmesh, _initial, _interpret, _widen_op, ref,
                             rel)
from test_torch_corner import _on_card, _OnCard

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# The corner mode (the capacity mode: #3 on a box, #6c on a prismatic
# import, hex8 and hex27)
# ---------------------------------------------------------------------------

CORNER_KINDS = ["box", "mapped", "prismatic", "hex27"]


def _corner_mesh(tmp_path, kind, P=3):
    """A mesh of a corner kind: an unperturbed box, a mapped (perturbed)
    box, the imported test cylinder (hex8 stacks) and the curved hex27
    prism (hex27 stacks)."""
    if kind == "box":
        return build_box_mesh((3, 4, 5), P, hi=(1.0, 0.8, 1.3))
    if kind == "mapped":
        return build_box_mesh((3, 4, 5), P, hi=(1.0, 0.8, 1.3),
                              perturb=0.15, seed=7)
    if kind == "prismatic":
        return msh_io.read_msh(_cylinder(tmp_path), P)
    return as_extruded(shapes.hex27_lattice(
        from_box(build_box_mesh((2, 2, 3), P), shuffle_seed=11),
        shapes.curved_prism_map))


def _corner_fmesh(ref, tmp_path, kind, mesh):
    """The JAX package's twin of `_corner_mesh`."""
    if kind in ("box", "mapped"):
        return _fmesh(ref, mesh)
    if kind == "prismatic":
        return ref.f_msh.read_msh(_cylinder(tmp_path), mesh.degree)
    from fustpu.mesh import box as f_box
    from fustpu.mesh import extruded as f_ext
    from fustpu.mesh import unstructured as f_un

    return f_ext.as_extruded(shapes.hex27_lattice(
        f_un.from_box(f_box.build_box_mesh((2, 2, 3), mesh.degree),
                      shuffle_seed=11), shapes.curved_prism_map))


def _corner_case(tmp_path, kind, P=3, seed=7):
    """(mesh, its Discretization, per-cell c1 and c2, two seeded bf16
    fields)."""
    mesh = _corner_mesh(tmp_path, kind, P)
    rng = np.random.default_rng(seed)
    shape = mesh.nc if hasattr(mesh, "nc") else (mesh.num_cells,)
    c1 = rng.uniform(0.5, 2.0, shape)
    c2 = rng.uniform(-1.5, -0.5, shape)
    xs = [torch.as_tensor(rng.standard_normal(mesh.grid_shape)).to(BF16)
          for _ in range(2)]
    return mesh, dz.Discretization(mesh), c1, c2, xs


def _corner_apply(op, xs, pair):
    """The corner wrappers' apply of `op` (the plain version on CPU
    tensors, the walk on the card)."""
    if op.box:
        return cc.corner_pair(op, *xs) if pair else cc.corner(op, xs[0])
    return (cc.extruded_corner_pair(op, *xs) if pair
            else cc.extruded_corner(op, xs[0]))


@pytest.mark.parametrize("kind", CORNER_KINDS)
@pytest.mark.parametrize("form", ["single", "pair"])
def test_corner_apply_matches_fustpu(ref, tmp_path, monkeypatch, kind,
                                     form):
    """The port's bf16 corner apply (#3's plain version on a box and a
    mapped box, #6c's on the imported cylinder and the hex27 prism) against
    the JAX package's bf16 corner operator on the same channels (its
    structured corner kernel, or its extruded kernel with `corner`, in
    interpret mode; the box pair as the sum of two folded corner operators,
    as the JAX package runs the heterogeneous Westervelt stage):
    <= APPLY_TOL, and each within APPLY_TOL of the port's float64 apply."""
    jnp = ref.jnp
    from fustpu.ops import pallas_extruded as pex

    pair = form == "pair"
    mesh, disc, c1, c2, xs = _corner_case(tmp_path, kind)
    fmesh = _corner_fmesh(ref, tmp_path, kind, mesh)
    D = mesh.element.deriv_1d
    fx = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in xs]
    if hasattr(mesh, "nc"):
        def fapply(c, x):
            op = ref.ps.build_auto(fmesh.nc, mesh.degree, D, None,
                                   jnp.bfloat16, coeff=c.reshape(-1),
                                   corners=fmesh.cell_corners_flat)
            assert isinstance(op, ref.ps.PallasStiffnessCorner)
            return ref.ps.stiffness_apply_pallas(op, x, interpret=True)
        want = (fapply(c1, fx[0]) + fapply(c2, fx[1]) if pair
                else fapply(c1, fx[0]))
    elif pair:
        op = pex.build_extruded_corner(fmesh, D, jnp.bfloat16, c1_cells=c1,
                                       c2_cells=c2)
        want = pex.stiffness_apply_extruded_pallas_pair(
            fx[0], fx[1], op, mesh.ndofs, interpret=True)
    else:
        op = pex.build_extruded_corner(fmesh, D, jnp.bfloat16, coeff=c1)
        want = pex.stiffness_apply_extruded_pallas(fx[0], op, mesh.ndofs,
                                                   interpret=True)
    kw = {"pair": (c1, c2)} if pair else {"coeff": c1}
    got = _corner_apply(disc.stiffness_op(BF16, "cpu", corner=True, **kw),
                        xs, pair)
    exact = _corner_apply(disc.stiffness_op(torch.float64, "cpu",
                                            corner=True, **kw),
                          [x.double() for x in xs], pair)
    assert got.dtype == BF16
    want = np.asarray(want).astype(np.float64)
    assert rel(got, exact) <= APPLY_TOL
    assert rel(want, exact) <= APPLY_TOL
    assert rel(got, want) <= APPLY_TOL


@pytest.mark.parametrize("kind", CORNER_KINDS)
def test_plain_bf16_corner_is_float32_rounded_once(tmp_path, kind):
    """The bf16 corner plain versions (single and pair) equal, bitwise,
    the float32 plain apply of the widened channels, D, C and fields,
    rounded to bf16 once: the semantics the bf16 corner kernels are held
    to.  Their metric is expanded and kept in float32 (`to_g_stream`): a
    metric expanded in the channels' bf16 would round G before the apply,
    which the kernel never does."""
    mesh, disc, c1, c2, xs = _corner_case(tmp_path, kind)
    for kw in ({"coeff": c1}, {"pair": (c1, c2)}):
        pair = "pair" in kw
        op = disc.stiffness_op(BF16, "cpu", corner=True, **kw)
        assert op.Q.dtype == torch.float32
        assert cc.to_g_stream(op).G.dtype == torch.float32
        wide = _widen_op(op)
        y = _corner_apply(op, xs, pair)
        assert y.dtype == BF16
        y32 = _corner_apply(wide, [x.float() for x in xs], pair)
        assert y32.dtype == torch.float32
        assert torch.equal(y, y32.to(BF16))
        # the trap: G rounded to bf16 before the apply is another operator
        g16 = cc.to_g_stream(wide)._replace(D=op.D, C=op.C)
        g16 = g16._replace(G=g16.G.to(BF16))
        plain = ((cs.stiffness_pair_plain if pair else cs.stiffness_plain)
                 if op.box else
                 (ce.extruded_pair_plain if pair else ce.extruded_plain))
        assert not torch.equal(plain(g16, *xs[:1 + pair]), y)


@pytest.mark.parametrize("kind", ["mapped", "prismatic", "hex27"])
def test_convert_of_bf16_corner_arrays_is_bitwise(ref, tmp_path, kind):
    """A JAX bf16 corner operator's channels (`JC` of a box's
    PallasStiffnessCorner, or a pair of them for the two folded operators;
    `T` and `ce` of a PallasExtrudedCorner, hex8 and hex27) become the
    port's bf16 channels and pair coefficients bit for bit through
    `convert.corner_from_fustpu`, and equal the port's own bf16 build."""
    jnp = ref.jnp
    from fustpu.ops import pallas_extruded as pex

    mesh, disc, c1, c2, xs = _corner_case(tmp_path, kind)
    fmesh = _corner_fmesh(ref, tmp_path, kind, mesh)
    D = mesh.element.deriv_1d
    f64 = lambda a: np.asarray(a, np.float64)
    if hasattr(mesh, "nc"):
        jc = lambda c: np.asarray(ref.ps.build_corner(
            fmesh.nc, mesh.degree, D, fmesh.cell_corners_flat, jnp.bfloat16,
            coeff=c.reshape(-1)).JC)
        a1, a2 = jc(c1), jc(c2)
        assert str(a1.dtype) == "bfloat16"
        single = convert.corner_from_fustpu(a1, D=D)
        pair = convert.corner_from_fustpu((a1, a2), D=D)
        cells = lambda a: f64(a).transpose(0, 2, 3, 1).reshape(-1, 37)
        want_single, want_pair = cells(a1), cells(a1).copy()
        want_pair[:, 36] = 1.0
        want_C = np.stack([cells(a1)[:, 36], cells(a2)[:, 36]], axis=1)
        where = mesh.nc
    else:
        op = pex.build_extruded_corner(fmesh, D, jnp.bfloat16, coeff=c1)
        opp = pex.build_extruded_corner(fmesh, D, jnp.bfloat16,
                                        c1_cells=c1, c2_cells=c2)
        assert str(np.asarray(op.T).dtype) == "bfloat16"
        ns = mesh.nstacks
        single = convert.corner_from_fustpu(
            T=np.asarray(op.T), D=np.asarray(op.statics[0]), ns=ns)
        pair = convert.corner_from_fustpu(
            T=np.asarray(opp.T), D=np.asarray(opp.statics[0]),
            C=np.asarray(opp.ce), ns=ns)
        cells = lambda a: f64(a)[:, :ns].transpose(1, 2, 0).reshape(
            ns * mesh.nz, -1)
        want_single, want_pair = cells(op.T), cells(opp.T)
        n = mesh.degree + 1
        want_C = f64(opp.ce)[:, :ns, ::n].reshape(2, -1).T
        where = mesh
    got = single.to_device(BF16, "cpu", where)
    got_pair = pair.to_device(BF16, "cpu", where)
    assert got.T.dtype == BF16 and got.Q.dtype == torch.float32
    assert np.array_equal(got.T.double().numpy(), want_single)
    assert np.array_equal(got_pair.T.double().numpy(), want_pair)
    assert got_pair.C.dtype == BF16
    assert np.array_equal(got_pair.C.double().numpy(), want_C)
    own = disc.stiffness_op(BF16, "cpu", corner=True, coeff=c1)
    assert torch.equal(got.T, own.T)
    assert torch.equal(_corner_apply(got, xs, False),
                       _corner_apply(own, xs, False))


def test_bf16_corner_schedules_fit_the_card(tmp_path):
    """The bf16 layouts of the corner walk, P = 2..10, single and pair:
    box pencils (37 channels) and hex8 / hex27 stacks (37, 163), the
    channels in 2 bytes a value (74 B a cell, 326 B for hex27: neither a
    multiple of 16), everything else float32.  Every cell once, each
    chunk's span 16 B-aligned inside the channels and cut back at their
    end (the kernel reads the rest), within its stage; a stage holds cpb
    cells of bf16 channels and 16 B; beside the stages the bf16 layout is
    float32's, byte for byte (the chunk buffers, the cells' f1, f2 and the
    GLL nodes and weights stay float32: CornerGeo<float, ..., bf16>); the
    occupancy query is asked with itemsize 2 (type code 2, bfloat16)."""
    cyl = msh_io.read_msh(_cylinder(tmp_path), 2)
    colour = ce.colour_stacks(cyl.rows2d)
    asked = []

    def occupancy(P, itemsize, pair, cpb, smem):
        asked.append(itemsize)
        return 2

    for P in range(2, 11):
        n = P + 1
        for pair in (False, True):
            box = [(cs.pencil_schedule((5, 3, 7), P, b, 132, pair,
                                       occupancy=occupancy, channels=37),
                    37, 5 * 3 * 7, False) for b in (2, 4)]
            stacks = [(ce.stack_schedule(colour, cyl.rows2d, cyl.nz, P, b,
                                         132, pair, occupancy=occupancy,
                                         channels=ch), ch,
                       cyl.rows2d.shape[0] * cyl.nz, True)
                      for ch in (37, 163) for b in (2, 4)]
            for (s16, ch, ncells, ids), (s32, *_) in (
                    (box[0], box[1]), (stacks[0], stacks[1]),
                    (stacks[2], stacks[3])):
                assert cs.TYPE_CODE[2] == 2
                cell = ch * 2
                assert s16.stage_bytes == cs._round16(s16.cpb * cell + 16)
                assert (s16.stage_bytes, s16.smem) == cs.pencil_smem(
                    P, 2, s16.cpb, pair, ids=ids, channels=ch)
                assert s16.smem + cs._static_smem(P, 2) <= cs.SMEM_BLOCK
                covered = np.zeros(ncells, np.int64)
                for c0, m, *_ in s16.chunks:
                    covered[c0:c0 + m] += 1
                assert (covered == 1).all()
                start = s16.chunks[:, 0] * cell
                end = (s16.chunks[:, 0] + s16.chunks[:, 1]) * cell
                off, nbytes = s16.chunks[:, 2], s16.chunks[:, 3]
                assert (off % 16 == 0).all() and (nbytes % 16 == 0).all()
                assert (off <= start).all() and (start - off < 16).all()
                assert (off + nbytes <= ncells * cell).all()
                short = end - (off + nbytes)
                assert ((short <= 0) | ((end == ncells * cell)
                                        & (short < 16))).all()
                assert (start - off + s16.chunks[:, 1] * cell
                        <= s16.stage_bytes).all()
                # beside the stages: float32's layout at the same cpb
                st32, sm32 = cs.pencil_smem(P, 4, s16.cpb, pair, ids=ids,
                                            channels=ch)
                assert s16.smem - 2 * s16.stage_bytes == sm32 - 2 * st32
                assert (2 * n ** 3 * s16.cpb + 2 * n) * 4 <= \
                    s16.smem - 2 * s16.stage_bytes
    assert set(asked) == {2, 4}


# 10 steps of the bf16 corner model.  Against the port's bf16 G-stream
# model on the same mesh: the two differ only in their operators (the
# metric from the channels in float32, or G rounded to bf16; each apply
# within ~5e-3 of float64), BF16_STEPS_TOL, the bf16 10-step gate.
# Against the JAX package's bf16 corner model: TRAJ_TOL and DRIFT_FACTOR,
# as test_trajectory_and_drift_against_fustpu states them for its bf16
# time (its source ramp and phase quantised at each stage).
BF16_STEPS_TOL = 2e-2
CORNER_STEPS = [("linear_two_layer", "mapped"),
                ("westervelt_two_layer", "mapped"),
                ("westervelt_two_layer", "prismatic")]


@pytest.mark.parametrize("name,kind", CORNER_STEPS)
def test_corner_steps_match_g_stream_and_fustpu(ref, tmp_path, monkeypatch,
                                                name, kind):
    """10 RK4 steps of the port's bf16 corner model (pallas_corner on the
    mapped box, extruded_pallas_corner on the imported cylinder; the
    two-layer Westervelt model on the pair form) from a seeded state,
    against the port's bf16 G-stream model on the same mesh
    (BF16_STEPS_TOL) and the JAX package's bf16 corner model (its kernels
    in interpret mode; TRAJ_TOL, and the port's bf16-vs-float32 drift
    within DRIFT_FACTOR of the JAX package's)."""
    jnp = ref.jnp
    from fustpu.ops import pallas_extruded as pex

    _interpret(ref, monkeypatch)
    cls, fname, kw, mesh = _box_config(name)
    impl = "pallas_corner"
    if kind == "prismatic":
        mesh = _corner_mesh(tmp_path, kind)
        fmesh = ref.f_msh.read_msh(_cylinder(tmp_path), 3)
        zc = mesh.cell_corners_flat.mean(axis=1)[:, 2]
        mat = kw["material"]
        kw = dict(kw, material=Material(
            sound_speed=np.where(zc < 0.01, 1500.0, 1650.0),
            density=np.where(zc < 0.01, 1000.0, 1050.0),
            nonlinearity=mat.nonlinearity,
            attenuation_dB=mat.attenuation_dB),
            source_facets=mesh.boundary_facets(1),
            absorbing_facets=mesh.boundary_facets(2))
        impl = "extruded_pallas_corner"
        for f in ("stiffness_apply_extruded_pallas",
                  "stiffness_apply_extruded_pallas_pair"):
            monkeypatch.setattr(pex, f, functools.partial(
                lambda g, *a, **k: g(*a, **dict(k, interpret=True)),
                getattr(pex, f)))
    else:
        fmesh = _fmesh(ref, mesh)
    fcls = getattr(ref, fname)
    fkw = _f_kwargs(ref, kw)
    fb = fcls(fmesh, dtype=jnp.bfloat16, stiffness_impl=impl, **fkw)
    f32 = fcls(fmesh, dtype=jnp.float32, stiffness_impl=impl, **fkw)
    model = cls(mesh, dtype=BF16, device="cpu", stiffness_impl=impl, **kw)
    gstream = cls(mesh, dtype=BF16, device="cpu", **kw)
    model32 = cls(mesh, dtype=torch.float32, device="cpu",
                  stiffness_impl=impl, **kw)
    assert isinstance(model.stiffness, dz.CornerStiffness)
    assert model.stiffness.is_pair == (name == "westervelt_two_layer")
    assert not isinstance(gstream.stiffness, dz.CornerStiffness)
    dt = float(f32.cfl_dt()[0])
    u0, v0 = _initial(mesh.grid_shape)
    run = lambda m: m.solve(m.init_state(0.0, u0=u0, v0=v0), dt, 10)[0]
    out, out_g, out32 = run(model), run(gstream), run(model32)
    fo = fb.solve(fb.init_state(0.0, u0=u0, v0=v0), dt, 10)[0]
    fo32 = f32.solve(f32.init_state(0.0, u0=u0, v0=v0), dt, 10)[0]
    fu = np.asarray(fo.u).astype(np.float64)
    assert out.u.dtype == BF16 and bool(torch.isfinite(out.u).all())
    assert rel(out.u, out_g.u) <= BF16_STEPS_TOL
    assert rel(out.v, out_g.v) <= BF16_STEPS_TOL
    assert rel(out.u, fu) <= TRAJ_TOL
    drift, fdrift = rel(out.u, out32.u), rel(fu, np.asarray(fo32.u))
    assert drift <= DRIFT_FACTOR * fdrift, (drift, fdrift)


@pytest.mark.parametrize("demo,argv", [
    ("nonlinear_bowl", ["--elements", "8", "--degree", "2", "--periods",
                        "0.3", "--stiffness-impl", "pallas_corner"]),
    ("capacity", ["--cells", "6", "3", "3", "--degree", "2", "--steps",
                  "2"]),
    ("capacity_imported", ["--m", "3", "--mr", "1", "--nr-ann", "1",
                           "--nz", "4", "--degree", "2", "--steps", "2"])])
def test_corner_demos_run_bf16_on_cpu(demo, argv, capsys):
    """The capacity-mode demos end to end in bf16 on the CPU (the corner
    plain versions): the bowl demo with --stiffness-impl pallas_corner,
    the capacity box and the capacity cylinder; each builds the corner
    operator in bf16 and ends with a finite, non-zero field."""
    mod = importlib.import_module(f"fustpu_torch.demos.{demo}")
    out = mod.main(argv + ["--device", "cpu", "--dtype", "bf16"])
    model, state = out[0], out[1] if demo != "nonlinear_bowl" else None
    text = capsys.readouterr().out
    if demo == "nonlinear_bowl":
        assert "CornerStiffness" in text
        assert float(text.split("pressure at focus:")[1].split()[0]) != 0.0
        return
    assert isinstance(model.stiffness, dz.CornerStiffness)
    assert model.stiffness.T.dtype == BF16 and state.u.dtype == BF16
    assert bool(torch.isfinite(state.u).all())
    assert float(state.u.abs().max()) > 0.0


@pytest.mark.parametrize("kind", ["mapped", "hex27"])
def test_bf16_corner_wrappers_check_before_any_launch(monkeypatch, tmp_path,
                                                      kind):
    """On a card tensor a bf16 corner operator goes to its bf16 walk: the
    wrappers' checks pass and the next step is the schedule (stopped here
    before anything launches), with no path to the plain version.  bf16
    channels with float32 fields, float32 GLL nodes stored as bf16, and
    the class-launch designs (float32 / float64 only) are refused before
    the kernel library is reached."""
    from fustpu_torch import _build

    class Reached(Exception):
        pass

    def reached(*args, **kwargs):
        raise Reached

    monkeypatch.setattr(_build, "load", reached)
    monkeypatch.setattr(cc, "_card", reached)
    monkeypatch.setattr(cc, "corner_plain", reached)
    monkeypatch.setattr(cc, "corner_pair_plain", reached)
    mesh, disc, c1, c2, xs = _corner_case(tmp_path, kind)
    op = disc.stiffness_op(BF16, "cpu", corner=True, pair=(c1, c2))
    card = _on_card(op)
    x16 = [x.as_subclass(_OnCard) for x in xs]
    x32 = [x.float().as_subclass(_OnCard) for x in xs]
    box = hasattr(mesh, "nc")
    walk = (cc.corner, cc.corner_pair) if box else \
        (cc.extruded_corner, cc.extruded_corner_pair)
    classes = (cc.corner_classes, cc.corner_classes_pair) if box else \
        (cc.extruded_corner_classes, cc.extruded_corner_classes_pair)
    with pytest.raises(Reached):
        walk[0](card, x16[0])
    with pytest.raises(Reached):
        walk[1](card, *x16)
    with pytest.raises(ValueError, match="T is torch.bfloat16"):
        walk[0](card, x32[0])
    with pytest.raises(ValueError, match="Q is torch.bfloat16"):
        walk[0](_on_card(op._replace(Q=op.Q.to(BF16))), x16[0])
    with pytest.raises(ValueError, match="dtype torch.bfloat16"):
        classes[0](card, x16[0])
    with pytest.raises(ValueError, match="dtype torch.bfloat16"):
        classes[1](card, *x16)
    assert not any(cc.bf16_launches.values())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card_cases(P, tmp_path):
    """The meshes of chip_smoke's phase 16 at degree P: the perturbed box,
    the imported cylinder and the shuffled box (hex8 stacks), the curved
    hex27 prism."""
    v, c, t = shapes.cylinder_mesh(nz=4 if P <= 6 else 2, **CYL)
    path = msh_io.write_msh(str(tmp_path / f"cyl{P}"), v, c, t)
    return [build_box_mesh((4, 3, 2), P, hi=(1.0, 0.8, 1.3), perturb=0.15,
                           seed=P),
            msh_io.read_msh(path, P),
            as_extruded(from_box(build_box_mesh((3, 2, 4), P,
                                                hi=(1.0, 0.8, 1.3)),
                                 shuffle_seed=11)),
            as_extruded(shapes.hex27_lattice(
                from_box(build_box_mesh((2, 2, 3), P), shuffle_seed=11),
                shapes.curved_prism_map))]


@pytest.mark.cuda
@pytest.mark.parametrize("P", range(2, 11))
def test_bf16_corner_kernels_match_plain_on_card(P, tmp_path):
    """The bf16 forms of the corner walk (#3 on box pencils, #6c on hex8
    and hex27 stacks), single (with and without a coefficient) and pair,
    against their plain bf16 versions on the same inputs (CARD_TOL), two
    applies bitwise equal, within APPLY_TOL of the bf16 G-stream kernel on
    the same mesh (two bf16 operators, each within ~5e-3 of float64), each
    launch counted in the bf16 counter of the walk that its form runs at P
    (the lean corner walk or the first, ``cuda_corner.LEAN_CORNER_BF16``)
    and in no float32 one; each bf16
    occupancy query (type code 2) answers 0 exactly beyond the kernel's
    launch bounds (128 threads for the single-field trilinear walk at
    P <= 4, float's budget, else 256)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    from fustpu_torch import _build

    cc.reset_launches()
    rng = np.random.default_rng(P)
    keys = set()
    for mesh in _card_cases(P, tmp_path):
        disc = dz.Discretization(mesh)
        box = hasattr(mesh, "nc")
        shape = mesh.nc if box else (mesh.num_cells,)
        c1 = rng.uniform(0.5, 2.0, shape)
        c2 = rng.uniform(-1.5, -0.5, shape)
        xs = [torch.as_tensor(rng.standard_normal(mesh.grid_shape),
                              device="cuda").to(BF16) for _ in range(2)]
        gstream = ((cs.stiffness, cs.stiffness_pair) if box
                   else (ce.extruded, ce.extruded_pair))
        for kw in ({}, {"coeff": c1}, {"pair": (c1, c2)}):
            pair = "pair" in kw
            op = disc.stiffness_op(BF16, "cuda", corner=True, **kw)
            a = xs[:1 + pair]
            y = _corner_apply(op, a, pair)
            torch.cuda.synchronize()
            assert y.dtype == BF16
            plain = (cc.corner_pair_plain if pair else cc.corner_plain)(
                op, *a)
            assert rel(y.cpu(), plain.cpu()) <= CARD_TOL, (mesh, kw)
            assert torch.equal(_corner_apply(op, a, pair), y)
            g = gstream[pair](disc.stiffness_op(BF16, "cuda", **kw), *a)
            assert rel(y.cpu(), g.cpu()) <= APPLY_TOL
            keys.add(cs.bf16_key(op.kernel + ("_pair" if pair else ""),
                                 cc.lean_runs(op, pair, BF16)))
    assert {k for k, v in cc.bf16_launches.items() if v} == keys, \
        cc.bf16_launches
    assert not any(cc.launches.values()), cc.launches
    lib = _build.load()
    n = P + 1
    for name, geo, ids in ((cs.OCCUPANCY[1], 1, False),
                           (ce.OCCUPANCY[1], 1, True),
                           (ce.OCCUPANCY[2], 2, True)):
        for pair in (False, True):
            most = 128 if geo == 1 and not pair and P <= 4 else 256
            for cpb in range(1, 256 // (n * n) + 1):
                smem = cs.pencil_smem(P, 2, cpb, pair, ids=ids,
                                      channels=cs.corner_channels(geo))[1]
                if smem + cs._static_smem(P, 2) > cs.SMEM_BLOCK:
                    break
                got = getattr(lib, name)(P, cs.TYPE_CODE[2], int(pair), cpb,
                                         smem)
                assert (got == 0) == (n * n * cpb > most), (name, pair, cpb,
                                                            got)
