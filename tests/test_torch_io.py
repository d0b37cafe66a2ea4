"""The port's file output and tools on the CPU, against the JAX package on
the same numpy inputs from a seed: the VTK files (structured and
unstructured, binary and ASCII) and point-cloud text byte for byte,
checkpoints in either direction (a JAX checkpoint resumed in the port
within 1e-11 in float64, on a box and on a prismatic import; the port's
own resume bitwise), the asynchronous `Checkpointer`, the Kronecker apply
and degree transfer (1e-12, and the JAX package's polynomial and restart
cases), per-rank snapshots reassembled bitwise as `collect()` gives them
for the box, rows and dofs layouts (each rank's part built in this
process: no rank group), the timing table, the profiler trace, and
`run_demo` with every output flag on a small box.
"""

import io
import os
import re
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from fustpu_torch.config import Material, Source
from fustpu_torch.demos import linear_box
from fustpu_torch.mesh import msh_io, shapes
from fustpu_torch.mesh.box import build_box_mesh, build_mapped_mesh
from fustpu_torch.models.linear import LinearWaveModel
from fustpu_torch.models.westervelt import WesterveltModel
from fustpu_torch.ops import kronecker as kr
from fustpu_torch.parallel import sharding as sh
from fustpu_torch.parallel.extruded import (ExtrudedShardedModel,
                                            IndexedShardedModel)
from fustpu_torch.parallel.models import ShardedModel
from fustpu_torch.utils import dist_io, timing
from fustpu_torch.utils import io as fio

torch.set_num_threads(1)

TOL = 1e-11


def rel(a, b):
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _fmesh(mesh):
    from fustpu.mesh.box import BoxMesh as FBoxMesh

    return FBoxMesh(degree=mesh.degree, nc=mesh.nc, lo=mesh.lo, hi=mesh.hi,
                    vertex_coords=mesh.vertex_coords)


def _box():
    return build_box_mesh((3, 2, 2), 3, hi=(0.006, 0.004, 0.004),
                          perturb=0.1, seed=3)


def _cyl_file(tmpdir):
    v, c, t = shapes.cylinder_mesh(0.012, 0.02, 0.008, m=3, mr=1, nr_ann=1,
                                   nz=4)
    return msh_io.write_msh(os.path.join(tmpdir, "cyl"), v, c, t)


def _fields(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"u": rng.standard_normal(n),
            "v": rng.standard_normal(n).astype(np.float32)}


# ---------------------------------------------------------------------------
# VTK and point clouds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("binary", [True, False])
def test_vtk_structured_bytes_match_fustpu(tmp_path, binary):
    from fustpu.utils import io as f_io

    mesh = _box()
    f = _fields(mesh.ndofs)
    got = fio.write_vtk_structured(
        str(tmp_path / "port"), mesh,
        {k: torch.as_tensor(v).reshape(mesh.grid_shape)
         for k, v in f.items()}, binary=binary)
    want = f_io.write_vtk_structured(str(tmp_path / "jax"), _fmesh(mesh), f,
                                     binary=binary)
    assert got.endswith(".vtk")
    assert open(got, "rb").read() == open(want, "rb").read()


@pytest.mark.parametrize("binary", [True, False])
def test_vtk_unstructured_bytes_match_fustpu(tmp_path, binary):
    from fustpu.mesh import msh_io as f_msh
    from fustpu.utils import io as f_io

    path = _cyl_file(str(tmp_path))
    mesh, fmesh = msh_io.read_msh(path, 3), f_msh.read_msh(path, 3)
    f = _fields(mesh.ndofs, 1)
    got = fio.write_vtk_unstructured(
        str(tmp_path / "port"), mesh,
        {k: torch.as_tensor(v) for k, v in f.items()}, binary=binary)
    want = f_io.write_vtk_unstructured(str(tmp_path / "jax"), fmesh, f,
                                       binary=binary)
    assert open(got, "rb").read() == open(want, "rb").read()
    # the cell rows are built once and kept on the mesh
    assert fio.vtk_cells(mesh) is fio.vtk_cells(mesh)


@pytest.mark.parametrize("mode", ["w", "a"])
def test_point_cloud_text_matches_fustpu(tmp_path, mode):
    from fustpu.utils import io as f_io

    rng = np.random.default_rng(2)
    pts, vals = rng.standard_normal((37, 3)), rng.standard_normal(37)
    for path, save, v in ((tmp_path / "p.txt", fio.save_point_cloud,
                           torch.as_tensor(vals)),
                          (tmp_path / "j.txt", f_io.save_point_cloud, vals)):
        path.write_text("head\n")
        save(str(path), pts, v, cols=(0, 1), mode=mode)
    assert (tmp_path / "p.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _models(kind, tmpdir):
    """(port model, JAX model, seeded (u0, v0)) on the same problem, both
    float64: a two-layer linear model on a perturbed box, or a two-layer
    Westervelt model on an imported cylinder (the extruded operator)."""
    import jax.numpy as jnp
    from fustpu import config as f_config

    if kind == "box":
        from fustpu.models.linear import LinearWaveModel as FLinear

        mesh = build_box_mesh((4, 3, 3), 3, hi=(0.006,) * 3, perturb=0.1,
                              seed=3)
        cs = np.full(mesh.nc, 1500.0)
        cs[2:] = 1590.0
        props = dict(sound_speed=cs, density=1000.0)
        args = (mesh.boundary_facets("x-"), mesh.boundary_facets("x+"))
        src = dict(frequency=0.5e6, amplitude=60000.0)
        fmesh, cls, fcls = _fmesh(mesh), LinearWaveModel, FLinear
    else:
        from fustpu.mesh import msh_io as f_msh
        from fustpu.models.westervelt import WesterveltModel as FWest

        path = _cyl_file(tmpdir)
        mesh, fmesh = msh_io.read_msh(path, 3), f_msh.read_msh(path, 3)
        zc = mesh.cell_corners_flat.mean(axis=1)[:, 2]
        props = dict(sound_speed=np.where(zc < 0.01, 1500.0, 1650.0),
                     density=np.where(zc < 0.01, 1000.0, 1050.0),
                     nonlinearity=100.0, attenuation_dB=50.0)
        args = (mesh.boundary_facets(1), mesh.boundary_facets(2))
        src = dict(frequency=0.5e6, amplitude=1e5)
        cls, fcls = WesterveltModel, FWest
    model = cls(mesh, Material(**props), Source(**src), *args,
                dtype=torch.float64, device="cpu")
    fmodel = fcls(fmesh, f_config.Material(**props), f_config.Source(**src),
                  *args, dtype=jnp.float64)
    rng = np.random.default_rng(4)
    u0, v0 = (rng.standard_normal(mesh.grid_shape) for _ in range(2))
    return model, fmodel, u0, v0


@pytest.mark.parametrize("kind", ["box", "prismatic"])
def test_fustpu_checkpoint_resumes_in_the_port(tmp_path, kind):
    """A checkpoint the JAX package writes after 5 steps, resumed by the
    port for 5 more, against the JAX package's own continuation."""
    from fustpu.utils import io as f_io

    model, fmodel, u0, v0 = _models(kind, str(tmp_path))
    dt, _ = fmodel.cfl_dt()
    f5, _ = fmodel.solve(fmodel.init_state(0.0, u0=u0, v0=v0), dt, 5)
    path = f_io.save_checkpoint(str(tmp_path / "jax"), f5, 5, {"k": kind})
    f10, _ = fmodel.solve(f5, dt, 5)
    arrays, step, meta = fio.load_checkpoint(path)
    assert (step, meta) == (5, {"k": kind})
    state = fio.state_from_checkpoint(model, arrays)
    assert state.u.shape == model.init_state().u.shape
    assert state.u.dtype == torch.float64 and state.t == float(f5.t)
    out, _ = model.solve(state, dt, 5)
    assert rel(out.u, f10.u) <= TOL and rel(out.v, f10.v) <= TOL
    assert out.t == pytest.approx(float(f10.t), rel=1e-15)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_port_checkpoint_resume_is_bitwise(tmp_path, dtype):
    """10 steps straight against 5, save, load and 5 more: bitwise; the
    file holds what the JAX package's loader reads."""
    from fustpu.utils import io as f_io

    model, _, u0, v0 = _models("box", str(tmp_path))
    model = model.to(dtype)
    model.dtype = dtype
    dt, _ = model.cfl_dt()
    s0 = model.init_state(0.0, u0=u0, v0=v0)
    straight, _ = model.solve(s0, dt, 10)
    s5, _ = model.solve(s0, dt, 5)
    path = fio.save_checkpoint(str(tmp_path / "c"), s5, 5)
    assert not os.path.exists(path + ".tmp.npz")
    arrays, step, _ = fio.load_checkpoint(path)
    resumed, _ = model.solve(fio.state_from_checkpoint(model, arrays), dt, 5)
    assert step == 5 and resumed.t == straight.t
    for a, b in zip(resumed[:4], straight[:4]):
        assert torch.equal(a, b)
    farr, fstep, fmeta = f_io.load_checkpoint(path)
    assert fstep == 5 and fmeta == {} and farr["t"].shape == ()
    assert np.array_equal(farr["u"], s5.u.numpy())


@pytest.mark.parametrize("async_save", [True, False])
def test_checkpointer_round_trip(tmp_path, async_save):
    """Saves during a run restore bitwise; `steps()` lists completed saves
    only (an unfinished save's temporary file is not one)."""
    model, _, u0, v0 = _models("box", str(tmp_path))
    dt, _ = model.cfl_dt()
    ck = fio.Checkpointer(str(tmp_path / "ck"), async_save=async_save)
    s = model.init_state(0.0, u0=u0, v0=v0)
    for step in (3, 6):
        s, _ = model.solve(s, dt, 3)
        ck.save(s, step)
    straight, _ = model.solve(s, dt, 4)
    (tmp_path / "ck" / ".step_0000000009.pt.tmp").write_bytes(b"partial")
    ck.wait()
    assert ck.steps() == [3, 6]
    st, step = ck.restore()
    assert step == 6 and st.u.device.type == "cpu"
    st, step = ck.restore(6, like=s)
    resumed, _ = model.solve(st, dt, 4)
    assert all(torch.equal(a, b) for a, b in zip(resumed[:4], straight[:4]))
    assert resumed.t == straight.t


# ---------------------------------------------------------------------------
# Kronecker apply and degree transfer
# ---------------------------------------------------------------------------

def test_kron_apply_matches_fustpu_and_dense():
    from fustpu.ops.kronecker import kron_apply as f_kron

    rng = np.random.default_rng(0)
    A0, A1, A2 = (rng.standard_normal((m, n))
                  for m, n in ((4, 3), (2, 5), (6, 4)))
    x = rng.standard_normal((7, 3, 5, 4))
    got = kr.kron_apply(A0, A1, A2, x)
    want = (x.reshape(7, -1) @ np.kron(A0, np.kron(A1, A2)).T).reshape(
        7, 4, 2, 6)
    assert isinstance(got, np.ndarray)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    assert np.abs(got - f_kron(A0, A1, A2, x)).max() <= \
        1e-12 * np.abs(want).max()
    t = kr.kron_apply(A0, A1, A2, torch.as_tensor(x))
    assert isinstance(t, torch.Tensor) and np.array_equal(t.numpy(), got)


def _mapped(P):
    from fustpu_torch.demos.nonlinear_bowl import bowl_mapping

    return build_mapped_mesh((4, 3, 3), P,
                             bowl_mapping(0.035, 0.016, 0.025, 0.025, 0.08),
                             hi=(0.08, 0.05, 0.05))


@pytest.mark.parametrize("p_from,p_to", [(4, 6), (6, 4), (3, 3)])
def test_interpolate_box_field_matches_fustpu(p_from, p_to):
    """On a mapped box: within 1e-12 of the JAX package's transfer, the
    array and the tensor inputs alike."""
    from fustpu.ops.kronecker import interpolate_box_field as f_interp

    m1, m2 = _mapped(p_from), _mapped(p_to)
    f = np.random.default_rng(5).standard_normal(m1.grid_shape)
    want = f_interp(f, _fmesh(m1), _fmesh(m2))
    got = kr.interpolate_box_field(f, m1, m2)
    assert got.shape == m2.grid_shape
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    t = kr.interpolate_box_field(torch.as_tensor(f), m1, m2)
    assert np.array_equal(t.numpy(), got)


def test_degree_transfer_polynomial_exact():
    """Exact for per-axis polynomials up to the source degree: up, down,
    and the round trip P4 -> P6 -> P4, on an affine box."""
    nc = (3, 2, 2)
    m4 = build_box_mesh(nc, 4, hi=(1.0, 0.8, 0.6))
    m6 = build_box_mesh(nc, 6, hi=(1.0, 0.8, 0.6))

    def poly(m, d):
        x = m.node_coords.reshape(-1, 3)
        return (x[:, 0] ** d - 2.0 * x[:, 1] ** (d - 1) * x[:, 2]
                + 0.3 * x[:, 2] ** 2).reshape(m.grid_shape)

    up = kr.interpolate_box_field(poly(m4, 4), m4, m6)
    assert np.allclose(up, poly(m6, 4), atol=1e-11)
    down = kr.interpolate_box_field(poly(m6, 4), m6, m4)
    assert np.allclose(down, poly(m4, 4), atol=1e-11)
    back = kr.interpolate_box_field(up, m6, m4)
    assert np.allclose(back, poly(m4, 4), atol=1e-11)


def test_degree_transfer_refuses_other_cells():
    m4 = build_box_mesh((3, 2, 2), 4, hi=(1.0, 0.8, 0.6))
    with pytest.raises(ValueError, match="cell grids"):
        kr.interpolate_box_field(np.zeros(m4.grid_shape), m4,
                                 build_box_mesh((3, 2, 1), 6,
                                                hi=(1.0, 0.8, 0.6)))
    with pytest.raises(ValueError, match="geometry"):
        kr.interpolate_box_field(np.zeros(m4.grid_shape), m4,
                                 build_box_mesh((3, 2, 2), 6,
                                                hi=(1.0, 0.8, 0.7)))


def test_degree_transfer_restart_upgrade():
    """A P=4 state restarted at P=6 with the P=6 model's own dt: the probe
    stays within 5% of the field's scale of the all-P4 run (the JAX
    package's restart case)."""
    from fustpu_torch.utils.eval import PointSampler

    nc, hi = (6, 3, 3), (0.012, 0.006, 0.006)
    mat = Material(sound_speed=1500.0, density=1000.0)
    src = Source(frequency=0.5e6, amplitude=1e5)

    def model(P):
        m = build_box_mesh(nc, P, hi=hi)
        return m, LinearWaveModel(m, mat, src, m.boundary_facets("x-"),
                                  m.all_boundary_facets(),
                                  dtype=torch.float64, device="cpu")

    m4, mod4 = model(4)
    dt4, _ = mod4.cfl_dt(0.3)
    s4, _ = mod4.solve(mod4.init_state(), dt4, 60)
    m6, mod6 = model(6)
    dt6, _ = mod6.cfl_dt(0.3)
    n6 = int(round(40 * dt4 / dt6))
    s6 = mod6.init_state(t0=s4.t,
                         u0=kr.interpolate_box_field(s4.u, m4, m6),
                         v0=kr.interpolate_box_field(s4.v, m4, m6))
    s4b, _ = mod4.solve(s4, dt4, 40)
    s6b, _ = mod6.solve(s6, dt6, n6)
    pts = np.array([[0.006, 0.003, 0.003]])
    a = PointSampler(m4, pts).sample(s4b.u.numpy())
    b = PointSampler(m6, pts).sample(s6b.u.numpy())
    scale = float(s4b.u.abs().max())
    assert abs(a[0] - b[0]) < 0.05 * scale, (a, b, scale)


# ---------------------------------------------------------------------------
# Per-rank snapshots
# ---------------------------------------------------------------------------

def _parts(kind, tmpdir):
    """(each rank's sharded model, built in this process, global host
    field shape)."""
    mat = Material(sound_speed=1480.0, density=1000.0, nonlinearity=3.5,
                   attenuation_dB=0.2)
    src = Source(frequency=1.1e6, amplitude=1.0e5)
    if kind == "box":
        mesh = build_box_mesh((6, 4, 3), 2, hi=(0.006, 0.004, 0.003))
        S = (2, 2, 1)
    else:
        mesh = msh_io.read_msh(_cyl_file(tmpdir), 2,
                               detect_extrusion=kind == "rows")
        S = (3, 1, 1)
    facets = (mesh.boundary_facets("x-") if kind == "box"
              else mesh.boundary_facets(1))
    model = WesterveltModel(mesh, mat, src, facets, None,
                            dtype=torch.float64, device="cpu")
    cls = {"box": ShardedModel, "rows": ExtrudedShardedModel,
           "dofs": IndexedShardedModel}[kind]
    parts = [cls(model, sh.RankGrid(S, r, "cpu"))
             for r in range(int(np.prod(S)))]
    return parts, mesh.grid_shape


@pytest.mark.parametrize("kind", ["box", "rows", "dofs"])
def test_assemble_snapshot_equals_collect(tmp_path, kind):
    """Every rank writes its block of a field; the reassembled field is
    bitwise what `collect()` merges from the ranks' blocks (and the
    field itself)."""
    parts, shape = _parts(kind, str(tmp_path))
    field = np.random.default_rng(6).standard_normal(shape)
    blocks = [p.block(field) for p in parts]
    for p, b in zip(parts, blocks):
        w = dist_io.ShardSnapshotWriter(str(tmp_path / "snap"), p)
        w.write("u_000010", torch.as_tensor(b))
    got = dist_io.assemble_snapshot(str(tmp_path / "snap"), "u_000010")
    collected = parts[0]._merge(blocks)
    assert got.shape == collected.shape and np.array_equal(got, collected)
    assert np.array_equal(got.reshape(-1), field.reshape(-1))
    os.remove(tmp_path / "snap" / "u_000010.d00001.npy")
    with pytest.raises(FileNotFoundError, match="ranks \\[1\\]"):
        dist_io.assemble_snapshot(str(tmp_path / "snap"), "u_000010")


def test_state_from_checkpoint_gives_each_rank_its_block(tmp_path):
    """A global checkpoint restarts a sharded run: each rank's state is
    its block of every field, in the model's dtype, at the file's t."""
    parts, shape = _parts("box", str(tmp_path))
    rng = np.random.default_rng(7)
    fields = [rng.standard_normal(shape) for _ in range(4)]
    path = fio.save_checkpoint(str(tmp_path / "g"), (*fields, 2.5e-6), 40)
    arrays, step, _ = fio.load_checkpoint(path)
    for p in parts:
        st = fio.state_from_checkpoint(p, arrays)
        assert step == 40 and st.t == 2.5e-6
        for got, f in zip(st[:4], fields):
            assert got.dtype == torch.float64
            assert np.array_equal(got.numpy(), p.block(f))


# ---------------------------------------------------------------------------
# Timings, the profiler, the demo runner
# ---------------------------------------------------------------------------

def test_timing_table_matches_fustpu_format():
    from fustpu.utils import timing as f_timing

    times = {"~ solve chunk": [0.5, 0.25, 0.125], "setup": [1.0 / 3.0],
             "a much longer section name than the others": [2.0]}
    timing.reset_timings()
    f_timing.reset_timings()
    for name, ts in times.items():
        for t in ts:
            s = timing.Scope()
            s._seconds = t
            timing._records[name].append(s)
            f_timing._records[name].append(t)
    got, want = [], []
    timing.list_timings(got.append)
    f_timing.list_timings(want.append)
    assert got == want and len(got) == 4
    assert timing.get_timings() == f_timing.get_timings()
    timing.reset_timings()
    f_timing.reset_timings()
    with timing.timer("host") as sc:
        sum(range(1000))
    assert not sc.cuda and timing.get_timings()["host"] == [sc.seconds]
    timing.reset_timings()


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with timing.profile_trace(str(tmp_path / "tr")):
        with timing.annotate("my_scope"):
            torch.ones(64).sum()
    text = (tmp_path / "tr" / "trace.json").read_text()
    assert "traceEvents" in text and "my_scope" in text


def test_run_demo_writes_every_output_at_its_cadence(tmp_path):
    """The linear box demo with every output flag: chunks of the gcd of
    the cadences, checkpoints and plane snapshots at their steps and no
    others, the probe trace (one row a step), the final VTK file of the
    final state, the timing table; a checkpoint resumes to the final
    state bitwise."""
    pre = str(tmp_path / "o")
    argv = ["--device", "cpu", "--dtype", "f64", "--elements", "3",
            "--degree", "2", "--periods", "0.3", "--progress-every", "10",
            "--output", pre, "--checkpoint", str(tmp_path / "ck"),
            "--checkpoint-every", "6", "--snapshot-every", "4",
            "--probe", "0.01", "0.015", "0.015",
            "--probe", "0.02", "0.01", "0.01"]
    timing.reset_timings()
    buf = io.StringIO()
    with redirect_stdout(buf):
        model, state = linear_box.main(argv)
    out = buf.getvalue()
    n = int(re.search(r"Number of steps: (\d+)", out).group(1))
    assert n == 21
    ck = sorted(int(p.stem.split("_")[1]) for p in tmp_path.glob("ck_*.npz"))
    assert ck == [6, 12, 18]
    snaps = sorted(int(p.stem.rsplit("_", 1)[1])
                   for p in tmp_path.glob("o_linear_box_snap_*.txt"))
    assert snaps == [4, 8, 12, 16, 20]
    assert len(np.loadtxt(tmp_path / "o_linear_box_snap_4.txt",
                          delimiter=",")) == 179 * 179
    trace = np.loadtxt(tmp_path / "o_linear_box_probe.txt", delimiter=",")
    assert trace.shape == (n, 3) and trace[-1, 0] == pytest.approx(state.t)
    vtk = tmp_path / "o_linear_box.vtk"
    ref = fio.write_vtk_structured(str(tmp_path / "ref"), model.mesh,
                                   {"u": state.u, "v": state.v})
    assert vtk.read_bytes() == open(ref, "rb").read()
    # progress at 10, 20 and the end; chunks of gcd(10, 6, 4) = 2 steps
    assert sum(ln.startswith("t: ") for ln in out.splitlines()) == 3
    table = out[out.index("section"):]
    assert re.search(r"~ solve chunk\s+11\s", table)
    assert re.search(r"~ checkpoint\s+3\s", table)
    arrays, step, _ = fio.load_checkpoint(str(tmp_path / "ck_12.npz"))
    dt, _ = model.cfl_dt(0.65)          # the demo's CFL
    done = fio.state_from_checkpoint(model, arrays)
    while step < n:                     # the demo's chunks of 2 steps
        k = min(2, n - step)
        done, _ = model.solve(done, dt, k, tf=n * dt)
        step += k
    assert torch.equal(done.u, state.u) and torch.equal(done.v, state.v)
    timing.reset_timings()
