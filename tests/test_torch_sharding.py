"""The port's sharded box models (``fustpu_torch.parallel``) on spawned gloo
CPU ranks, float64, against the port's one-rank model (1e-12) and the JAX
package's ShardedModel on the same grid of its virtual CPU devices
(1e-11): grids (2, 1, 1), (2, 2, 1) and (1, 2, 2), linear and Westervelt,
uniform, heterogeneous (the folded coefficient and the pair kernel), a
cell count that no grid divides, the corner-streamed mode, probes,
distributed norms, a start from the JAX package's mid-run state, and the
shared planes bitwise consistent across ranks; and one case without the
exchange (`exchange=False`), which must differ.  Two bfloat16 cases (the
JAX package's ``--dtype bf16``; G stream and corner mode) ride in the
2-rank group, held to the port's one-rank bf16 solve and to the JAX
package's bf16 ShardedModel.
The ranks of one rank count run all their cases in one process group
(one spawn per count).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fustpu_torch import convert
from fustpu_torch.config import Material, Source
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.models.linear import LinearWaveModel
from fustpu_torch.models.westervelt import WesterveltModel
from fustpu_torch.parallel import multihost
from fustpu_torch.parallel import sharding as sh
from fustpu_torch.utils.io import to_host

torch.set_num_threads(1)

F64 = torch.float64
TOL = 1e-12           # the JAX package's own sharded-vs-single gate
JAX_TOL = 1e-11       # against the JAX package's sharded model
L = 0.006
STEPS = 6
NO_EXCHANGE = "westervelt_2x1x1 without the exchange"
POINTS = np.array([[0.31 * L, 0.52 * L, 0.5 * L],
                   [0.87 * L, 0.13 * L, 0.77 * L]])

# name: (ranks, model, nc, degree, material, grid, corner)
CASES = {
    "linear_2x1x1": (2, "linear", (4, 2, 2), 3, "uniform", (2, 1, 1), False),
    "westervelt_2x1x1": (2, "westervelt", (4, 2, 2), 3, "uniform", (2, 1, 1),
                         False),
    "midrun_2x1x1": (2, "westervelt", (4, 2, 2), 3, "uniform", (2, 1, 1),
                     False),
    "linear_2x2x1": (4, "linear", (4, 4, 2), 3, "uniform", (2, 2, 1), False),
    "westervelt_2x2x1": (4, "westervelt", (4, 4, 2), 3, "uniform", (2, 2, 1),
                         False),
    "linear_1x2x2": (4, "linear", (2, 4, 4), 3, "uniform", (1, 2, 2), False),
    "westervelt_1x2x2": (4, "westervelt", (2, 4, 4), 3, "uniform", (1, 2, 2),
                         False),
    "linear_heterogeneous": (4, "linear", (4, 4, 2), 3, "random", (2, 2, 1),
                             False),
    "westervelt_pair_nondivisible": (4, "westervelt", (5, 4, 2), 3,
                                     "two_layer", (2, 2, 1), False),
    "westervelt_nondivisible": (4, "westervelt", (7, 5, 3), 2, "uniform",
                                (2, 2, 1), False),
    "corner": (4, "westervelt", (4, 4, 4), 2, "uniform", (2, 2, 1), True),
    "corner_heterogeneous": (4, "westervelt", (4, 4, 4), 2, "two_layer",
                             (2, 2, 1), True),
    "corner_nondivisible": (4, "linear", (7, 5, 3), 2, "uniform", (2, 2, 1),
                            True),
}


# bfloat16 cases, 10 steps each: name -> (CASES' tuple, its JAX twin's
# name).  Each rank rounds its part of a stiffness apply to bf16 before
# the exchange sums the shared planes, where the one-rank apply rounds the
# whole sum once: the shared planes may differ in the last bit, so the
# sharded solve is held to the one-rank bf16 solve at BF16_TOL (the bf16
# 10-step gate), not bitwise.  Against the JAX package's bf16 sharded
# model: TRAJ_TOL of tests/test_torch_bf16.py, at which that file holds
# the one-rank bf16 model to the JAX package's (its bf16 time quantises
# the source at each stage).
BF16_CASES = {
    "bf16_westervelt_2x1x1": (2, "westervelt", (4, 2, 2), 3, "two_layer",
                              (2, 1, 1), False),
    "bf16_corner_2x1x1": (2, "westervelt", (4, 4, 4), 2, "two_layer",
                          (2, 1, 1), True),
}
BF16_STEPS = 10
BF16_TOL = 2e-2
TRAJ_TOL = 0.2


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _material(kind, nc, cls):
    west = dict(nonlinearity=3.5, attenuation_dB=0.2)
    if kind == "random":
        rng = np.random.default_rng(7)
        return dict(sound_speed=1400.0 + 200.0 * rng.random(nc),
                    density=900.0 + 200.0 * rng.random(nc),
                    nonlinearity=3.0 + rng.random(nc), attenuation_dB=0.2)
    if kind == "two_layer":
        x = np.arange(nc[0])[:, None, None] >= 2
        return dict(sound_speed=np.broadcast_to(np.where(x, 1600.0, 1480.0),
                                                nc).copy(),
                    density=np.broadcast_to(np.where(x, 1060.0, 1000.0),
                                            nc).copy(), **west)
    return dict(sound_speed=1480.0, density=1000.0, **west)


def _models(name, ref=None):
    """(port one-rank CPU model, JAX model or None) of a case: float64, or
    bfloat16 for BF16_CASES."""
    bf16 = name in BF16_CASES
    _, kind, nc, degree, mat, _, corner = (BF16_CASES if bf16 else
                                           CASES)[name]
    mesh = build_box_mesh(nc, degree, hi=(L, L, L))
    kw = _material(mat, nc, kind)
    cls = WesterveltModel if kind == "westervelt" else LinearWaveModel
    model = cls(mesh, Material(**kw), Source(frequency=1.1e6, amplitude=1e5),
                mesh.boundary_facets("x-"), mesh.all_boundary_facets(),
                dtype=torch.bfloat16 if bf16 else F64, device="cpu",
                stiffness_impl="pallas_corner" if corner else "auto")
    if ref is None:
        return model, None
    fmesh = ref.box.build_box_mesh(nc, degree, hi=(L, L, L))
    fcls = ref.FWest if kind == "westervelt" else ref.FLinear
    fmodel = fcls(fmesh, ref.config.Material(**kw),
                  ref.config.Source(frequency=1.1e6, amplitude=1e5),
                  fmesh.boundary_facets("x-"), fmesh.all_boundary_facets(),
                  dtype=ref.jnp.bfloat16 if bf16 else ref.jnp.float64)
    return model, fmodel


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules; skips where JAX is missing."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from fustpu import config as f_config
    from fustpu.mesh import box as f_box
    from fustpu.models.linear import LinearWaveModel as FLinear
    from fustpu.models.westervelt import WesterveltModel as FWest
    from fustpu.parallel import sharding as f_sh
    from fustpu.parallel.models import ShardedModel as FSharded

    return SimpleNamespace(jax=jax, jnp=jnp, config=f_config, box=f_box,
                           FLinear=FLinear, FWest=FWest, sh=f_sh,
                           FSharded=FSharded)


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    """Every case: the port's sharded run on its ranks (one spawn per rank
    count; each rank also writes its snapshot of the final u, rank 0 the
    collected checkpoint), the port's one-rank run and the JAX package's
    sharded run."""
    files = tmp_path_factory.mktemp("out")
    out, groups = {}, {}
    for name, (ranks, *_, grid, _c) in {**CASES, **BF16_CASES}.items():
        model, fmodel = _models(name, ref)
        dt, _ = model.cfl_dt(0.4)
        steps = BF16_STEPS if name in BF16_CASES else STEPS
        fsm = ref.FSharded(fmodel, ref.sh.DeviceGrid.create(grid))
        case = dict(model=model, grid=grid, steps=steps, dt=dt,
                    probe=POINTS, exchange_reps=2,
                    dist_output=str(files / name),
                    checkpoint=str(files / name / "ck"))
        s0 = model.init_state()
        fs0 = fsm.init_state()
        if name.startswith("midrun"):
            fs0, _ = fsm.solve(fs0, dt, 3)
            host = convert.sharded_state_from_fustpu(fsm, fs0)
            case["state"] = host
            s0 = convert.state_from_fustpu(host, F64, "cpu")
        one, ys = model.solve(s0, dt, steps, probe=_one_rank_probe(model))
        fout, fys = fsm.solve(fs0, dt, steps, probe=fsm.probe_fn(POINTS))
        out[name] = SimpleNamespace(model=model, one=one, ys=to_host(ys),
                                    fsm=fsm, fout=fout, fys=np.asarray(fys),
                                    files=files / name)
        groups.setdefault(ranks, []).append((name, case))
    # the exchange switched off (`solve_cases`' exchange=False, the
    # time_halo demo's second case) rides in the 2-rank group
    model, _ = _models("westervelt_2x1x1")
    dt, _ = model.cfl_dt(0.4)
    out[NO_EXCHANGE] = SimpleNamespace(
        one=model.solve(model.init_state(), dt, STEPS)[0])
    groups[2].append((NO_EXCHANGE, dict(model=model, grid=(2, 1, 1),
                                        steps=STEPS, dt=dt, exchange=False)))
    for ranks, cases in groups.items():
        res = multihost.spawn(multihost.solve_cases, ranks, "gloo", "cpu",
                              timeout=300, args=([c for _, c in cases],))
        for i, (name, _) in enumerate(cases):
            out[name].sharded = res[0][i]
            out[name].launches = [r[i]["launches"] for r in res]
    return out


@pytest.mark.parametrize("name", ["westervelt_2x1x1"])
def test_without_the_exchange_the_blocks_drift_apart(runs, name):
    """The case run with exchange=False in the same group: the same blocks
    and steps as `name`, whose exchanged run equals one rank, but without
    the sum of the shared planes u differs from the one-rank run and its
    owners disagree on the shared plane."""
    r, s = runs[NO_EXCHANGE], runs[NO_EXCHANGE].sharded
    assert rel(runs[name].sharded["u"], r.one.u) <= TOL
    assert s["u"].shape == r.one.u.shape
    assert np.isfinite(s["u"]).all()
    assert rel(s["u"], r.one.u) > 1e-6
    assert not s["v_consistent"]
    assert all(not la for la in r.launches)


def _one_rank_probe(model):
    from fustpu_torch.utils.eval import PointSampler

    smp = PointSampler(model.mesh, POINTS)
    return lambda s: torch.as_tensor(smp.sample(to_host(s.u)))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_one_rank(runs, name):
    r = runs[name]
    s = r.sharded
    assert s["u"].shape == r.one.u.shape
    assert rel(s["u"], r.one.u) <= TOL
    assert rel(s["v"], r.one.v) <= TOL
    assert s["t"] == pytest.approx(r.one.t, rel=1e-15)
    assert rel(s["ys"], r.ys) <= TOL
    # no kernel launches on CPU ranks: the plain versions run there
    assert all(not la for la in r.launches)


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_bf16_sharded_matches_one_rank(runs, name):
    """A bf16 model on 2 ranks (`host_vectors`, `collect` and
    `split_state` carry bf16 through float32) against the port's one-rank
    bf16 solve: the same stiffness module (the corner-streamed one for
    the corner case), finite, within BF16_TOL (see BF16_CASES), the
    shared planes consistent, the probe trace within BF16_TOL."""
    r = runs[name]
    s = r.sharded
    assert r.one.u.dtype == torch.bfloat16
    assert s["stiffness"] == type(r.model.stiffness).__name__
    assert (s["stiffness"] == "CornerStiffness") == BF16_CASES[name][-1]
    assert s["u"].shape == r.one.u.shape and np.isfinite(s["u"]).all()
    assert rel(s["u"], to_host(r.one.u)) <= BF16_TOL
    assert rel(s["v"], to_host(r.one.v)) <= BF16_TOL
    assert rel(s["ys"], r.ys) <= BF16_TOL
    assert s["u_consistent"] and s["v_consistent"] and s["kv_consistent"]
    assert all(not la for la in r.launches)


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_bf16_sharded_matches_fustpu_sharded(runs, name):
    """The same run against the JAX package's bf16 ShardedModel on as
    many virtual devices, at TRAJ_TOL (see BF16_CASES); the port's
    sharded state resumes from that model's collected mid-run state
    (`split_state` of ml_dtypes bfloat16 arrays) bitwise."""
    r = runs[name]
    s = r.sharded
    fu = r.fsm.collect(r.fout.u)
    assert str(np.asarray(fu).dtype) == "bfloat16"
    assert rel(s["u"], np.asarray(fu, np.float64)) <= TRAJ_TOL
    from fustpu_torch.parallel.models import ShardedModel

    host = convert.sharded_state_from_fustpu(r.fsm, r.fout)
    ranks, *_, grid, _c = BF16_CASES[name]
    for rank in range(ranks):
        sm = ShardedModel(r.model, sh.RankGrid(shape=grid, rank=rank,
                                               device="cpu"))
        st = sm.split_state(host)
        assert st.u.dtype == torch.bfloat16
        assert np.array_equal(to_host(st.u),
                              sm.block(np.asarray(host[0], np.float64)))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_fustpu_sharded(runs, name):
    r = runs[name]
    s = r.sharded
    assert rel(s["u"], r.fsm.collect(r.fout.u)) <= JAX_TOL
    assert rel(s["v"], r.fsm.collect(r.fout.v)) <= JAX_TOL
    assert rel(s["ys"], r.fys) <= JAX_TOL


@pytest.mark.parametrize("name", list(CASES))
def test_shared_planes_are_consistent(runs, name):
    """After the exchange every owner holds the same bits on the shared
    planes (u, v and the last stage's kv); the per-rank blocks are the
    JAX package's shards where the grid divides the cells."""
    r = runs[name]
    s = r.sharded
    assert s["u_consistent"] and s["v_consistent"] and s["kv_consistent"]
    ranks, _, nc, degree, _, grid, _ = CASES[name]
    if all(c % g == 0 for c, g in zip(nc, grid)):
        fst = np.asarray(r.fout.u)
        blocks = sh.split_node_field(s["u"], nc, grid, degree)
        for rank, blk in enumerate(blocks):
            i, j, k = np.unravel_index(rank, grid)
            assert rel(blk, fst[i, j, k]) <= JAX_TOL


@pytest.mark.parametrize("name", ["westervelt_2x2x1", "linear_1x2x2",
                                  "corner_nondivisible"])
def test_global_norm_matches_collected(runs, name):
    """The multiplicity-weighted distributed norm equals the collected
    field's (shared planes counted once), and an exchange was timed."""
    s = runs[name].sharded
    want = float(np.linalg.norm(s["u"]))
    assert abs(s["norm"] - want) <= TOL * want
    assert s["exchange_ms"] > 0.0


@pytest.mark.parametrize("name", list(CASES))
def test_rank_files_match_collect(runs, name):
    """The ranks' per-rank snapshots of the final u reassemble bitwise
    into the field `collect()` gathers, and rank 0's checkpoint holds the
    collected state."""
    from fustpu_torch.utils import dist_io
    from fustpu_torch.utils import io as fio

    r = runs[name]
    s = r.sharded
    got = dist_io.assemble_snapshot(str(r.files), f"u_{STEPS:06d}")
    assert got.shape == s["u"].shape and np.array_equal(got, s["u"])
    arrays, step, _ = fio.load_checkpoint(str(r.files / f"ck_{STEPS}.npz"))
    assert step == STEPS and float(arrays["t"]) == s["t"]
    assert np.array_equal(arrays["u"], s["u"])
    assert np.array_equal(arrays["v"], s["v"])
    assert np.array_equal(arrays["kv"], s["kv"])


def test_split_merge_roundtrip(ref):
    """The vendored split / merge: blocks equal the JAX package's stacked
    shards on a divisible grid, and a non-divisible split merges back."""
    x = np.random.default_rng(0).standard_normal((13, 7, 7))
    blocks = sh.split_node_field(x, (4, 2, 2), (2, 2, 1), 3)
    st = ref.sh.split_node_field(x, (4, 2, 2), (2, 2, 1), 3)
    for rank, blk in enumerate(blocks):
        assert np.array_equal(blk, st[np.unravel_index(rank, (2, 2, 1))])
    assert np.array_equal(sh.merge_node_field(blocks, (4, 2, 2), (2, 2, 1),
                                              3), x)
    y = np.random.default_rng(1).standard_normal((15, 11, 7))
    blocks = sh.split_node_field(y, (7, 5, 3), (2, 2, 1), 2)
    assert [b.shape for b in blocks] == [(9, 7, 7), (9, 5, 7), (7, 7, 7),
                                         (7, 5, 7)]
    assert np.array_equal(sh.merge_node_field(blocks, (7, 5, 3), (2, 2, 1),
                                              2), y)
    c = np.arange(4 * 4 * 2).reshape(4, 4, 2)
    cb = sh.split_cell_field(c, (4, 4, 2), (2, 2, 1))
    fc = ref.sh.split_cell_field(c, (4, 4, 2), (2, 2, 1))
    for rank, blk in enumerate(cb):
        assert np.array_equal(blk, fc[np.unravel_index(rank, (2, 2, 1))]
                              .reshape(-1))
    with pytest.raises(ValueError, match="empty"):
        sh.block_cells((4, 2, 2), (3, 1, 1))


@pytest.mark.parametrize("shape,dcn_axis", [((2, 2, 1), 0), ((2, 2, 2), 1),
                                             ((4, 2, 1), 2)])
def test_rank_table_orders_as_fustpu(ref, shape, dcn_axis):
    """The ranks of one host innermost, as the JAX package's
    dcn_device_grid orders its devices (one process of virtual devices);
    each rank's block coordinates follow."""
    from fustpu.parallel.multihost import dcn_device_grid

    want = np.vectorize(lambda d: d.id)(
        dcn_device_grid(shape, dcn_axis).mesh.devices)
    table = multihost.rank_table(shape, dcn_axis)
    assert np.array_equal(table, want)
    for r in range(table.size):
        grid = sh.RankGrid(shape=shape, rank=r, device="cpu", ranks=table)
        assert table[grid.coords] == r


def test_rank_devices_and_backends():
    """No silent switch: nccl refuses CPU ranks and more ranks than cards;
    an unknown backend raises; gloo serves the CPU."""
    assert multihost.rank_device("gloo", "cpu", 1, 2) == torch.device("cpu")
    with pytest.raises(ValueError, match="gloo"):
        multihost.rank_device("nccl", "cpu", 0, 2)
    with pytest.raises(ValueError, match="backend"):
        multihost.rank_device("mpi", "cpu", 0, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.rank_device("nccl", "cuda", 0, 1)
    else:
        with pytest.raises(ValueError, match="one card per rank"):
            multihost.rank_device("nccl", "cuda", 0,
                                  torch.cuda.device_count() + 1)


def test_two_process_check_and_a_failing_rank():
    """The self-spawned 2-rank check (the `mpirun -n 2` test of the
    reference) passes, spawned ranks load neither JAX nor the JAX package,
    and a rank that raises fails the run with its traceback."""
    assert multihost.run_multiprocess_check(2, device="cpu") <= TOL
    for mods in multihost.spawn(multihost.imported_modules, 2,
                                device="cpu"):
        bad = [m for m in mods if m.split(".")[0] in ("jax", "fustpu")]
        assert not bad, bad
    with pytest.raises(RuntimeError, match=r"rank \d of 2 failed"):
        multihost.spawn(multihost.solve_cases, 2, device="cpu", args=(
            [dict(model=_models("linear_2x1x1")[0], grid=(1, 1, 1),
                  steps=1, dt=1e-9)],))


def test_spawn_defaults_to_the_card():
    """`spawn` with no device runs its ranks on the card: on a host
    without one it refuses before starting any rank."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.spawn(multihost.imported_modules, 2)


def test_sharded_box_demo_cli(tmp_path):
    """The sharded box demo on 2 gloo CPU ranks: progress from rank 0, a
    finite field and the probe; per-rank snapshots every 3 steps and rank
    0's checkpoint at the end."""
    import re
    import subprocess
    import sys
    from pathlib import Path

    cmd = [sys.executable, "-m", "fustpu_torch.demos.sharded_box",
           "--ranks", "2", "--device", "cpu", "--dtype", "f64",
           "--elements", "4", "--degree", "2", "--steps", "6",
           "--progress-every", "3", "--probe", "0.004", "0.005", "0.005",
           "--dist-output", str(tmp_path / "snaps"), "--snapshot-every", "3",
           "--checkpoint", str(tmp_path / "ck"), "--checkpoint-every", "6"]
    out = subprocess.run(cmd, cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "rank grid (2, 1, 1), 2 ranks (gloo on cpu)" in out.stdout
    assert "steps: 6/6" in out.stdout
    m = re.search(r"max \|u\| (\S+);", out.stdout)
    assert m and np.isfinite(float(m.group(1))) and float(m.group(1)) > 0
    assert "probe u at" in out.stdout
    from fustpu_torch.utils import dist_io
    from fustpu_torch.utils import io as fio

    u = fio.load_checkpoint(str(tmp_path / "ck_6.npz"))[0]["u"]
    assert np.array_equal(
        dist_io.assemble_snapshot(str(tmp_path / "snaps"), "u_000006"), u)
    assert sorted(p.name for p in (tmp_path / "snaps").glob("u_*")) == [
        f"u_00000{k}.d0000{r}.npy" for k in (3, 6) for r in (0, 1)]


def test_sharded_box_demo_cli_bf16():
    """The sharded box demo in bf16 on 2 gloo CPU ranks (the bf16 sharded
    model's vectors, exchange and collected fields): a finite, non-zero
    field and no kernel launch."""
    import re
    import subprocess
    import sys
    from pathlib import Path

    cmd = [sys.executable, "-m", "fustpu_torch.demos.sharded_box",
           "--ranks", "2", "--device", "cpu", "--dtype", "bf16",
           "--elements", "4", "--degree", "2", "--steps", "6",
           "--progress-every", "3"]
    out = subprocess.run(cmd, cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "rank grid (2, 1, 1), 2 ranks (gloo on cpu)" in out.stdout
    assert "steps: 6/6" in out.stdout
    m = re.search(r"max \|u\| (\S+);", out.stdout)
    assert m and np.isfinite(float(m.group(1))) and float(m.group(1)) > 0
    assert "launches per rank [{}, {}]" in out.stdout
