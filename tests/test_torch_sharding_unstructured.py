"""The port's sharded models on imported meshes (``fustpu_torch.parallel.
extruded``) on spawned gloo CPU ranks, float64, against the port's
one-rank model (1e-12) and the JAX package's ExtrudedShardedModel /
IndexedShardedModel over as many virtual CPU devices (1e-11): the imported
cylinder on the extruded kernels (G stream, corner-streamed) and a curved
hex27 prism, linear and Westervelt, uniform and two-layer (the pair form),
probes and the norm probe; a general (non-prismatic) mesh over 2 ranks and
a ragged 5, on the indexed kernel and on the staged engine; the RCB
partition equal to the JAX package's, and shared rows and DOFs bitwise
consistent across ranks.  Three bfloat16 cases (the JAX package's
``--dtype bf16``: the cylinder on the extruded kernels, the general mesh
on the indexed kernel and, two-layer Westervelt, on the staged engine)
ride in the 2-rank group, held to the port's one-rank bf16 solve and to
the JAX package's bf16 sharded models (its one-rank bf16 model where its
sharded model runs no bf16).  One spawn per rank count.
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fustpu_torch.config import Material, Source
from fustpu_torch.mesh import msh_io, shapes
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.mesh.extruded import ExtrudedHexMesh, as_extruded
from fustpu_torch.mesh.unstructured import UPointSampler, from_box
from fustpu_torch.models.linear import LinearWaveModel
from fustpu_torch.models.westervelt import WesterveltModel
from fustpu_torch.parallel import multihost
from fustpu_torch.parallel.extruded import (ExtrudedShardedModel,
                                            IndexedShardedModel,
                                            rcb_partition,
                                            shard_unstructured)
from fustpu_torch.parallel.sharding import RankGrid
from fustpu_torch.utils.io import to_host

torch.set_num_threads(1)

F64 = torch.float64
TOL = 1e-12
JAX_TOL = 1e-11
STEPS = 5
CYL = dict(radius=0.012, length=0.02, piston_radius=0.008, m=3, mr=1,
           nr_ann=1, nz=4)
CYL_POINTS = np.array([[0.0, 0.0, 0.25 * 0.02], [0.003, -0.002, 0.6 * 0.02]])
BOX_POINTS = np.array([[0.002, 0.003, 0.003], [0.004, 0.002, 0.004]])

# name: (ranks, mesh, model, material, port stiffness_impl, sharded impl)
CASES = {
    "cylinder_linear": (3, "cylinder", "linear", "uniform", "auto", "auto"),
    "cylinder_westervelt": (3, "cylinder", "westervelt", "uniform", "auto",
                            "auto"),
    "cylinder_pair": (3, "cylinder", "westervelt", "two_layer", "auto",
                      "auto"),
    "cylinder_linear_two_layer": (3, "cylinder", "linear", "two_layer",
                                  "auto", "auto"),
    "cylinder_corner": (3, "cylinder", "westervelt", "uniform",
                        "pallas_corner", "auto"),
    "cylinder_corner_pair": (3, "cylinder", "westervelt", "two_layer",
                             "pallas_corner", "auto"),
    "hex27_corner": (3, "hex27", "westervelt", "uniform", "pallas_corner",
                     "auto"),
    "general_indexed": (2, "general", "westervelt", "uniform", "auto",
                        "indexed"),
    "general_engine": (2, "general", "westervelt", "uniform", "auto",
                       "indexed_engine"),
    "general_linear_engine": (2, "general", "linear", "random", "auto",
                              "indexed_engine"),
    "ragged_indexed": (5, "general", "westervelt", "uniform", "auto",
                       "indexed"),
    "ragged_engine": (5, "general", "westervelt", "uniform", "auto",
                      "indexed_engine"),
    "ragged_pair_indexed": (5, "general", "westervelt", "random", "auto",
                            "indexed"),
    "ragged_pair_engine": (5, "general", "westervelt", "random",
                           "indexed_engine", "auto"),
    "ragged_linear_engine": (5, "general", "linear", "random", "auto",
                             "indexed_engine"),
}


# bfloat16 cases, 10 steps each, in CASES' form.  The ranks round their
# parts of a stiffness apply to bf16 before the exchange sums the shared
# entries, the one-rank apply rounds the whole sum once, so the sharded
# solve is held to the one-rank bf16 solve at BF16_TOL (the bf16 10-step
# gate), and to the JAX package's bf16 sharded model at TRAJ_TOL, at which
# tests/test_torch_bf16.py holds the one-rank bf16 model to the JAX
# package's (its bf16 time quantises the source at each stage).
BF16_CASES = {
    "bf16_cylinder_pair": (2, "cylinder", "westervelt", "two_layer", "auto",
                           "auto"),
    "bf16_general_indexed": (2, "general", "linear", "random", "auto",
                             "indexed"),
    "bf16_general_engine": (2, "general", "westervelt", "random",
                            "indexed_engine", "auto"),
}
BF16_STEPS = 10
BF16_TOL = 2e-2
TRAJ_TOL = 0.2
# The JAX package's IndexedShardedModel does not run bf16 (its scan's
# carry comes out float64, as on the CPU here); those cases are held to the
# JAX package's one-rank bf16 model instead.
JAX_ONE_RANK = {"bf16_general_indexed", "bf16_general_engine"}


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
    from fustpu.models.linear import LinearWaveModel as FLinear
    from fustpu.models.westervelt import WesterveltModel as FWest
    from fustpu.parallel import extruded as f_pext

    return SimpleNamespace(jax=jax, jnp=jnp, config=f_config, box=f_box,
                           ext=f_ext, msh=f_msh, un=f_un, FLinear=FLinear,
                           FWest=FWest, pext=f_pext)


def _meshes(ref, directory, kind):
    """(port mesh, JAX package mesh, source facets, absorbing facets,
    probe points)."""
    if kind == "cylinder":
        v, c, t = shapes.cylinder_mesh(**CYL)
        path = msh_io.write_msh(str(Path(directory) / "cyl"), v, c, t)
        mesh, fmesh = msh_io.read_msh(path, 3), ref.msh.read_msh(path, 3)
        return (mesh, fmesh, mesh.boundary_facets(1), mesh.boundary_facets(2),
                CYL_POINTS)
    if kind == "hex27":
        mesh = as_extruded(shapes.hex27_lattice(
            from_box(build_box_mesh((2, 2, 3), 3), shuffle_seed=11),
            shapes.curved_prism_map))
        fmesh = ref.ext.as_extruded(shapes.hex27_lattice(
            ref.un.from_box(ref.box.build_box_mesh((2, 2, 3), 3),
                            shuffle_seed=11), shapes.curved_prism_map))
        pts = mesh.node_coords.reshape(-1, 3)[[7, mesh.ndofs // 2]]
    else:
        mesh = from_box(build_box_mesh((4, 3, 3), 3, perturb=0.15, seed=4,
                                       hi=(0.006,) * 3), shuffle_seed=9)
        fmesh = ref.un.from_box(ref.box.build_box_mesh(
            (4, 3, 3), 3, perturb=0.15, seed=4, hi=(0.006,) * 3),
            shuffle_seed=9)
        assert as_extruded(mesh) is None
        pts = BOX_POINTS
    ext = mesh.boundary_facets()
    xmin = mesh.facet_centroids(ext)[:, 0].min()
    cen = mesh.facet_centroids(ext)[:, 0]
    return mesh, fmesh, ext[cen < xmin + 1e-9], ext[cen >= xmin + 1e-9], pts


def _material(kind, mesh, west):
    kw = dict(nonlinearity=3.5, attenuation_dB=0.3) if west else {}
    x = mesh.cell_corners_flat.mean(axis=1)
    if kind == "two_layer":
        kw.update(sound_speed=np.where(x[:, 2] < 0.01, 1500.0, 1650.0),
                  density=np.where(x[:, 2] < 0.01, 1000.0, 1050.0))
    elif kind == "random":
        rng = np.random.default_rng(3)
        kw.update(sound_speed=rng.uniform(1400, 1600, mesh.num_cells),
                  density=rng.uniform(950, 1100, mesh.num_cells))
    else:
        kw.update(sound_speed=1500.0, density=1000.0)
    return kw


def _build(ref, directory, name):
    bf16 = name in BF16_CASES
    ranks, kind, model_kind, mat, impl, simpl = (BF16_CASES if bf16 else
                                                 CASES)[name]
    mesh, fmesh, sf, af, pts = _meshes(ref, directory, kind)
    west = model_kind == "westervelt"
    kw = _material(mat, mesh, west)
    src = dict(frequency=0.5e6, amplitude=1.0e5)
    cls = WesterveltModel if west else LinearWaveModel
    model = cls(mesh, Material(**kw), Source(**src), sf, af,
                dtype=torch.bfloat16 if bf16 else F64, device="cpu",
                stiffness_impl=impl)
    fcls = ref.FWest if west else ref.FLinear
    fdtype = ref.jnp.bfloat16 if bf16 else ref.jnp.float64
    fmodel = fcls(fmesh, ref.config.Material(**kw), ref.config.Source(**src),
                  sf, af, dtype=fdtype,
                  stiffness_impl="extruded" if kind == "hex27" else "auto")
    if name in JAX_ONE_RANK:
        fsm = fmodel
    elif isinstance(fmesh, ref.ext.ExtrudedHexMesh):
        fsm = ref.pext.ExtrudedShardedModel(fmodel, num_devices=ranks)
    else:
        fsm = ref.pext.IndexedShardedModel(fmodel, num_devices=ranks,
                                           stiffness_impl="indexed")
    return model, fsm, pts, simpl


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    directory = tmp_path_factory.mktemp("msh")
    out, groups = {}, {}
    for name, (ranks, *_rest) in {**CASES, **BF16_CASES}.items():
        model, fsm, pts, simpl = _build(ref, directory, name)
        dt, _ = model.cfl_dt(0.4)
        steps = BF16_STEPS if name in BF16_CASES else STEPS
        smp = UPointSampler(model.mesh, pts)
        one, ys = model.solve(model.init_state(), dt, steps, probe=lambda s:
                              torch.as_tensor(smp.sample(to_host(s.u))))
        fout, fys = fsm.solve(fsm.init_state(), float(dt), steps,
                              probe=None if name in BF16_CASES
                              else fsm.probe_fn(pts))
        out[name] = SimpleNamespace(model=model, fsm=fsm, one=one,
                                    ys=to_host(ys), fout=fout,
                                    fys=None if fys is None
                                    else np.asarray(fys, np.float64))
        out[name].files = directory / name
        groups.setdefault(ranks, []).append((name, dict(
            model=model, steps=steps, dt=dt, impl=simpl, probe=pts,
            norms=True, dist_output=str(directory / name),
            checkpoint=str(directory / name / "ck"))))
    for ranks, cases in groups.items():
        res = multihost.spawn(multihost.solve_cases, ranks, "gloo", "cpu",
                              timeout=300, args=([c for _, c in cases],))
        for i, (name, _) in enumerate(cases):
            out[name].sharded = res[0][i]
            out[name].ranks = [r[i] for r in res]
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_one_rank(runs, name):
    r = runs[name]
    s = r.sharded
    assert rel(s["u"], r.one.u.reshape(-1)) <= TOL
    assert rel(s["v"], r.one.v.reshape(-1)) <= TOL
    npts = r.ys.shape[1]
    assert rel(s["ys"][:, :npts], r.ys) <= TOL
    # the norm probe's last value is the final field's norm
    norm = float(np.linalg.norm(r.one.u))
    assert abs(s["ys"][-1, npts] - norm) <= JAX_TOL * norm
    assert abs(s["norm"] - norm) <= TOL * norm


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_bf16_sharded_matches_one_rank(runs, name):
    """A bf16 model on 2 ranks of an imported mesh (the extruded and the
    indexed sharding, the latter on the indexed kernel and on the staged
    engine, all through `host_vectors` and `collect`) against the port's
    one-rank bf16 solve: finite, within BF16_TOL (see BF16_CASES), the
    shared entries consistent, the probe traces within BF16_TOL, the
    stiffness module the float64 cases' on that mesh and route."""
    r = runs[name]
    s = r.sharded
    assert r.one.u.dtype == torch.bfloat16 and np.isfinite(s["u"]).all()
    assert rel(s["u"], to_host(r.one.u).reshape(-1)) <= BF16_TOL
    assert rel(s["v"], to_host(r.one.v).reshape(-1)) <= BF16_TOL
    npts = r.ys.shape[1]
    assert rel(s["ys"][:, :npts], r.ys) <= BF16_TOL
    assert s["u_consistent"] and s["v_consistent"] and s["kv_consistent"]
    want = ("ExtrudedStiffness" if BF16_CASES[name][1] == "cylinder"
            else "EngineStiffness" if "indexed_engine" in BF16_CASES[name]
            else "IndexedStiffness")
    assert all(rk["stiffness"] == want for rk in r.ranks)


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_bf16_sharded_matches_fustpu_sharded(runs, name):
    """The same runs' u against the JAX package's bf16
    ExtrudedShardedModel on 2 virtual devices, or its one-rank bf16 model
    (JAX_ONE_RANK), at TRAJ_TOL (see BF16_CASES).  (The probe traces are
    not compared: from rest the field is the source's alone, which the JAX
    package's bf16 time quantises.)"""
    r = runs[name]
    s = r.sharded
    fu = (r.fout.u if name in JAX_ONE_RANK else r.fsm.collect(r.fout.u))
    assert str(np.asarray(fu).dtype) == "bfloat16"
    assert rel(s["u"], np.asarray(fu, np.float64).reshape(-1)) <= TRAJ_TOL


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_fustpu_sharded(runs, name):
    r = runs[name]
    s = r.sharded
    assert rel(s["u"], r.fsm.collect(r.fout.u)) <= JAX_TOL
    assert rel(s["v"], r.fsm.collect(r.fout.v)) <= JAX_TOL
    assert rel(s["ys"][:, :r.fys.shape[1]], r.fys) <= JAX_TOL


@pytest.mark.parametrize("name", list(CASES))
def test_shared_entries_are_consistent(runs, name):
    r = runs[name]
    s = r.sharded
    assert s["u_consistent"] and s["v_consistent"] and s["kv_consistent"]
    simpl = CASES[name][5]
    engine = simpl == "indexed_engine" or CASES[name][4] == "indexed_engine"
    want = ("EngineStiffness" if engine else "CornerStiffness"
            if CASES[name][4] == "pallas_corner" else "ExtrudedStiffness"
            if CASES[name][1] != "general" else "IndexedStiffness")
    assert all(rk["stiffness"] == want for rk in r.ranks)


@pytest.mark.parametrize("name", ["cylinder_westervelt", "ragged_indexed"])
def test_partition_matches_fustpu(runs, name):
    """The RCB partition and each rank's rows or DOFs are the JAX
    package's, bit for bit, and a rank's part is built without a process
    group."""
    r = runs[name]
    k = CASES[name][0]
    cls = (ExtrudedShardedModel if isinstance(r.model.mesh, ExtrudedHexMesh)
           else IndexedShardedModel)
    for rank in range(k):
        sm = cls(r.model, RankGrid(shape=(k, 1, 1), rank=rank, device="cpu"))
        ids, mask = ((r.fsm.rowsg, r.fsm.rowmask) if cls is
                     ExtrudedShardedModel else (r.fsm.gids, r.fsm.gmask))
        assert np.array_equal(sm.ids[rank], ids[rank][mask[rank]])
        assert sm.num_shared == r.fsm.num_shared > 0
    pts = np.random.default_rng(0).random((50, 2))
    from fustpu.parallel.extruded import rcb_partition as f_rcb

    for k in (2, 3, 5, 8):
        assert np.array_equal(rcb_partition(pts, k), f_rcb(pts, k))


@pytest.mark.parametrize("name", list(CASES))
def test_rank_files_match_collect(runs, name):
    """The ranks' per-rank snapshots (rows or dofs layouts) reassemble
    bitwise into the field `collect()` gathers; rank 0's checkpoint holds
    the collected state."""
    from fustpu_torch.utils import dist_io
    from fustpu_torch.utils import io as fio

    r = runs[name]
    s = r.sharded
    got = dist_io.assemble_snapshot(str(r.files), f"u_{STEPS:06d}")
    assert np.array_equal(got, s["u"].reshape(-1))
    arrays, step, _ = fio.load_checkpoint(str(r.files / f"ck_{STEPS}.npz"))
    assert step == STEPS and np.array_equal(arrays["u"], s["u"])
    assert np.array_equal(arrays["kv"], s["kv"])


def test_routing_of_imported_meshes(runs):
    """shard_unstructured: an extruded mesh on its extruded kernels, the
    indexed sharding for a general mesh or where the engine or the indexed
    kernel is asked for; an unknown impl raises."""
    grid = RankGrid(shape=(2, 1, 1), rank=0, device="cpu")
    cyl = runs["cylinder_westervelt"].model
    gen = runs["general_indexed"].model
    assert isinstance(shard_unstructured(cyl, grid), ExtrudedShardedModel)
    sm = shard_unstructured(cyl, grid, stiffness_impl="indexed_engine")
    assert isinstance(sm, IndexedShardedModel) and sm.engine
    assert isinstance(shard_unstructured(gen, grid), IndexedShardedModel)
    with pytest.raises(ValueError, match="stiffness_impl"):
        IndexedShardedModel(gen, grid, stiffness_impl="mm")
    with pytest.raises(TypeError):
        ExtrudedShardedModel(gen, grid)


def test_bowl_demo_over_ranks_matches_one_rank():
    """`nonlinear_bowl --ranks 2` on the small bodyfit bowl (the staged
    engine per rank, gloo CPU ranks) reads the one-rank run's focal
    pressure."""
    from fustpu_torch.demos import nonlinear_bowl

    argv = ["--elements", "16", "--degree", "2", "--geometry", "bodyfit",
            "--device", "cpu", "--dtype", "f64", "--periods", "0.05",
            "--progress-every", "100", "--stiffness-impl", "indexed_engine"]
    _, _, p1 = nonlinear_bowl.main(argv)
    _, res, p2 = nonlinear_bowl.main(argv + ["--ranks", "2"])
    assert len(res) == 2 and p1 != 0.0
    assert abs(p2 - p1) <= 1e-11 * abs(p1)
