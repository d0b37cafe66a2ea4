"""The port's vendored float64 host setup equals the JAX package's, and the
port imports neither JAX nor the JAX package."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from fustpu.elements import gll as f_gll  # noqa: E402
from fustpu.mesh.box import BoxMesh as FBoxMesh  # noqa: E402
from fustpu.ops import precompute as f_pre  # noqa: E402
from fustpu.ops import spectral_mm as f_mm  # noqa: E402
from fustpu.utils import eval as f_eval  # noqa: E402

from fustpu_torch.demos.nonlinear_bowl import bowl_mapping  # noqa: E402
from fustpu_torch.elements import gll  # noqa: E402
from fustpu_torch.mesh.box import build_box_mesh, build_mapped_mesh  # noqa: E402
from fustpu_torch.ops import precompute as pre  # noqa: E402
from fustpu_torch.ops import spectral_mm as mm  # noqa: E402
from fustpu_torch.utils import eval as fev  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-14


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _meshes():
    perturbed = build_box_mesh((3, 4, 5), 3, hi=(1.0, 0.8, 1.3),
                               perturb=0.15, seed=7)
    bowl = build_mapped_mesh((16, 8, 8), 2,
                             bowl_mapping(0.035, 0.016, 0.025, 0.025, 0.08),
                             hi=(0.08, 0.05, 0.05))
    return {"perturbed": perturbed, "bowl": bowl}


def _twin(mesh):
    """The JAX package's BoxMesh on the same vertices."""
    return FBoxMesh(degree=mesh.degree, nc=mesh.nc, lo=mesh.lo, hi=mesh.hi,
                    vertex_coords=mesh.vertex_coords)


@pytest.mark.parametrize("n", [2, 3, 5, 8, 11])
def test_gll_rules_match(n):
    x, w = gll.gll_points_weights_unit(n)
    fx, fw = f_gll.gll_points_weights_unit(n)
    assert rel(x, fx) <= TOL and rel(w, fw) <= TOL
    assert rel(gll.derivative_matrix(n), f_gll.derivative_matrix(n)) <= TOL


@pytest.mark.parametrize("kind", ["perturbed", "bowl"])
def test_host_geometry_matches(kind):
    mesh = _meshes()[kind]
    fmesh = _twin(mesh)
    assert rel(mesh.node_coords, fmesh.node_coords) <= TOL
    assert rel(pre.cell_detJ(mesh), f_pre.cell_detJ(fmesh)) <= TOL
    dJ, G = pre.cell_geometry_factors(mesh)
    fdJ, fG = f_pre.cell_geometry_factors(fmesh, use_native=False)
    assert rel(dJ, fdJ) <= TOL and rel(G, fG) <= TOL
    bd = mesh.all_boundary_facets()
    assert np.array_equal(mesh.facet_dofmap(bd), fmesh.facet_dofmap(bd))
    assert rel(pre.facet_geometry_factors(mesh, bd),
               f_pre.facet_geometry_factors(fmesh, bd,
                                            use_native=False)) <= TOL
    coeff = np.random.default_rng(0).uniform(0.5, 2.0, mesh.nc)
    assert rel(mm.mass_diagonal(mesh.nc, mesh.degree, dJ, coeff),
               f_mm.mass_diagonal(mesh.nc, mesh.degree, fdJ, coeff)) <= TOL
    assert mesh.h_cfl() == fmesh.h_cfl()


def test_point_evaluation_matches():
    """The focal-pressure read: evaluate / PointSampler on the mapped bowl
    mesh (Newton + cell walk) against the JAX package's."""
    mesh = _meshes()["bowl"]
    fmesh = _twin(mesh)
    field = np.random.default_rng(1).standard_normal(mesh.grid_shape)
    pts = fev.plane_points(mesh, 2, 0.025, 9, 7)
    assert np.array_equal(pts, f_eval.plane_points(fmesh, 2, 0.025, 9, 7))
    pts = np.concatenate([pts, [[0.035, 0.025, 0.025]]])
    ref = f_eval.evaluate(fmesh, field, pts)
    assert np.isfinite(ref).sum() > 40
    got = fev.evaluate(mesh, field, pts)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    assert rel(got[ok], ref[ok]) <= TOL
    assert rel(fev.PointSampler(mesh, pts[ok]).sample(field),
               ref[ok]) <= TOL


def test_import_loads_neither_jax_nor_fustpu():
    code = ("import sys, fustpu_torch, fustpu_torch.convert, "
            "fustpu_torch.demos.nonlinear_bowl, "
            "fustpu_torch.demos.linear_piston, "
            "fustpu_torch.mesh.unstructured, fustpu_torch.mesh.extruded, "
            "fustpu_torch.mesh.msh_io, fustpu_torch.mesh.shapes, "
            "fustpu_torch.ops.extruded, fustpu_torch.ops.cuda_extruded, "
            "fustpu_torch.mesh._window_cost, fustpu_torch.ops.gather_scatter, "
            "fustpu_torch.ops.indexed, fustpu_torch.ops.cuda_indexed, "
            "fustpu_torch.ops.corner, fustpu_torch.ops.cuda_corner, "
            "fustpu_torch.demos.capacity, "
            "fustpu_torch.demos.capacity_imported; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'fustpu' "
            "or m.startswith('fustpu.')]; print(bad); sys.exit(bool(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


_FORBIDDEN = re.compile(
    r"^\s*(import jax\b|from jax\b|import fustpu\.|import fustpu\s*$|"
    r"from fustpu\s|from fustpu\.)", re.M)


def test_port_sources_never_import_jax_or_fustpu():
    files = sorted((REPO / "fustpu_torch").rglob("*.py"))
    assert files
    offenders = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
                 for p in files
                 for m in _FORBIDDEN.finditer(p.read_text())]
    assert not offenders, offenders
