"""The port's XDMF mesh import (`fustpu_torch.mesh.xdmf_io`) against the
JAX package's on the CPU: DOLFINx-layout XDMF files written by hand here,
inline XML and XDMF + HDF5 (the HDF cases need h5py), their parse, the
.msh file they convert to, a model on the mesh they import, and
`write_xdmf`, whose files read back to the same mesh as the .msh import.

DOLFINx writes XDMF hex topology in VTK's corner order, which is Gmsh's;
the fixtures here are written so.  The JAX package's reader permutes those
rows as if they were lexicographic (`_HEX_DOLFINX_TO_GMSH`) and hands the
result to a writer that expects its own 4a+2b+c order, so its cells are
the port's relabelled: `test_parse_xdmf_matches_fustpu` holds the two
parses to exactly that relation, and the .msh file and the model are held
to the JAX package's own `.msh` writer and model of the mesh the fixture
was written from.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from fustpu_torch.config import Material, Source
from fustpu_torch.demos.nonlinear_bowl import bowl_mapping, bowl_tags
from fustpu_torch.mesh import msh_io, shapes, xdmf_io
from fustpu_torch.mesh.box import build_mapped_mesh
from fustpu_torch.mesh.extruded import ExtrudedHexMesh
from fustpu_torch.models.westervelt import WesterveltModel

torch.set_num_threads(1)

TOL = 1e-11
STEPS = 10
# the JAX package's row permutation of XDMF hexes
_F_PERM = [0, 1, 3, 2, 4, 5, 7, 6]


def _cylinder():
    v, c, t = shapes.cylinder_mesh(0.012, 0.02, 0.008, m=3, mr=1, nr_ann=1,
                                   nz=4)
    return np.asarray(v, np.float64), np.asarray(c, np.int64), t


def _fixture(tmp_path, v, c, t, fmt, inline_tags=True):
    """A DOLFINx-layout XDMF file (hex grid 'planar_3d_0' in VTK corner
    order, quad meshtags grid), inline or with an HDF5 file."""
    topo = c[:, xdmf_io._GMSH_HEX]
    q = np.array([list(qq) for _, qq in t], np.int64)
    vals = np.array([tag for tag, _ in t], np.int64)
    if fmt == "HDF":
        h5py = pytest.importorskip("h5py")
        with h5py.File(tmp_path / "mesh.h5", "w") as f:
            f["/Mesh/mesh/topology"] = topo
            f["/Mesh/mesh/geometry"] = v
            f["/MeshTags/facets/topology"] = q
            f["/MeshTags/facets/values"] = vals
        item = lambda dims, ref, dt="": (
            f'<DataItem Dimensions="{dims}"{dt} Format="HDF">'
            f"mesh.h5:{ref}</DataItem>")
        data = {"topo": "/Mesh/mesh/topology", "geom": "/Mesh/mesh/geometry",
                "qt": "/MeshTags/facets/topology",
                "qv": "/MeshTags/facets/values"}
    else:
        text = {"topo": topo, "geom": v, "qt": q, "qv": vals}
        item = lambda dims, ref, dt="": (
            f'<DataItem Dimensions="{dims}"{dt} Format="XML">'
            + " ".join(repr(float(x)) if ref == "geom" else str(int(x))
                       for x in np.ravel(text[ref])) + "</DataItem>")
        data = {k: k for k in text}
    nt, nv, nq = len(topo), len(v), len(q)
    tags = f"""
    <Grid Name="facet_tags">
      <Topology TopologyType="Quadrilateral" NumberOfElements="{nq}">
        {item(f"{nq} 4", data["qt"], ' DataType="Int"')}
      </Topology>
      <Attribute Name="facet_tags" Center="Cell">
        {item(nq, data["qv"], ' DataType="Int"')}
      </Attribute>
    </Grid>"""
    path = tmp_path / "mesh.xdmf"
    path.write_text(f"""<?xml version="1.0"?>
<Xdmf Version="3.0">
  <Domain>
    <Grid Name="planar_3d_0">
      <Topology TopologyType="Hexahedron" NumberOfElements="{nt}">
        {item(f"{nt} 8", data["topo"], ' DataType="Int"')}
      </Topology>
      <Geometry GeometryType="XYZ">
        {item(f"{nv} 3", data["geom"])}
      </Geometry>
    </Grid>{tags if inline_tags else ""}
  </Domain>
</Xdmf>
""")
    if not inline_tags:
        (tmp_path / "tags.xdmf").write_text(
            f'<?xml version="1.0"?>\n<Xdmf Version="3.0"><Domain>{tags}'
            "\n</Domain></Xdmf>\n")
    return str(path)


@pytest.mark.parametrize("fmt", ["XML", "HDF"])
def test_parse_xdmf_matches_fustpu(tmp_path, fmt):
    """The same vertices and tagged quads as the JAX package's parse, and
    its cells as the port's under the JAX package's row permutation."""
    from fustpu.mesh import xdmf_io as f_xdmf

    v, c, t = _cylinder()
    path = _fixture(tmp_path, v, c, t, fmt)
    pv, pc, pt = xdmf_io.parse_xdmf(path, "planar_3d_0")
    fv, fc, ft = f_xdmf.parse_xdmf(path, "planar_3d_0")
    assert pv.dtype == fv.dtype and np.array_equal(pv, fv)
    assert np.array_equal(pv, v)
    assert np.array_equal(pc, c[:, xdmf_io._GMSH_HEX])
    assert np.array_equal(fc, pc[:, _F_PERM])
    assert [k for k, _ in pt] == [k for k, _ in ft]
    assert all(np.array_equal(np.sort(a), np.sort(b))
               for (_, a), (_, b) in zip(pt, ft))


@pytest.mark.parametrize("fmt", ["XML", "HDF"])
def test_xdmf_to_msh_bytes_match_fustpu(tmp_path, fmt):
    """The .msh file is byte for byte the JAX package's `write_msh` of the
    mesh the fixture was written from."""
    from fustpu.mesh import msh_io as f_msh

    v, c, t = _cylinder()
    path = _fixture(tmp_path, v, c, t, fmt)
    got = xdmf_io.xdmf_to_msh(path, str(tmp_path / "got.msh"))
    want = f_msh.write_msh(str(tmp_path / "want.msh"), v, c, t)
    assert open(got, "rb").read() == open(want, "rb").read()


def test_separate_tags_file(tmp_path):
    """Tags in a second XDMF file, the reference's two-file layout."""
    v, c, t = _cylinder()
    path = _fixture(tmp_path, v, c, t, "XML", inline_tags=False)
    assert xdmf_io.parse_xdmf(path)[2] == []
    mesh = xdmf_io.read_xdmf(path, 2, tags_path=str(tmp_path / "tags.xdmf"))
    ref = msh_io.read_msh(msh_io.write_msh(str(tmp_path / "d"), v, c, t), 2)
    for tag in (1, 2):
        assert np.array_equal(mesh.boundary_facets(tag),
                              ref.boundary_facets(tag))


def test_read_xdmf_model_matches_fustpu(tmp_path):
    """An imported prismatic mesh read from XDMF: the arrays of the .msh
    import, and 10 steps of a two-layer Westervelt model against the JAX
    package's model on the same mesh, float64."""
    import jax.numpy as jnp
    from fustpu import config as f_config
    from fustpu.mesh import msh_io as f_msh
    from fustpu.models.westervelt import WesterveltModel as FWest

    v, c, t = _cylinder()
    mesh = xdmf_io.read_xdmf(_fixture(tmp_path, v, c, t, "XML"), 3,
                             mesh_name="planar_3d_0")
    direct = msh_io.write_msh(str(tmp_path / "direct"), v, c, t)
    ref = msh_io.read_msh(direct, 3)
    assert isinstance(mesh, ExtrudedHexMesh)
    _assert_same_mesh(mesh, ref)
    zc = mesh.cell_corners_flat.mean(axis=1)[:, 2]
    props = dict(sound_speed=np.where(zc < 0.01, 1500.0, 1650.0),
                 density=np.where(zc < 0.01, 1000.0, 1050.0),
                 nonlinearity=100.0, attenuation_dB=50.0)
    args = (mesh.boundary_facets(1), mesh.boundary_facets(2))
    fmodel = FWest(f_msh.read_msh(direct, 3), f_config.Material(**props),
                   f_config.Source(frequency=0.5e6, amplitude=1e5), *args,
                   dtype=jnp.float64)
    model = WesterveltModel(mesh, Material(**props),
                            Source(frequency=0.5e6, amplitude=1e5), *args,
                            dtype=torch.float64, device="cpu")
    dt, _ = fmodel.cfl_dt()
    rng = np.random.default_rng(0)
    u0, v0 = rng.standard_normal(mesh.ndofs), rng.standard_normal(mesh.ndofs)
    fout, _ = fmodel.solve(fmodel.init_state(0.0, u0=u0, v0=v0), dt, STEPS)
    out, _ = model.solve(model.init_state(0.0, u0=u0, v0=v0), dt, STEPS)
    for a, b in ((out.u, fout.u), (out.v, fout.v)):
        a, b = a.numpy().reshape(-1), np.asarray(b).reshape(-1)
        assert np.linalg.norm(a - b) / np.linalg.norm(b) <= TOL


def test_write_xdmf_reads_back_the_msh_import(tmp_path):
    """An imported bowl (extruded), written with `write_xdmf` in the
    order of the .msh file it was imported from, with the coordinates
    that import read: every mesh array bitwise the .msh import's, and the
    same first steps of a model on it."""
    nc, L, Lt = (8, 4, 4), 0.08, 0.05
    box = build_mapped_mesh(nc, 2, bowl_mapping(0.035, 0.016, Lt / 2,
                                                Lt / 2, L),
                            hi=(L, Lt, Lt))
    in_ap = lambda c: ((c[:, 1] - Lt / 2) ** 2
                       + (c[:, 2] - Lt / 2) ** 2) < 0.016**2
    tags = bowl_tags(box, in_ap)
    ref = msh_io.read_msh(msh_io.export_box_msh(box, tags,
                                                str(tmp_path / "bowl")), 2)
    assert isinstance(ref, ExtrudedHexMesh)
    _, cells, quads = msh_io.box_msh_arrays(box, tags)
    path = xdmf_io.write_xdmf(str(tmp_path / "bowl.xdmf"), ref.vertices,
                              cells, quads)
    mesh = xdmf_io.read_xdmf(path, 2)
    assert isinstance(mesh, ExtrudedHexMesh)
    _assert_same_mesh(mesh, ref)
    assert np.array_equal(mesh.dofmap, ref.dofmap)
    mat = Material(sound_speed=1480.0, density=1000.0, nonlinearity=3.5,
                   attenuation_dB=0.2)
    src = Source(frequency=1.1e6, amplitude=5.7e5)
    runs = []
    for m in (ref, mesh):
        model = WesterveltModel(m, mat, src, m.boundary_facets(1),
                                m.boundary_facets(2), dtype=torch.float64,
                                device="cpu")
        dt, _ = model.cfl_dt(0.4)
        runs.append(model.solve(model.init_state(), dt, 3)[0].u)
    assert torch.equal(runs[0], runs[1])


def _assert_same_mesh(mesh, ref):
    """Every dataclass field of the two meshes bitwise equal."""
    for f in dataclasses.fields(ref):
        a, b = getattr(mesh, f.name), getattr(ref, f.name)
        if isinstance(b, dict):
            assert a.keys() == b.keys() and all(
                np.array_equal(a[k], b[k]) for k in b), f.name
        else:
            assert np.array_equal(a, b), f.name


def test_hdf_without_h5py_raises(tmp_path, monkeypatch):
    """An HDF DataItem where h5py cannot be imported raises an error that
    names h5py (inline files need nothing)."""
    v, c, t = _cylinder()
    path = tmp_path / "mesh.xdmf"
    path.write_text(f"""<?xml version="1.0"?>
<Xdmf Version="3.0"><Domain><Grid Name="m">
  <Topology TopologyType="Hexahedron" NumberOfElements="{len(c)}">
    <DataItem Dimensions="{len(c)} 8" DataType="Int" Format="HDF">mesh.h5:/t</DataItem>
  </Topology>
  <Geometry GeometryType="XYZ">
    <DataItem Dimensions="{len(v)} 3" Format="HDF">mesh.h5:/g</DataItem>
  </Geometry>
</Grid></Domain></Xdmf>
""")
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        xdmf_io.parse_xdmf(str(path))
