"""XDMF mesh import: DOLFINx-written XDMF hex meshes (the reference's own
input format: `BM1SC2/mesh.xdmf` grid 'planar_3d_0' for the piston,
`transducer_3d_W` plus facet meshtags for the bowl) converted to Gmsh .msh
and read through this package's .msh pipeline (`msh_io.read_msh`,
extrusion detection included).  Counterpart of
``fustpu/mesh/xdmf_io.py``.

Scope: XDMF 3 XML with inline ('Format="XML"') or HDF5 ('Format="HDF"')
DataItems; Hexahedron grids (the mesh) and Quadrilateral grids carrying
an integer Attribute (facet meshtags), in the same file or a second one.
HDF5 needs `h5py`, imported only when an HDF DataItem is read.

Vertex order: DOLFINx writes XDMF topology in VTK's node order, which for
the 8-node hexahedron and the quadrilateral is Gmsh's cyclic order, so
`parse_xdmf` returns the file's rows as they are (Gmsh order) and
`xdmf_to_msh` writes them so.  (The JAX package's reader permutes the rows
as if they were lexicographic and then hands Gmsh-ordered rows to a
writer that expects this package's 4a+2b+c order: the cells it writes are
relabelled.)  `write_xdmf` writes a mesh as inline XDMF in the same order.
"""

from __future__ import annotations

import os
import tempfile
import xml.etree.ElementTree as ET

import numpy as np

from fustpu_torch.mesh import msh_io

# Gmsh (= VTK) hex corner g -> this package's corner 4a+2b+c
_GMSH_HEX = np.asarray(msh_io._GMSH_HEX)


def _read_dataitem(item: ET.Element, base_dir: str) -> np.ndarray:
    fmt = (item.get("Format") or "XML").upper()
    if fmt == "XML":
        text = (item.text or "").split()
        dt = (item.get("DataType") or "Float").lower()
        arr = np.array(text, np.float64 if dt == "float" else np.int64)
    elif fmt == "HDF":
        try:
            import h5py
        except ImportError as e:
            raise ImportError("an XDMF DataItem with Format=\"HDF\" needs "
                              "the h5py package, which is not installed "
                              "(inline Format=\"XML\" DataItems need "
                              "nothing)") from e
        fname, dset = (item.text or "").strip().split(":", 1)
        with h5py.File(os.path.join(base_dir, fname), "r") as f:
            arr = np.asarray(f[dset])
    else:
        raise ValueError(f"unsupported XDMF DataItem format {fmt!r}")
    dims = item.get("Dimensions")
    if dims:
        arr = arr.reshape([int(d) for d in dims.split()])
    return arr


def _tagged_quads(grid: ET.Element, base: str) -> list:
    """[(tag, (4,) vertex ids), ...] of a Quadrilateral grid with an
    Attribute (none without one)."""
    attr = grid.find("Attribute")
    if attr is None:
        return []
    quads = _read_dataitem(grid.find("Topology").find("DataItem"),
                           base).reshape(-1, 4).astype(np.int64)
    vals = _read_dataitem(attr.find("DataItem"), base).reshape(-1)
    return [(int(t), q) for t, q in zip(vals.astype(np.int64), quads)]


def _topology_type(grid: ET.Element) -> str:
    topo = grid.find("Topology")
    if topo is None:
        return ""
    return (topo.get("TopologyType") or topo.get("Type") or "").lower()


def parse_xdmf(path: str, mesh_name: str | None = None):
    """(vertices (nv, 3) float64, hex cells (nc, 8) in Gmsh order, tagged
    quads [(tag, (4,) vertex ids), ...]) of an XDMF file: the Hexahedron
    grid (named `mesh_name` if given) and every tagged Quadrilateral
    grid."""
    tree = ET.parse(path)
    base = os.path.dirname(os.path.abspath(path))
    verts = cells = None
    tagged: list = []
    for g in tree.getroot().iter("Grid"):
        ttype = _topology_type(g)
        if ttype.startswith("hex"):
            if mesh_name is not None and g.get("Name") != mesh_name:
                continue
            geom = g.find("Geometry")
            if geom is None:
                raise ValueError(f"{path}: hex grid without Geometry")
            verts = _read_dataitem(geom.find("DataItem"), base)
            if (geom.get("GeometryType") or "XYZ").upper() == "XY":
                verts = np.pad(verts, [(0, 0), (0, 1)])
            cells = _read_dataitem(g.find("Topology").find("DataItem"),
                                   base).reshape(-1, 8).astype(np.int64)
        elif ttype.startswith("quad"):
            tagged.extend(_tagged_quads(g, base))
    if cells is None:
        raise ValueError(
            f"{path}: no Hexahedron grid"
            + (f" named {mesh_name!r}" if mesh_name else ""))
    return np.asarray(verts, np.float64), cells, tagged


def xdmf_to_msh(xdmf_path: str, out_path: str,
                mesh_name: str | None = None,
                tags_path: str | None = None,
                binary: bool = False) -> str:
    """Convert an XDMF hex mesh (and the facet tags of an optional second
    XDMF file, the reference's two-file layout) to a Gmsh v2.2 .msh file,
    ASCII or binary (exact doubles).  Returns the path written."""
    verts, cells, tagged = parse_xdmf(xdmf_path, mesh_name)
    if tags_path is not None:
        base = os.path.dirname(os.path.abspath(tags_path))
        for g in ET.parse(tags_path).getroot().iter("Grid"):
            if _topology_type(g).startswith("quad"):
                tagged.extend(_tagged_quads(g, base))
    ours = np.empty_like(cells)
    ours[:, _GMSH_HEX] = cells          # Gmsh order -> 4a+2b+c
    return msh_io.write_msh(out_path, verts, ours,
                            [(t, list(q)) for t, q in tagged],
                            binary=binary)


def read_xdmf(path: str, degree: int, mesh_name: str | None = None,
              tags_path: str | None = None, detect_extrusion: bool = True):
    """Read an XDMF hex mesh (the reference's XDMFFile.read_mesh /
    read_meshtags) through a temporary binary .msh file, so every vertex
    coordinate arrives exactly: an ExtrudedHexMesh when the topology is an
    extrusion, else a general mesh in `locality_order`."""
    with tempfile.TemporaryDirectory() as tmp:
        msh = xdmf_to_msh(path, os.path.join(tmp, "mesh.msh"), mesh_name,
                          tags_path, binary=True)
        return msh_io.read_msh(msh, degree,
                               detect_extrusion=detect_extrusion)


def write_xdmf(path: str, vertices: np.ndarray, cells: np.ndarray,
               tagged_quads: list | None = None,
               name: str = "mesh") -> str:
    """Write a hex mesh (cells in this package's 4a+2b+c order) and its
    tagged quads as inline-XML XDMF, DOLFINx's layout: a Hexahedron grid
    `name` in VTK (Gmsh) corner order and a Quadrilateral grid
    'facet_tags' with the tags as a cell Attribute.  Coordinates are
    written with 17 significant digits, so they read back exactly."""
    cells = np.asarray(cells, np.int64)[:, _GMSH_HEX]
    verts = np.asarray(vertices, np.float64)
    fmt = lambda a, f: "\n".join(" ".join(f % x for x in row) for row in a)
    nt, nv = cells.shape[0], verts.shape[0]
    parts = [f"""<?xml version="1.0"?>
<Xdmf Version="3.0">
  <Domain>
    <Grid Name="{name}" GridType="Uniform">
      <Topology TopologyType="Hexahedron" NumberOfElements="{nt}">
        <DataItem Dimensions="{nt} 8" DataType="Int" Format="XML">
{fmt(cells, "%d")}
        </DataItem>
      </Topology>
      <Geometry GeometryType="XYZ">
        <DataItem Dimensions="{nv} 3" Format="XML">
{fmt(verts, "%.17g")}
        </DataItem>
      </Geometry>
    </Grid>"""]
    if tagged_quads:
        q = np.asarray([v for _, v in tagged_quads], np.int64)
        t = np.asarray([[k] for k, _ in tagged_quads], np.int64)
        nq = q.shape[0]
        parts.append(f"""
    <Grid Name="facet_tags" GridType="Uniform">
      <Topology TopologyType="Quadrilateral" NumberOfElements="{nq}">
        <DataItem Dimensions="{nq} 4" DataType="Int" Format="XML">
{fmt(q, "%d")}
        </DataItem>
      </Topology>
      <Attribute Name="facet_tags" AttributeType="Scalar" Center="Cell">
        <DataItem Dimensions="{nq}" DataType="Int" Format="XML">
{fmt(t, "%d")}
        </DataItem>
      </Attribute>
    </Grid>""")
    parts.append("\n  </Domain>\n</Xdmf>\n")
    with open(path, "w") as f:
        f.write("".join(parts))
    return path
