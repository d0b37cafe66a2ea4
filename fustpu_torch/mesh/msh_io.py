"""Gmsh `.msh` file I/O (ASCII, formats 2.2 and 4.1) for unstructured hex
meshes with tagged boundary surfaces.

Hexahedral volume elements become cells; quadrilateral surface elements
carrying physical tags become (cell, local_facet) facet sets, matched to
owning cells by corner-vertex sets.  Vendored from
``fustpu/mesh/msh_io.py``.

A writer (format 2.2) is included so test/demo meshes can be generated
and round-tripped without Gmsh installed; files written by real Gmsh in
either ASCII format parse identically.

Gmsh hexahedron corner order (nodes 0..7):
    (0,0,0),(1,0,0),(1,1,0),(0,1,0),(0,0,1),(1,0,1),(1,1,1),(0,1,1)
mapped to this package's 4a+2b+c convention; quads are (0,0),(1,0),(1,1),
(0,1) cycles (order irrelevant here — facets are matched as corner sets).
"""

from __future__ import annotations

import numpy as np

from fustpu_torch.mesh.unstructured import (_FACET_CORNERS,
                                            UnstructuredHexMesh, face_keys)

# gmsh node k -> our corner id 4a+2b+c
_GMSH_HEX = [0b000, 0b100, 0b110, 0b010, 0b001, 0b101, 0b111, 0b011]
_HEX_TYPE = 5    # gmsh element type: 8-node hexahedron
_QUAD_TYPE = 3   # 4-node quadrangle
_HEX27_TYPE = 12  # 27-node (2nd-order) hexahedron -> isoparametric mesh
_QUAD9_TYPE = 10  # 9-node quadrangle (2nd-order surface; corners used)


def _rowview(a: np.ndarray) -> np.ndarray:
    """Rows of an int array as a 1D sortable/searchable void view."""
    a = np.ascontiguousarray(a.astype(np.int64))
    return a.view([("", np.int64)] * a.shape[1]).ravel()


def _facets_from_quads(cells: np.ndarray, quads: list) -> dict:
    """Match tagged quads (vertex-id 4-tuples) to (cell, local_facet):
    vectorised sorted-key search."""
    if not quads:
        return {}
    keys = face_keys(cells).reshape(-1, 4)
    order = np.lexsort(keys.T[::-1])
    sk = _rowview(keys[order])
    qarr = np.sort(np.asarray([v for _, v in quads], np.int64), axis=1)
    qk = _rowview(qarr)
    pos = np.searchsorted(sk, qk)
    if np.any(pos >= sk.size) or np.any(sk[np.minimum(pos, sk.size - 1)]
                                        != qk):
        bad = int(np.argmax(sk[np.minimum(pos, sk.size - 1)] != qk))
        raise ValueError(
            f"tagged quad {tuple(qarr[bad])} does not match any hex face")
    rows = order[pos]
    pairs = np.stack([rows // 6, rows % 6], axis=1).astype(np.int32)
    tags: dict[int, list] = {}
    for (tag, _), pair in zip(quads, pairs):
        tags.setdefault(int(tag), []).append(tuple(pair))
    return {t: np.asarray(sorted(v), np.int32) for t, v in tags.items()}


def read_msh(path: str, degree: int,
             detect_extrusion: bool = True) -> UnstructuredHexMesh:
    """Parse a .msh file (ASCII or binary, formats 2.2 and 4.1; real Gmsh
    writes binary with `-bin`) into an UnstructuredHexMesh with degree-P
    GLL dofs.

    When the mesh topology is an extrusion (every practical piston or
    column mesh), the returned object is the ExtrudedHexMesh subclass,
    which the models run on the extruded stiffness kernel
    (fustpu_torch.mesh.extruded); pass detect_extrusion=False to force the
    generic per-element representation."""
    with open(path, "rb") as f:
        data = f.read()
    head = data[:256].split(b"\n")
    if not head or head[0].strip() != b"$MeshFormat":
        raise ValueError(f"{path}: not a Gmsh .msh file")
    version_s, ftype, dsize = head[1].split()[:3]
    if int(ftype) == 1:                               # binary payloads
        # endianness probe: gmsh writes the int 1 right after the format
        # line; a big-endian writer produces 0x01000000, and parsing its
        # little-endian payload would yield garbage coordinates with no
        # clear error, so check up front.
        probe_off = len(head[0]) + 1 + len(head[1]) + 1
        probe = int(np.frombuffer(data, "<i4", 1, probe_off)[0])
        if probe != 1:
            raise ValueError(
                f"{path}: binary .msh endianness probe is {probe} "
                "(expected 1): big-endian files are not supported")
        if float(version_s) < 4.0:
            parsed = _parse_binary22(data, path)
        else:
            parsed = _parse_binary41(data, path)
        return _assemble_mesh(*parsed, degree=degree,
                              detect_extrusion=detect_extrusion)
    lines = data.decode().splitlines()
    i = 0

    def section(name, required=False):
        nonlocal i
        while i < len(lines) and lines[i].strip() != f"${name}":
            i += 1
        if i == len(lines):
            i = 0  # reset so later section() lookups scan from the top
            if required:
                raise ValueError(f"{path}: missing ${name} section")
            return None
        i += 1
        start = i
        while lines[i].strip() != f"$End{name}":
            i += 1
        body = lines[start:i]
        i = 0  # reset for next section search from the top
        return body

    fmt = section("MeshFormat")
    if fmt is None:
        raise ValueError(f"{path}: not a Gmsh .msh file")
    version = float(fmt[0].split()[0])

    node_ids, coords = [], []
    quads, hexes = [], []     # (tag, verts) / verts
    if version < 4.0:
        body = section("Nodes", required=True)
        for ln in body[1:]:
            parts = ln.split()
            node_ids.append(int(parts[0]))
            coords.append([float(x) for x in parts[1:4]])
        body = section("Elements", required=True)
        for ln in body[1:]:
            parts = [int(x) for x in ln.split()]
            etype, ntags = parts[1], parts[2]
            tags = parts[3:3 + ntags]
            verts = parts[3 + ntags:]
            if etype in (_HEX_TYPE, _HEX27_TYPE):
                hexes.append(verts)
            elif etype in (_QUAD_TYPE, _QUAD9_TYPE):
                quads.append((tags[0] if tags else 0, verts[:4]))
    else:
        body = section("Nodes", required=True)
        k = 1
        while k < len(body):
            _, _, _, nn = (int(x) for x in body[k].split())
            ids = [int(body[k + 1 + j]) for j in range(nn)]
            for j in range(nn):
                parts = body[k + 1 + nn + j].split()
                node_ids.append(ids[j])
                coords.append([float(x) for x in parts[:3]])
            k += 1 + 2 * nn
        # entity -> physical tag map for surfaces
        surf_tag = {}
        ent = section("Entities")
        if ent is not None:
            np_, nc_, ns_, nv_ = (int(x) for x in ent[0].split())
            k = 1 + np_ + nc_
            for j in range(ns_):
                parts = ent[k + j].split()
                ent_id = int(parts[0])
                nphys = int(parts[7])
                if nphys:
                    surf_tag[ent_id] = int(parts[8])
        body = section("Elements", required=True)
        k = 1
        while k < len(body):
            dim, ent_id, etype, ne = (int(x) for x in body[k].split())
            for j in range(ne):
                parts = [int(x) for x in body[k + 1 + j].split()]
                verts = parts[1:]
                if etype in (_HEX_TYPE, _HEX27_TYPE):
                    hexes.append(verts)
                elif etype in (_QUAD_TYPE, _QUAD9_TYPE):
                    if ent_id not in surf_tag:
                        raise ValueError(
                            f"{path}: surface entity {ent_id} carries "
                            "quads but no physical tag: tag boundary "
                            "surfaces with physical groups in Gmsh")
                    quads.append((surf_tag[ent_id], verts[:4]))
            k += 1 + ne

    return _assemble_mesh(path, node_ids, coords, hexes, quads,
                          degree=degree, detect_extrusion=detect_extrusion)


def _assemble_mesh(path, node_ids, coords, hexes, quads, degree: int,
                   detect_extrusion: bool) -> UnstructuredHexMesh:
    """Shared tail of the ASCII/binary parsers: remap node ids, reorder
    corners, match tagged quads, detect extrusion."""
    if len(hexes) == 0:
        raise ValueError(f"{path}: no hexahedral elements")
    remap = {int(nid): j for j, nid in enumerate(node_ids)}
    verts = np.asarray(coords, np.float64)
    cells = np.empty((len(hexes), 8), np.int64)
    for ci, h in enumerate(hexes):
        for k_g, our in enumerate(_GMSH_HEX):
            cells[ci, our] = remap[int(h[k_g])]
    geom_nodes = None
    if len(hexes[0]) == 27:
        # 2nd-order (isoparametric) hexes: carry the full triquadratic
        # map alongside the trilinear corner shadow
        from fustpu_torch.elements.hex import GMSH_HEX27_TO_TP

        gn = np.empty((len(hexes), 27), np.int64)
        for ci, h in enumerate(hexes):
            for k_g, tp in enumerate(GMSH_HEX27_TO_TP):
                gn[ci, tp] = remap[int(h[k_g])]
        geom_nodes = verts[gn]
    quads_l = [(t, [remap[int(v)] for v in vs]) for t, vs in quads]
    mesh = UnstructuredHexMesh(
        degree=degree, vertices=verts, cells=cells,
        facet_tag_map=_facets_from_quads(cells, quads_l),
        geom_nodes=geom_nodes)
    if detect_extrusion:
        from fustpu_torch.mesh.extruded import as_extruded

        ex = as_extruded(mesh)
        if ex is not None:
            return ex
    # non-prismatic import: the JAX package's cell order (and so its dof
    # numbering), which keeps consecutive cells' dofs close together
    from fustpu_torch.mesh.unstructured import locality_order

    return locality_order(mesh)


def _find_section(data: bytes, name: str, path: str):
    """(start, end) byte offsets of a section's payload (after the
    header line's newline, before $End<name>)."""
    tag = b"$" + name.encode()
    k = data.find(tag + b"\n")
    if k < 0:
        k = data.find(tag + b"\r\n")
        if k < 0:
            return None
    start = data.find(b"\n", k) + 1
    end = data.find(b"$End" + name.encode(), start)
    if end < 0:
        raise ValueError(f"{path}: unterminated ${name} section")
    return start, end


_NNODES = {_HEX_TYPE: 8, _QUAD_TYPE: 4, _HEX27_TYPE: 27,
           _QUAD9_TYPE: 9, 1: 2, 2: 3, 4: 4, 6: 6, 7: 5,
           15: 1}


def _parse_binary22(data: bytes, path: str):
    """Gmsh v2.2 binary: ASCII section markers and counts, little-endian
    binary records (int32 ids/tags, float64 coords)."""
    i32, f64 = np.dtype("<i4"), np.dtype("<f8")
    sec = _find_section(data, "Nodes", path)
    if sec is None:
        raise ValueError(f"{path}: missing $Nodes section")
    s, e = sec
    nl = data.find(b"\n", s)
    nn = int(data[s:nl])
    rec = np.frombuffer(data, np.uint8, count=nn * 28,
                        offset=nl + 1).reshape(nn, 28)
    node_ids = rec[:, :4].copy().view(i32).ravel()
    coords = rec[:, 4:].copy().view(f64).reshape(nn, 3)

    sec = _find_section(data, "Elements", path)
    if sec is None:
        raise ValueError(f"{path}: missing $Elements section")
    s, e = sec
    nl = data.find(b"\n", s)
    ne = int(data[s:nl])
    off = nl + 1
    hexes, quads = [], []
    seen = 0
    while seen < ne:
        etype, nfollow, ntags = np.frombuffer(data, i32, 3, off)
        off += 12
        nnod = _NNODES.get(int(etype))
        if nnod is None:
            raise ValueError(f"{path}: unsupported element type {etype}")
        rl = 1 + ntags + nnod
        blk = np.frombuffer(data, i32, int(nfollow) * rl,
                            off).reshape(int(nfollow), rl)
        off += int(nfollow) * rl * 4
        if etype in (_HEX_TYPE, _HEX27_TYPE):
            hexes.extend(blk[:, 1 + ntags:].tolist())
        elif etype in (_QUAD_TYPE, _QUAD9_TYPE):
            for row in blk:
                tag = int(row[1]) if ntags else 0
                quads.append((tag, row[1 + ntags:1 + ntags + 4].tolist()))
        seen += int(nfollow)
    return path, node_ids, coords, hexes, quads


def _parse_binary41(data: bytes, path: str):
    """Gmsh v4.1 binary: size_t(=8-byte) counts/tags, int32 entity
    metadata, float64 coords; surface physical tags from $Entities."""
    i32, u64, f64 = np.dtype("<i4"), np.dtype("<u8"), np.dtype("<f8")

    def ints(off, k):
        return np.frombuffer(data, i32, k, off), off + 4 * k

    def szts(off, k):
        return np.frombuffer(data, u64, k, off), off + 8 * k

    def dbls(off, k):
        return np.frombuffer(data, f64, k, off), off + 8 * k

    surf_tag = {}
    sec = _find_section(data, "Entities", path)
    if sec is not None:
        off = sec[0]
        (np_, nc_, ns_, nv_), off = szts(off, 4)
        for _ in range(int(np_)):                     # points
            _, off = ints(off, 1)
            _, off = dbls(off, 3)
            (nph,), off = szts(off, 1)
            _, off = ints(off, int(nph))
        for _ in range(int(nc_)):                     # curves
            _, off = ints(off, 1)
            _, off = dbls(off, 6)
            (nph,), off = szts(off, 1)
            _, off = ints(off, int(nph))
            (nb,), off = szts(off, 1)
            _, off = ints(off, int(nb))
        for _ in range(int(ns_)):                     # surfaces
            (tag,), off = ints(off, 1)
            _, off = dbls(off, 6)
            (nph,), off = szts(off, 1)
            phys, off = ints(off, int(nph))
            if nph:
                surf_tag[int(tag)] = int(phys[0])
            (nb,), off = szts(off, 1)
            _, off = ints(off, int(nb))

    sec = _find_section(data, "Nodes", path)
    if sec is None:
        raise ValueError(f"{path}: missing $Nodes section")
    off = sec[0]
    (nblk, nnodes, _, _), off = szts(off, 4)
    node_ids = np.empty(int(nnodes), np.int64)
    coords = np.empty((int(nnodes), 3))
    at = 0
    for _ in range(int(nblk)):
        (_, _, parametric), off = ints(off, 3)
        if parametric:
            raise ValueError(
                f"{path}: parametric node blocks are not supported")
        (nn,), off = szts(off, 1)
        ids, off = szts(off, int(nn))
        xyz, off = dbls(off, 3 * int(nn))
        node_ids[at:at + int(nn)] = ids.astype(np.int64)
        coords[at:at + int(nn)] = xyz.reshape(-1, 3)
        at += int(nn)

    sec = _find_section(data, "Elements", path)
    if sec is None:
        raise ValueError(f"{path}: missing $Elements section")
    off = sec[0]
    (nblk, _, _, _), off = szts(off, 4)
    hexes, quads = [], []
    for _ in range(int(nblk)):
        (dim, ent, etype), off = ints(off, 3)
        (ne,), off = szts(off, 1)
        nnod = _NNODES.get(int(etype))
        if nnod is None:
            raise ValueError(f"{path}: unsupported element type {etype}")
        blk, off = szts(off, int(ne) * (1 + nnod))
        blk = blk.reshape(int(ne), 1 + nnod)
        if etype in (_HEX_TYPE, _HEX27_TYPE):
            hexes.extend(blk[:, 1:].astype(np.int64).tolist())
        elif etype in (_QUAD_TYPE, _QUAD9_TYPE):
            if int(ent) not in surf_tag:
                raise ValueError(
                    f"{path}: surface entity {ent} carries quads but no "
                    "physical tag: tag boundary surfaces with physical "
                    "groups in Gmsh")
            for row in blk:
                quads.append((surf_tag[int(ent)],
                              row[1:5].astype(np.int64).tolist()))
    return path, node_ids, coords, hexes, quads


def box_msh_arrays(box_mesh, tag_map: dict):
    """(vertices, cells, tagged quads) of a (possibly mapped/perturbed)
    BoxMesh in the form `write_msh` takes: `tag_map` maps tag -> (nf, 2)
    (cell, local_facet) arrays in the box mesh's own conventions."""
    from fustpu_torch.mesh.unstructured import from_box

    umesh = from_box(box_mesh)          # unshuffled: same cell ordering
    quads = []
    for tag, pairs in tag_map.items():
        for cell, lf in np.asarray(pairs):
            verts = [int(umesh.cells[cell][c]) for c in _FACET_CORNERS[lf]]
            quads.append((int(tag), verts))
    return umesh.vertices, umesh.cells, quads


def export_box_msh(box_mesh, tag_map: dict, path: str) -> str:
    """Export a (possibly mapped/perturbed) BoxMesh as a tagged .msh file
    (`box_msh_arrays`).  Round-tripping a body-fitted mapped box through
    this writer and read_msh is the workflow of importing a Gmsh-built
    transducer mesh."""
    return write_msh(path, *box_msh_arrays(box_mesh, tag_map))


def write_msh(path: str, vertices: np.ndarray, cells: np.ndarray,
              tagged_quads: list | None = None,
              binary: bool = False) -> str:
    """Write a Gmsh v2.2 file (ASCII, or binary like real Gmsh's -bin
    default).  `tagged_quads`: list of (tag, (v0, v1, v2, v3)) with
    vertex indices into `vertices`; vertex orders follow this package's
    conventions and are converted to Gmsh's."""
    if not path.endswith(".msh"):
        path += ".msh"
    tagged_quads = tagged_quads or []
    if binary:
        return _write_msh_binary22(path, vertices, cells, tagged_quads)
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        f.write(f"$Nodes\n{len(vertices)}\n")
        for j, p in enumerate(np.asarray(vertices, np.float64)):
            f.write(f"{j + 1} {p[0]:.16g} {p[1]:.16g} {p[2]:.16g}\n")
        f.write("$EndNodes\n")
        ne = len(cells) + len(tagged_quads)
        f.write(f"$Elements\n{ne}\n")
        eid = 1
        for tag, verts in tagged_quads:
            vs = " ".join(str(int(v) + 1) for v in verts)
            f.write(f"{eid} {_QUAD_TYPE} 2 {int(tag)} {int(tag)} {vs}\n")
            eid += 1
        for cell in np.asarray(cells):
            gm = [int(cell[_GMSH_HEX[k]]) + 1 for k in range(8)]
            f.write(f"{eid} {_HEX_TYPE} 2 1 1 " +
                    " ".join(map(str, gm)) + "\n")
            eid += 1
        f.write("$EndElements\n")
    return path


def _write_msh_binary22(path: str, vertices: np.ndarray,
                        cells: np.ndarray, tagged_quads: list) -> str:
    """v2.2 binary writer (int32 ids/tags, float64 coords, little
    endian): the layout `gmsh -bin -format msh22` emits."""
    verts = np.asarray(vertices, np.float64)
    nv = len(verts)
    with open(path, "wb") as f:
        f.write(b"$MeshFormat\n2.2 1 8\n")
        f.write(np.int32(1).tobytes())                # endianness probe
        f.write(b"\n$EndMeshFormat\n")
        f.write(b"$Nodes\n" + str(nv).encode() + b"\n")
        rec = np.empty((nv, 28), np.uint8)
        rec[:, :4] = np.arange(1, nv + 1, dtype="<i4")[:, None].view(
            np.uint8)
        rec[:, 4:] = verts.astype("<f8").view(np.uint8).reshape(nv, 24)
        f.write(rec.tobytes())
        f.write(b"\n$EndNodes\n")
        ne = len(cells) + len(tagged_quads)
        f.write(b"$Elements\n" + str(ne).encode() + b"\n")
        eid = 1
        if tagged_quads:
            f.write(np.asarray([_QUAD_TYPE, len(tagged_quads), 2],
                               "<i4").tobytes())
            blk = np.empty((len(tagged_quads), 7), "<i4")
            for j, (tag, vs) in enumerate(tagged_quads):
                blk[j] = [eid, int(tag), int(tag)] + [int(v) + 1
                                                      for v in vs]
                eid += 1
            f.write(blk.tobytes())
        if len(cells):
            f.write(np.asarray([_HEX_TYPE, len(cells), 2],
                               "<i4").tobytes())
            blk = np.empty((len(cells), 11), "<i4")
            ca = np.asarray(cells)
            for j in range(len(cells)):
                gm = [int(ca[j][_GMSH_HEX[k]]) + 1 for k in range(8)]
                blk[j] = [eid, 1, 1] + gm
                eid += 1
            f.write(blk.tobytes())
        f.write(b"\n$EndElements\n")
    return path
