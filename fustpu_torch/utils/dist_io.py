"""Per-rank field snapshots of a sharded run, with no gather.

The reference writes parallel .bp snapshots with VTXWriter on every MPI
rank: each rank writes only the piece it owns, and the file set is the
global field.  `ShardSnapshotWriter`, bound to one rank's part of a
sharded model (`ShardedModel`, `ExtrudedShardedModel` or
`IndexedShardedModel`), writes that rank's local block of a field as
``<name>.d<rank>.npy`` (raw, no index arithmetic on the write path), and
once a ``layout.d<rank>.npz`` of where the block lies in the global field:
the block's coordinates in the box grid, or the global rows (extruded
meshes) or DOFs (general ones) of its entries.  Rank 0 writes
``index.json``.  `assemble_snapshot` puts the global field back together
offline, with no process group.  Counterpart of
``fustpu/utils/dist_io.py``.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np


def _layout(smodel) -> tuple[dict, dict]:
    """(global meta, this rank's layout arrays) of a rank's sharded
    model."""
    from fustpu_torch.parallel.extruded import (ExtrudedShardedModel,
                                                IndexedShardedModel)
    from fustpu_torch.parallel.models import ShardedModel

    grid = smodel.grid
    if isinstance(smodel, ShardedModel):
        mesh = smodel.mesh
        meta = {"kind": "box_grid", "nc": list(mesh.nc),
                "S": list(grid.shape), "degree": mesh.degree,
                "grid_shape": list(mesh.grid_shape)}
        return meta, {"coords": np.asarray(grid.coords, np.int64)}
    if isinstance(smodel, (ExtrudedShardedModel, IndexedShardedModel)):
        rows = isinstance(smodel, ExtrudedShardedModel)
        meta = {"kind": "rows" if rows else "dofs",
                "nglobal": smodel.nglobal, "width": smodel.width,
                "ndofs": smodel.mesh.ndofs, "k": grid.size}
        return meta, {"idx": np.asarray(smodel.ids[grid.rank], np.int64)}
    raise TypeError(f"unsupported sharded model {type(smodel).__name__}")


class ShardSnapshotWriter:
    """Per-rank snapshot writer bound to one rank's sharded model: the
    layout files are written at construction, `write(name, field)` writes
    the rank's block of `field` (a local tensor or array)."""

    def __init__(self, directory: str, smodel):
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.rank = smodel.grid.rank
        self.meta, lay = _layout(smodel)
        if self.rank == 0:
            with open(os.path.join(self.dir, "index.json"), "w") as f:
                json.dump(self.meta, f)
        np.savez(os.path.join(self.dir, f"layout.d{self.rank:05d}.npz"),
                 **lay)

    def write(self, name: str, field) -> str:
        """Write the rank's block of `field` as raw .npy; returns the
        path."""
        from fustpu_torch.utils.io import to_host

        p = os.path.join(self.dir, f"{name}.d{self.rank:05d}.npy")
        np.save(p, to_host(field))
        return p


def assemble_snapshot(directory: str, name: str) -> np.ndarray:
    """The global field of snapshot `name` written by ShardSnapshotWriter:
    the (gx, gy, gz) node grid of a box, the flat (ndofs,) vector of an
    imported mesh.  Entries several ranks hold agree (the writers run on
    consistent fields after the exchange), so the last writer wins.
    Raises if any rank's file is missing."""
    from fustpu_torch.parallel import sharding as sh

    with open(os.path.join(directory, "index.json")) as f:
        meta = json.load(f)
    pieces = {}
    for p in sorted(glob.glob(os.path.join(directory, f"{name}.d*.npy"))):
        d = int(os.path.basename(p).rsplit(".d", 1)[1].split(".")[0])
        pieces[d] = np.load(p)
    nranks = (int(np.prod(meta["S"])) if meta["kind"] == "box_grid"
              else meta["k"])
    missing = sorted(set(range(nranks)) - set(pieces))
    if missing:
        raise FileNotFoundError(
            f"snapshot '{name}' in {directory} is missing the files of "
            f"ranks {missing} (found {sorted(pieces)}): collect every "
            "rank's output before reassembly")
    layouts = {d: np.load(os.path.join(directory, f"layout.d{d:05d}.npz"))
               for d in pieces}
    if meta["kind"] == "box_grid":
        S = meta["S"]
        blocks = [None] * nranks
        for d, blk in pieces.items():
            c = tuple(int(x) for x in layouts[d]["coords"])
            blocks[int(np.ravel_multi_index(c, S))] = blk
        full = sh.merge_node_field(blocks, meta["nc"], S, meta["degree"])
        return full.reshape(meta["grid_shape"])
    dtype = next(iter(pieces.values())).dtype
    out = np.zeros((meta["nglobal"], meta["width"]), dtype)
    for d, piece in pieces.items():
        out[layouts[d]["idx"]] = piece.reshape(-1, meta["width"])
    return out.reshape(-1)
