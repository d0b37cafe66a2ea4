"""Field output and checkpoint / resume.  Counterpart of
``fustpu/utils/io.py``.

- `write_vtk_structured` / `write_vtk_unstructured`: legacy VTK files of
  the node lattice of a box mesh, or of an imported mesh at full GLL
  resolution (every spectral cell as P^3 linear sub-hexes), binary or
  ASCII, byte for byte the JAX package's files for the same mesh and
  fields.  Fields may be tensors (on any device) or arrays.
- `save_point_cloud`: `x,z,u` text rows, the reference's pressure-plane
  snapshots.
- `save_checkpoint` / `load_checkpoint`: the JAX package's npz format
  (keys u, v, ku, kv, t, step, meta; written to a temporary file and
  renamed), so a checkpoint of either package resumes in the other;
  `state_from_checkpoint` puts the arrays into a model's layout, dtype
  and device.  A bfloat16 state is written as float32 (exact), so that
  the file reads back with numpy alone and a restart is bitwise; the JAX
  package writes a bfloat16 state as raw 2-byte records (numpy's ``|V2``,
  which reads back as bytes), and `load_checkpoint` reads those as the
  bfloat16 bits they are.
- `Checkpointer`: asynchronous saves of a state (`torch.save`, one file
  a step) that do not hold the solve: a copy on the device, then a writer
  thread that copies it into pinned memory on a side stream and saves;
  `steps()` lists completed saves only.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path

import numpy as np
import torch

_HEADER = "# vtk DataFile Version 3.0\nfustpu field output\n"
_HEX_CORNERS = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))


def to_host(a) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array; a bfloat16
    tensor as float32 (exact: numpy has no bfloat16)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)


def _from_raw_bf16(a: np.ndarray) -> np.ndarray:
    """A field the JAX package saved from bfloat16 (2-byte void records,
    numpy's ``|V2``: the values' bits) as float32, exactly; any other
    array as it is."""
    if a.dtype.kind != "V" or a.dtype.itemsize != 2:
        return a
    bits = np.frombuffer(a.tobytes(), "<u2").astype(np.uint32) << 16
    return bits.view(np.float32).reshape(a.shape)


def _write_point_data(f, w, fields: dict, npts: int, binary: bool) -> None:
    w(f"\nPOINT_DATA {npts}\n")
    for name, data in fields.items():
        data = to_host(data).reshape(-1)
        w(f"SCALARS {name} float 1\nLOOKUP_TABLE default\n")
        if binary:
            f.write(data.astype(">f4").tobytes())
        else:
            np.savetxt(f, data, fmt="%.7e")
        w("\n")


def write_vtk_structured(path: str, mesh, fields: dict,
                         binary: bool = True) -> str:
    """Legacy VTK STRUCTURED_GRID of a box mesh's spectral node lattice
    with point-data fields (ParaView reads it).  Use binary at scale: the
    ASCII text takes minutes at millions of nodes."""
    if not path.endswith(".vtk"):
        path = path + ".vtk"
    gx, gy, gz = mesh.grid_shape
    pts = mesh.node_coords.reshape(-1, 3)
    mode = "BINARY" if binary else "ASCII"
    with open(path, "wb") as f:
        w = lambda s: f.write(s.encode())
        w(_HEADER)
        w(f"{mode}\nDATASET STRUCTURED_GRID\n")
        # VTK wants x fastest; the node layout is z fastest, so declare
        # the dimensions (gz, gy, gx) and write the points in node order
        w(f"DIMENSIONS {gz} {gy} {gx}\n")
        w(f"POINTS {pts.shape[0]} float\n")
        if binary:
            f.write(pts.astype(">f4").tobytes())
        else:
            np.savetxt(f, pts, fmt="%.7e")
        _write_point_data(f, w, fields, pts.shape[0], binary)
    return path


def vtk_cells(mesh) -> np.ndarray:
    """(cells P^3, 9) big-endian int32 VTK cell rows (8, then the
    VTK_HEXAHEDRON corners) of the linear sub-hexes through every cell's
    GLL lattice.  Built once per mesh and kept on it (~36 B a sub-hex)."""
    rows = mesh.__dict__.get("_vtk_cells")
    if rows is None:
        n = mesh.element.n
        P = n - 1
        dofmap = mesh.dofmap.reshape(mesh.num_cells, n, n, n)
        rows = np.empty((mesh.num_cells, P, P, P, 9), ">i4")
        rows[..., 0] = 8
        for k, (a, b, c) in enumerate(_HEX_CORNERS):
            rows[..., k + 1] = dofmap[:, a:a + P, b:b + P, c:c + P]
        rows = rows.reshape(-1, 9)
        mesh.__dict__["_vtk_cells"] = rows
    return rows


def write_vtk_unstructured(path: str, mesh, fields: dict,
                           binary: bool = True) -> str:
    """Legacy VTK UNSTRUCTURED_GRID of an imported hex mesh at full GLL
    resolution: every spectral cell is written as P^3 linear sub-hexes
    through its GLL lattice, so ParaView shows the polynomial field, not
    a corner decimation (the reference's VTXWriter on any mesh)."""
    if not path.endswith(".vtk"):
        path = path + ".vtk"
    pts = mesh.node_coords.reshape(-1, 3)
    rows = vtk_cells(mesh)
    ncell = rows.shape[0]
    mode = "BINARY" if binary else "ASCII"
    with open(path, "wb") as f:
        w = lambda s: f.write(s.encode())
        w(_HEADER)
        w(f"{mode}\nDATASET UNSTRUCTURED_GRID\n")
        w(f"POINTS {pts.shape[0]} float\n")
        if binary:
            f.write(pts.astype(">f4").tobytes())
            w(f"\nCELLS {ncell} {ncell * 9}\n")
            f.write(rows.tobytes())
            w(f"\nCELL_TYPES {ncell}\n")
            f.write(np.full(ncell, 12, ">i4").tobytes())
        else:
            np.savetxt(f, pts, fmt="%.7e")
            w(f"\nCELLS {ncell} {ncell * 9}\n")
            np.savetxt(f, rows, fmt="%d")
            w(f"\nCELL_TYPES {ncell}\n")
            np.savetxt(f, np.full(ncell, 12), fmt="%d")
        _write_point_data(f, w, fields, pts.shape[0], binary)
    return path


def write_vtk(path: str, mesh, fields: dict, binary: bool = True) -> str:
    """The structured file on a box mesh, the unstructured one on an
    imported mesh."""
    write = (write_vtk_structured if hasattr(mesh, "nc")
             else write_vtk_unstructured)
    return write(path, mesh, fields, binary)


def save_point_cloud(path: str, points: np.ndarray, values,
                     cols=(0, 2), mode: str = "w") -> str:
    """Text dump of `x,z,u` rows (columns `cols` of the points, then the
    values), the reference's pressure-field snapshots, to a chosen path.
    `mode='a'` appends; the default overwrites."""
    values = to_host(values)
    data = np.column_stack([points[:, c] for c in cols] + [values])
    with open(path, mode) as f:
        np.savetxt(f, data, fmt="%.8f", delimiter=",")
    return path


# ---------------------------------------------------------------------------
# Checkpoint / resume in the JAX package's npz format
# ---------------------------------------------------------------------------

def save_checkpoint(path: str, state, step: int, meta: dict | None = None
                    ) -> str:
    """Write a state (u, v, ku, kv, t) as npz: a one-rank state, or a
    sharded run's collected global fields.  Written to a temporary file
    and renamed, so a crash mid-write leaves the last checkpoint whole."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    tmp = path + ".tmp.npz"
    u, v, ku, kv, t = state
    np.savez(tmp, u=to_host(u), v=to_host(v), ku=to_host(ku),
             kv=to_host(kv), t=np.asarray(float(t)), step=step,
             meta=json.dumps(meta or {}))
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str):
    """(arrays {u, v, ku, kv, t}, step, meta) of an npz checkpoint of
    either package; `state_from_checkpoint` makes a model's state of it."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: _from_raw_bf16(z[k])
                  for k in ("u", "v", "ku", "kv", "t")}
        step = int(z["step"])
        meta = json.loads(str(z["meta"]))
    return arrays, step, meta


def state_from_checkpoint(model, arrays):
    """The state of `arrays` (u, v, ku, kv, t: a dict of
    `load_checkpoint`, or a tuple) in `model`'s layout, dtype and device:
    a one-rank model's grid-shaped fields, or a sharded model's block of
    this rank."""
    from fustpu_torch import convert

    if isinstance(arrays, dict):
        arrays = tuple(arrays[k] for k in ("u", "v", "ku", "kv", "t"))
    fields = [np.asarray(a) for a in arrays[:4]]
    t = float(np.asarray(arrays[4]))
    if hasattr(model, "split_state"):        # a rank of a sharded model
        return model.split_state((*fields, t))
    g = model.mesh.grid_shape
    return convert.state_from_fustpu(
        tuple(a.reshape(g) for a in fields) + (t,), model.dtype,
        model.device)


class Checkpointer:
    """Saves of a state that do not hold the solve.  `save` snapshots the
    fields on their device (one copy each, queued on the current stream)
    and hands them to a writer thread, which copies them into pinned host
    memory on a side stream that waits for the snapshot, then
    `torch.save`s ``step_<step>.pt`` through a temporary file.
    `async_save=False` does all of it before `save` returns.  The JAX
    package's `OrbaxCheckpointer` API: `save`, `wait`, `steps`,
    `restore(step, like)`."""

    def __init__(self, directory: str, async_save: bool = True):
        self.dir = Path(directory).resolve()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.async_save = async_save
        self._threads: list[threading.Thread] = []
        self._errors: list[BaseException] = []
        self._streams: dict = {}

    def _path(self, step: int) -> Path:
        return self.dir / f"step_{step:010d}.pt"

    @staticmethod
    def _to_host(fields, snapped, side):
        """The host copies of the snapshot `fields`: through pinned memory
        on the `side` stream, after the `snapped` event."""
        if snapped is None:
            return fields
        with torch.cuda.device(fields[0].device), torch.cuda.stream(side):
            side.wait_event(snapped)
            out = []
            for f in fields:
                h = torch.empty(f.shape, dtype=f.dtype, pin_memory=True)
                out.append(h.copy_(f, non_blocking=True))
            side.synchronize()
        return out

    def _write(self, fields, snapped, side, t: float, step: int) -> None:
        try:
            u, v, ku, kv = self._to_host(fields, snapped, side)
            path = self._path(step)
            tmp = path.with_name(f".{path.name}.tmp")
            torch.save({"u": u, "v": v, "ku": ku, "kv": kv, "t": t,
                        "step": step}, tmp)
            os.replace(tmp, path)
        except Exception as e:  # re-raised by wait()
            self._errors.append(e)

    def save(self, state, step: int) -> str:
        """Queue (async) or make a save of `state` at `step`; returns the
        path the save completes at."""
        fields = tuple(f.detach().clone() for f in tuple(state)[:4])
        snapped = side = None
        dev = fields[0].device
        if dev.type == "cuda":
            snapped = torch.cuda.Event()
            snapped.record()
            if dev not in self._streams:
                self._streams[dev] = torch.cuda.Stream(dev)
            side = self._streams[dev]
        args = (fields, snapped, side, float(state[4]), step)
        if self.async_save:
            th = threading.Thread(target=self._write, args=args,
                                  daemon=True)
            th.start()
            self._threads.append(th)
        else:
            self._write(*args)
            self._raise()
        return str(self._path(step))

    def _raise(self) -> None:
        if self._errors:
            err, self._errors = self._errors[0], []
            raise RuntimeError("checkpoint save failed") from err

    def wait(self) -> None:
        """Block until every queued save is on disk; raises if one
        failed."""
        for th in self._threads:
            th.join()
        self._threads = []
        self._raise()

    def steps(self) -> list[int]:
        """Steps of the completed saves (an unfinished one is still a
        temporary file and not listed)."""
        out = []
        for p in self.dir.glob("step_*.pt"):
            s = p.stem.split("_", 1)[1]
            if s.isdigit():
                out.append(int(s))
        return sorted(out)

    def restore(self, step: int | None = None, like=None):
        """(state, step) of the save at `step` (default: the latest).
        With `like` (a state), the fields take its dtype and device;
        otherwise they are host tensors."""
        from fustpu_torch.models.timestepping import RKState

        if step is None:
            step = self.steps()[-1]
        d = torch.load(self._path(step), map_location="cpu",
                       weights_only=True)
        fields = [d[k] for k in ("u", "v", "ku", "kv")]
        if like is not None:
            fields = [f.to(device=g.device, dtype=g.dtype)
                      for f, g in zip(fields, tuple(like)[:4])]
        return RKState(*fields, float(d["t"])), int(d["step"])
