"""The set-up kernels on the card: the hand-written CUDA kernels of
``fustpu_torch/csrc/setup.cu``, their wrappers, their launch counters, and
the mesh-level set-up that a model built on the card runs with them.

Counterpart of the JAX package's native set-up runtime
(``native/fustpu_native.cpp`` through ``fustpu/native_bindings.py``:
`cell_geometry`, `facet_geometry`, `box_dofmap`, `mass_diagonal`), which
that package calls from ``fustpu/ops/precompute.py`` on the host:

- `cell_geometry`: detJ (cells, nq) and, with `with_G`, the metric G
  (cells, nq, 6) of cells with trilinear (8) or hex27 (27) geometry dofs;
- `facet_geometry`: detJ_f (nf, n^2) of (cell, local facet) pairs;
- `box_dofmap`: the dofmap rows of given cells of a box (only the rows a
  caller needs, never the whole dofmap);
- `mass_diagonal_box` / `mass_diagonal_map`: an assembled diagonal, the sum
  of per-point values over each node, on a box by the box's own layout
  and on any mesh through an inverse map (`inverse_map`, the pos / ptr
  layout of the engine's scatter); deterministic, no atomics.

All in float64.  A wrapper given CPU tensors runs the plain version, the
numpy functions of ``fustpu_torch.ops.precompute``, ``mesh.box`` and
``ops.spectral_mm`` (the port's host set-up).  Given CUDA tensors it
launches the kernel or raises: there is no fallback.  Each wrapper counts
its launches in `launches`, where it launches; the kernels launch through
the lean path of ``fustpu_torch.ops.launch``.

`CardGeometry` holds a mesh's geometry inputs on the card: the geometry
dofs of the congruence representatives where that dedup pays
(``precompute.congruence_groups``, on the host, as the plain version
runs it) and the map back to every cell, which the card indexes out.
"""

from __future__ import annotations

import numpy as np
import torch

from fustpu_torch.mesh.box import dofmap_rows
from fustpu_torch.ops import launch
from fustpu_torch.ops import precompute as pre
from fustpu_torch.ops import spectral_mm as mm

# Launches of each kernel (form), not counting the plain version.
launches = {"setup_cell_geometry": 0, "setup_cell_detJ": 0,
            "setup_facet_geometry": 0, "setup_box_dofmap": 0,
            "setup_mass_diagonal_box": 0, "setup_mass_diagonal_map": 0}

F64 = torch.float64
GEOMETRY_DOFS = (8, 27)        # trilinear, hex27


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(name: str, *tensors) -> torch.device:
    """Each (tensor, dtype, shape, what) on one CUDA device, of its dtype
    and shape, contiguous; returns the device."""
    dev = tensors[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel: tensor on {dev}, expected a CUDA "
                         "device")
    for t, dtype, shape, what in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name} kernel: {what} is {t.dtype} on "
                             f"{t.device}, expected {dtype} on {dev}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} kernel: {what} has shape "
                             f"{tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: {what} is not contiguous")
    return dev


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


def _launch(name: str, counter: str, dev: torch.device, *args) -> None:
    launch.launch(f"fustpu_setup_{name}", dev.index, *args)
    launches[counter] += 1


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def cell_geometry(gdofs: torch.Tensor, grads: torch.Tensor,
                  wts: torch.Tensor, with_G: bool = True):
    """(detJ (cells, nq), G (cells, nq, 6) or None without `with_G`) of
    cells with geometry dofs `gdofs` (cells, ng, 3), reference gradients
    `grads` (nq, ng, 3) and weights `wts` (nq,), float64, through
    `cell_geometry` (the plain version ``precompute.geometry_of`` /
    ``detJ_of`` for CPU tensors)."""
    if gdofs.device.type == "cpu":
        a = (gdofs.numpy(), grads.numpy(), wts.numpy())
        if with_G:
            return tuple(map(torch.from_numpy, pre.geometry_of(*a)))
        return torch.from_numpy(pre.detJ_of(*a)), None
    cells, ng = gdofs.shape[0], gdofs.shape[1]
    nq = wts.shape[0]
    if ng not in GEOMETRY_DOFS:
        raise ValueError(f"cell_geometry kernel: {ng} geometry dofs a cell, "
                         f"expected one of {GEOMETRY_DOFS}")
    dev = _check("cell_geometry", (gdofs, F64, (cells, ng, 3), "gdofs"),
                 (grads, F64, (nq, ng, 3), "grads"),
                 (wts, F64, (nq,), "wts"))
    detJ = gdofs.new_empty((cells, nq))
    G = gdofs.new_empty((cells, nq, 6)) if with_G else None
    # the kernel reads the table transposed, (ng x 3, nq): a warp's points
    # read each entry as one coalesced run
    gt = grads.reshape(nq, ng * 3).t().contiguous()
    _launch("cell_geometry",
            "setup_cell_geometry" if with_G else "setup_cell_detJ", dev,
            gdofs.data_ptr(), gt.data_ptr(), wts.data_ptr(), cells, nq,
            ng, int(with_G), detJ.data_ptr(), _ptr(G))
    return detJ, G


def facet_geometry(gdofs: torch.Tensor, fgrads: torch.Tensor,
                   wts: torch.Tensor, bd: torch.Tensor) -> torch.Tensor:
    """detJ_f (nf, n^2) of the (cell, local facet) pairs `bd` (nf, 2) of
    cells with geometry dofs `gdofs` (cells, ng, 3), reference gradients
    `fgrads` (6, n^2, ng, 3) at each local facet's points and weights
    `wts` (n^2,), through `facet_geometry` (the plain version
    ``precompute.facet_geometry_of`` for CPU tensors)."""
    if gdofs.device.type == "cpu":
        return torch.from_numpy(pre.facet_geometry_of(
            gdofs.numpy(), fgrads.numpy(), wts.numpy(), bd.numpy()))
    cells, ng = gdofs.shape[0], gdofs.shape[1]
    nf, nq = bd.shape[0], wts.shape[0]
    if ng not in GEOMETRY_DOFS:
        raise ValueError(f"facet_geometry kernel: {ng} geometry dofs a "
                         f"cell, expected one of {GEOMETRY_DOFS}")
    dev = _check("facet_geometry", (gdofs, F64, (cells, ng, 3), "gdofs"),
                 (fgrads, F64, (6, nq, ng, 3), "fgrads"),
                 (wts, F64, (nq,), "wts"),
                 (bd, torch.int64, (nf, 2), "bd"))
    out = gdofs.new_empty((nf, nq))
    _launch("facet_geometry", "setup_facet_geometry", dev, gdofs.data_ptr(),
            fgrads.data_ptr(), wts.data_ptr(), bd.data_ptr(), nf, nq, ng,
            out.data_ptr())
    return out


def box_dofmap(cells: torch.Tensor, nc, P: int) -> torch.Tensor:
    """(len(cells), n^3) int32 dofmap rows of the given cells (int64) of a
    box of `nc` cells at degree P through `box_dofmap` (the plain version
    ``mesh.box.dofmap_rows`` for a CPU tensor)."""
    if cells.device.type == "cpu":
        return torch.from_numpy(dofmap_rows(nc, P, cells.numpy()))
    ncx, ncy, ncz = (int(c) for c in nc)
    if (ncx * P + 1) * (ncy * P + 1) * (ncz * P + 1) >= 2 ** 31:
        raise ValueError("box_dofmap kernel: the dofs pass int32")
    m = cells.shape[0]
    dev = _check("box_dofmap", (cells, torch.int64, (m,), "cells"))
    out = cells.new_empty((m, (P + 1) ** 3), dtype=torch.int32)
    _launch("box_dofmap", "setup_box_dofmap", dev, cells.data_ptr(), m, ncy,
            ncz, P, out.data_ptr())
    return out


def mass_diagonal_box(detJ: torch.Tensor, coeff: torch.Tensor | None, nc,
                      P: int) -> torch.Tensor:
    """The assembled (gx, gy, gz) diagonal sum of detJ[c, q] coeff[c] (unit
    coefficients without `coeff`) over a box of `nc` cells at degree P
    through `mass_diagonal_box` (the plain version
    ``spectral_mm.mass_diagonal`` for CPU tensors, bitwise the kernel's)."""
    ncx, ncy, ncz = (int(c) for c in nc)
    cells, nq = ncx * ncy * ncz, (P + 1) ** 3
    shape = (ncx * P + 1, ncy * P + 1, ncz * P + 1)
    if detJ.device.type == "cpu":
        c = None if coeff is None else coeff.numpy().reshape(nc)
        return torch.from_numpy(mm.mass_diagonal(nc, P, detJ.numpy(), c))
    need = [(detJ, F64, (cells, nq), "detJ")]
    if coeff is not None:
        need.append((coeff, F64, (cells,), "coeff"))
    dev = _check("mass_diagonal_box", *need)
    out = detJ.new_empty(shape)
    _launch("mass_diagonal_box", "setup_mass_diagonal_box", dev,
            detJ.data_ptr(), _ptr(coeff), ncx, ncy, ncz, P, out.data_ptr())
    return out


def inverse_map(dofmap: torch.Tensor, ndofs: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(pos, ptr) of `dofmap` on its device: for each dof d, the positions
    p with dofmap.ravel()[p] == d in ascending order, pos[ptr[d]:ptr[d +
    1]] (int32 CSR; ``cuda_engine.inverse_map``'s layout, by a stable sort
    and a count)."""
    g = dofmap.reshape(-1).long()
    if g.numel() >= 2 ** 31:
        raise ValueError(f"{g.numel()} positions: the int32 inverse map "
                         "holds fewer than 2^31")
    pos = torch.argsort(g, stable=True).to(torch.int32)
    ptr = torch.zeros(ndofs + 1, dtype=torch.int64, device=g.device)
    torch.cumsum(torch.bincount(g, minlength=ndofs), 0, out=ptr[1:])
    return pos, ptr.to(torch.int32)


def mass_diagonal_map(vals: torch.Tensor, coeff: torch.Tensor | None,
                      nq: int, pos: torch.Tensor,
                      ptr: torch.Tensor) -> torch.Tensor:
    """The (ndofs,) sum, for each dof, of vals[p] coeff[p // nq] (vals[p]
    without `coeff`) over its positions p in ascending order, through the
    inverse map (pos, ptr) and `mass_diagonal_map` (for CPU tensors the
    plain version, numpy's bincount in the same order, bitwise the
    kernel's)."""
    ndofs = ptr.shape[0] - 1
    if vals.device.type == "cpu":
        p = pos.numpy().astype(np.int64)
        v = vals.numpy()[p]
        if coeff is not None:
            v = v * coeff.numpy()[p // nq]
        dof = np.repeat(np.arange(ndofs), np.diff(ptr.numpy()))
        return torch.from_numpy(np.bincount(dof, v, minlength=ndofs))
    need = [(vals, F64, (pos.shape[0],), "vals"),
            (pos, torch.int32, (vals.shape[0],), "pos"),
            (ptr, torch.int32, (ndofs + 1,), "ptr")]
    if coeff is not None:
        need.append((coeff, F64, (vals.shape[0] // nq,), "coeff"))
    dev = _check("mass_diagonal_map", *need)
    out = vals.new_empty(ndofs)
    _launch("mass_diagonal_map", "setup_mass_diagonal_map", dev,
            vals.data_ptr(), _ptr(coeff), nq, pos.data_ptr(),
            ptr.data_ptr(), ndofs, out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# A mesh's set-up on the card
# ---------------------------------------------------------------------------

def _f64(a, device) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a, np.float64), device=device)


class CardGeometry:
    """A mesh's cell geometry inputs on `device`: the geometry dofs of the
    congruence representatives (trilinear meshes of more than 4096 cells
    where ``precompute.congruence_groups`` finds few shapes) or of every
    cell, the representative of every cell (`inv`, None without dedup),
    the reference gradients at the quadrature points and the weights."""

    def __init__(self, mesh, device):
        elem = mesh.element
        gdofs, grads = pre._geom_dofs_grads(mesh, elem.quad_points)
        curved = getattr(mesh, "geom_nodes", None) is not None
        self.inv = None
        if not curved and gdofs.shape[0] > 4096:
            grp = pre.congruence_groups(gdofs)
            if grp is not None:
                inv, rep = grp
                gdofs = gdofs[rep]
                self.inv = torch.as_tensor(inv, device=device)
        self.gdofs = _f64(gdofs, device)
        self.grads = _f64(grads, device)
        self.wts = _f64(elem.quad_weights, device)

    def to(self, device) -> "CardGeometry":
        """These inputs on `device` (in place; e.g. after a model saved
        from the card was loaded onto the CPU)."""
        for name in ("gdofs", "grads", "wts", "inv"):
            t = getattr(self, name)
            if t is not None:
                setattr(self, name, t.to(device))
        return self

    def _cells(self, a: torch.Tensor) -> torch.Tensor:
        return a if self.inv is None else a[self.inv]

    def detJ(self) -> torch.Tensor:
        """(cells, nq) float64 on the card."""
        return self._cells(cell_geometry(self.gdofs, self.grads, self.wts,
                                         with_G=False)[0])

    def metric(self) -> torch.Tensor:
        """G (cells, nq, 6) float64 on the card."""
        return self._cells(cell_geometry(self.gdofs, self.grads,
                                         self.wts)[1])


def mesh_facet_geometry(mesh, bd: np.ndarray, device) -> torch.Tensor:
    """detJ_f (nf, n^2) float64 on `device` of the (cell, local facet)
    pairs `bd` of `mesh`: only the facet cells' geometry dofs go to the
    card."""
    bd = np.asarray(bd, np.int64).reshape(-1, 2)
    gdofs, fgrads = pre.facet_grads(mesh)
    local = np.stack([np.arange(bd.shape[0]), bd[:, 1]], axis=1)
    return facet_geometry(_f64(gdofs[bd[:, 0]], device), _f64(fgrads, device),
                          _f64(mesh.element.facet_quad_weights, device),
                          torch.as_tensor(local, device=device))


def box_facet_dofmap(mesh, bd: np.ndarray, device) -> torch.Tensor:
    """(nf, n^2) int64 global dofs of the (cell, local facet) pairs `bd` of
    a box mesh on `device`: the facet cells' dofmap rows (`box_dofmap`),
    then each facet's local dofs."""
    bd = np.asarray(bd, np.int64).reshape(-1, 2)
    rows = box_dofmap(torch.as_tensor(bd[:, 0], device=device), mesh.nc,
                      mesh.degree)
    local = torch.as_tensor(
        mesh.element.all_facet_dofs[bd[:, 1]].astype(np.int64), device=device)
    return rows.long().gather(1, local)
