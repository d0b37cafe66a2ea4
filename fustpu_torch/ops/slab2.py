"""The two-slab structured stiffness operator: host build, pair maps and
plain versions.  Counterpart of ``build_slab2`` / ``build_slab2w`` in
``fustpu/ops/pallas_stiffness.py`` (:292, :496), in the port's layout.

Both compute the operator of the structured kernel (any per-cell
coefficient folded into G) with the x-slabs of cells taken in pairs:

- slab2 pairs adjacent slabs (2q, 2q + 1);
- slab2w pairs far slabs (i, ncx2 + i), ncx2 = ceil(ncx / 2): two sweeps,
  over the first and the second half of the slabs, that meet at a seam,
  the grid plane ncx2 P, where their outputs overlap-add.

An odd ncx leaves one slab without a partner: the ghost, -1 in the maps
(the JAX package pads it with a zero-G slab).  G stays (cells, 6, n^3)
as ``cuda_stiffness.pack_G`` makes it; the TPU's lane halves and lane
padding do not carry over.  The kernel (``ops/cuda_slab2``) takes one pair
of cells a block, so the op also holds that block -> (cell a, cell b)
table, grouped into scatter classes whose blocks share no node.

The plain versions apply the operator pair by pair in the pairing's
order, each slab pair on its own sub-box, and add the slabs' outputs into
the grid; the far pairing adds its seam explicitly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fustpu_torch.ops import cuda_stiffness as cs


class Slab2Stiffness(NamedTuple):
    """The two-slab operator in the kernel layout, on one device."""

    G: torch.Tensor                  # (cells, 6, n^3), coefficient folded in
    D: torch.Tensor                  # (n, n) D[q, i] = l_i'(x_q)
    nc: tuple                        # cells per axis
    far: bool                        # far pairing (slab2w), else adjacent
    slabs: np.ndarray                # (ncx2, 2) slab pairs, -1 the ghost
    pairs: torch.Tensor              # (blocks, 2) int32 cells, by class
    bounds: tuple                    # class boundaries into `pairs`

    @property
    def P(self) -> int:
        return self.D.shape[0] - 1

    @property
    def cell_op(self) -> cs.CellStiffness:
        """The same operator for the single-slab kernel, same buffers."""
        return cs.CellStiffness(G=self.G, D=self.D, nc=self.nc)


def slab_pairs(ncx: int, far: bool) -> np.ndarray:
    """(ncx2, 2) x-slab pairs in the pairing's order: (2q, 2q + 1), or
    (q, ncx2 + q) for the far pairing; -1 where ncx is odd (the ghost)."""
    ncx2 = -(-ncx // 2)
    q = np.arange(ncx2)
    second = ncx2 + q if far else 2 * q + 1
    first = q if far else 2 * q
    return np.stack([first, np.where(second < ncx, second, -1)], axis=1)


def slab_colours(slabs: np.ndarray) -> np.ndarray:
    """Greedy colours of the slab pairs, in order, such that two pairs of
    one colour hold no slabs within one of each other (no shared grid
    plane): 2 for adjacent pairing; for far pairing the pairs form a cycle
    through the seam (slab ncx2 - 1 touches slab ncx2), so an odd count
    takes 3."""
    colour = np.zeros(len(slabs), np.int64)
    for q, sq in enumerate(slabs):
        near = {colour[p] for p, sp in enumerate(slabs[:q])
                if any(abs(a - b) <= 1 for a in sp if a >= 0
                       for b in sq if b >= 0)}
        colour[q] = min(set(range(len(slabs) + 1)) - near)
    return colour


def pair_table(slabs: np.ndarray, nc) -> tuple[np.ndarray, tuple]:
    """(pairs, bounds): the kernel's block -> (cell a, cell b) table, one
    block for each slab pair and (b, c) column (cell = (a ncy + b) ncz + c,
    -1 for the ghost), grouped into scatter classes (the slab pair's colour
    and the parities of b and c: no two blocks of a class share a node),
    stable within a class; and the class boundaries."""
    _, ncy, ncz = nc
    q, b, c = (a.ravel() for a in np.meshgrid(
        np.arange(len(slabs)), np.arange(ncy), np.arange(ncz),
        indexing="ij"))
    cell = lambda s: np.where(s >= 0, (s * ncy + b) * ncz + c, -1)
    table = np.stack([cell(slabs[q, 0]), cell(slabs[q, 1])], axis=1)
    key = (slab_colours(slabs)[q] * 2 + b % 2) * 2 + c % 2
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=int(key.max()) + 1)
    bounds = tuple(int(v) for v in np.cumsum(np.concatenate([[0], counts])))
    return table[order].astype(np.int32), bounds


def with_pairing(op: cs.CellStiffness, far: bool) -> Slab2Stiffness:
    """The two-slab operator on the buffers of the single-slab operator
    `op` (G and D shared), with the pairing's maps."""
    nc = tuple(int(v) for v in op.nc)
    slabs = slab_pairs(nc[0], far)
    pairs, bounds = pair_table(slabs, nc)
    return Slab2Stiffness(G=op.G, D=op.D, nc=nc, far=far, slabs=slabs,
                          pairs=torch.as_tensor(pairs, device=op.G.device),
                          bounds=bounds)


def from_host(nc, G: np.ndarray, D_1d: np.ndarray, dtype: torch.dtype,
              device, far: bool) -> Slab2Stiffness:
    """Upload kernel-layout host data (G (cells, 6, n^3), coefficient
    folded in) with the pairing's maps."""
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                  device=device)
    return with_pairing(cs.CellStiffness(G=t(G), D=t(D_1d), nc=tuple(nc)),
                        far)


def _deriv(D_1d: np.ndarray, P: int) -> np.ndarray:
    D_1d = np.asarray(D_1d, np.float64)
    if D_1d.shape != (P + 1, P + 1):
        raise ValueError(f"D of shape {D_1d.shape} for degree {P}")
    return D_1d


def build_slab2(nc, P: int, D_1d: np.ndarray, G_cells: np.ndarray, dtype,
                coeff: np.ndarray | None = None,
                device="cuda") -> Slab2Stiffness:
    """Adjacent pairing, from the host metric G_cells (cells, n^3, 6) and
    an optional per-cell coefficient, as ``spectral_mm.build_stiffness``
    takes them."""
    return from_host(nc, cs.pack_G(G_cells, coeff), _deriv(D_1d, P), dtype,
                     device, far=False)


def build_slab2w(nc, P: int, D_1d: np.ndarray, G_cells: np.ndarray, dtype,
                 coeff: np.ndarray | None = None,
                 device="cuda") -> Slab2Stiffness:
    """Far pairing, with the inputs of `build_slab2`."""
    return from_host(nc, cs.pack_G(G_cells, coeff), _deriv(D_1d, P), dtype,
                     device, far=True)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _slabs_apply(op: Slab2Stiffness, x: torch.Tensor, a0: int,
                 a1: int) -> torch.Tensor:
    """The operator of x-slabs [a0, a1) alone on their grid planes
    [a0 P, a1 P]."""
    P = op.P
    ncx, ncy, ncz = op.nc
    per = ncy * ncz
    sub = cs.CellStiffness(G=op.G[a0 * per:a1 * per], D=op.D,
                           nc=(a1 - a0, ncy, ncz))
    return cs.stiffness_plain(sub, x[a0 * P:a1 * P + 1])


def slab2_plain(op: Slab2Stiffness, x: torch.Tensor) -> torch.Tensor:
    """Plain version of `cuda_slab2.slab2`: pair by pair, each pair of
    adjacent slabs (one slab for the ghost's pair) added into its planes."""
    if op.far:
        raise ValueError("slab2_plain: a far-paired operator (slab2w_plain)")
    P = op.P
    y = torch.zeros_like(x)
    for a, b in op.slabs:
        end = a + (2 if b >= 0 else 1)
        y[a * P:end * P + 1] += _slabs_apply(op, x, a, end)
    return y


def slab2w_plain(op: Slab2Stiffness, x: torch.Tensor) -> torch.Tensor:
    """Plain version of `cuda_slab2.slab2w`: pair by pair, slab q into the
    first sweep's planes [0, ncx2 P] and slab ncx2 + q into the second's
    [ncx2 P, ncx P]; then the seam, where the first sweep's last plane and
    the second's first are one grid plane, overlap-adds."""
    if not op.far:
        raise ValueError("slab2w_plain: an adjacent-paired operator "
                         "(slab2_plain)")
    P = op.P
    ncx2 = len(op.slabs)
    seam = ncx2 * P
    first = x.new_zeros((seam + 1, *x.shape[1:]))
    second = x.new_zeros((x.shape[0] - seam, *x.shape[1:]))
    for q, (a, b) in enumerate(op.slabs):
        first[q * P:(q + 1) * P + 1] += _slabs_apply(op, x, a, a + 1)
        if b >= 0:
            second[(q * P):(q + 1) * P + 1] += _slabs_apply(op, x, b, b + 1)
    return torch.cat([first[:seam], (first[seam] + second[0])[None],
                      second[1:]])
