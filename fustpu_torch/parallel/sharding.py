"""Domain decomposition of a box mesh over ranks of ``torch.distributed``.

One process per rank.  The box's cells are split into a (Sx, Sy, Sz) grid
of blocks (`RankGrid`); each rank holds its block's node grid *including*
the one node plane it shares with each neighbour (nodes on a cut plane are
stored on both sides).  After a local stiffness apply, `halo_sum` makes
the shared planes globally summed and consistent on every owner: along
each partitioned axis, one ``all_reduce`` of a buffer in which every rank
writes its two boundary planes into the slots of its two cuts.  Every
owner then holds the bitwise-identical sum, so every diagonal (mass-type)
update afterwards keeps the planes consistent: one exchange per RK stage.

Counterpart of ``fustpu/parallel/sharding.py``.  There, `halo_sum` is a
``ppermute`` pair per axis inside ``shard_map``; here the exchange is one
``all_reduce`` per axis whose slots are keyed by (cut, transverse block):
a slot holds the planes of the two ranks on either side of one cut within
one transverse block, and zeros from every other rank, so the sum is the
``ppermute`` pair's.  (Slots in global transverse coordinates would merge
the partial sums of transverse neighbours into the edge nodes they share,
which the next axis's pass would then count again.)  The axes go one after
another, so edge and corner nodes shared by 4 or 8 ranks sum once.

Cells that do not divide the grid give blocks of different sizes: block b
along an axis holds cells [b L, min((b + 1) L, nc)), L = ceil(nc / S), the
JAX package's partition without its zero-coefficient ghost cells.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass
class RankGrid:
    """A (Sx, Sy, Sz) grid of ranks over the box partition: the calling
    rank, the device its tensors live on, the process group (None: the
    default group) and `ranks`, the (Sx, Sy, Sz) array of the rank that
    holds each block (default: ranks in C order).  A model on an imported
    mesh reads only `size` and `rank` (its parts are the grid's ranks).
    ``multihost.rank_grid`` makes the calling rank's grid of a process
    group."""

    shape: tuple[int, int, int]
    rank: int
    device: torch.device
    group: object = None
    ranks: np.ndarray = None

    def __post_init__(self):
        self.shape = tuple(int(s) for s in self.shape)
        self.device = torch.device(self.device)
        if self.ranks is None:
            self.ranks = np.arange(self.size).reshape(self.shape)

    def coords_of(self, rank: int) -> tuple[int, int, int]:
        """The block coordinates of `rank`."""
        return tuple(int(c) for c in np.argwhere(self.ranks == rank)[0])

    @property
    def coords(self) -> tuple[int, int, int]:
        return self.coords_of(self.rank)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` in place over the group's ranks; returns it."""
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, obj) -> list:
        """Every rank's picklable `obj`, in rank order."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out


# ---------------------------------------------------------------------------
# The box partition, and host split / merge of node and cell fields
# ---------------------------------------------------------------------------

def block_cells(nc, S) -> list[list[tuple[int, int]]]:
    """Per axis, each block's cell range [lo, hi): L = ceil(nc / S) cells
    a block, the last ones fewer.  Raises if a block would be empty."""
    out = []
    for c, s in zip(nc, S):
        L = -(-c // s)
        rng = [(b * L, min((b + 1) * L, c)) for b in range(s)]
        if rng[-1][1] <= rng[-1][0]:
            raise ValueError(f"{c} cells cannot be split into {s} blocks "
                             f"of ceil({c}/{s}) = {L}: the last is empty")
        out.append(rng)
    return out


def node_slices(nc, S, degree: int, coords) -> tuple[slice, slice, slice]:
    """The global node-grid slices of the block at `coords` (its shared
    planes included)."""
    return tuple(slice(r[b][0] * degree, r[b][1] * degree + 1)
                 for r, b in zip(block_cells(nc, S), coords))


def cell_slices(nc, S, coords) -> tuple[slice, slice, slice]:
    """The cell-grid slices of the block at `coords`."""
    return tuple(slice(*r[b]) for r, b in zip(block_cells(nc, S), coords))


def _blocks(S):
    return [tuple(int(c) for c in np.unravel_index(r, S))
            for r in range(int(np.prod(S)))]


def split_node_field(x: np.ndarray, nc, S, degree: int) -> list[np.ndarray]:
    """(gx, gy, gz[, ...]) -> the blocks of ranks 0 .. Sx Sy Sz - 1, each
    with its shared planes."""
    return [np.ascontiguousarray(x[node_slices(nc, S, degree, b)])
            for b in _blocks(S)]


def merge_node_field(blocks, nc, S, degree: int) -> np.ndarray:
    """Inverse of split_node_field (overlapping planes agree when the
    blocks are consistent; the last writer wins)."""
    g = [c * degree + 1 for c in nc]
    out = np.empty((*g, *blocks[0].shape[3:]), dtype=blocks[0].dtype)
    for b, blk in zip(_blocks(S), blocks):
        out[node_slices(nc, S, degree, b)] = blk
    return out


def split_cell_field(arr: np.ndarray, nc, S) -> list[np.ndarray]:
    """A per-cell field (ncx, ncy, ncz[, ...]) or (cells[, ...]) in box
    cell order -> each rank's block, flat in its own box cell order."""
    a = np.asarray(arr)
    a = a.reshape(*nc, *a.shape[(3 if a.shape[:3] == tuple(nc) else 1):])
    return [np.ascontiguousarray(a[cell_slices(nc, S, b)]).reshape(
        -1, *a.shape[3:]) for b in _blocks(S)]


# ---------------------------------------------------------------------------
# The exchange
# ---------------------------------------------------------------------------

def halo_sum(y: torch.Tensor, grid: RankGrid, extents) -> torch.Tensor:
    """Sum the shared planes of the rank-local node block `y` (lgx, lgy,
    lgz) across neighbouring ranks along every partitioned axis, in place;
    afterwards the shared planes hold the full sum on every owner.
    `extents`: per axis, the largest block's node extent (the buffer's
    transverse slot size).  One ``all_reduce`` per partitioned axis."""
    for ax in range(3):
        S = grid.shape[ax]
        if S == 1:
            continue
        i = grid.coords[ax]
        o1, o2 = [a for a in range(3) if a != ax]
        n1, n2 = y.shape[o1], y.shape[o2]
        buf = torch.zeros((S - 1, grid.shape[o1], grid.shape[o2],
                           extents[o1], extents[o2]), dtype=y.dtype,
                          device=y.device)
        b1, b2 = grid.coords[o1], grid.coords[o2]
        lo, hi = y.select(ax, 0), y.select(ax, y.shape[ax] - 1)
        if i > 0:
            buf[i - 1, b1, b2, :n1, :n2] = lo
        if i < S - 1:
            buf[i, b1, b2, :n1, :n2] = hi
        grid.all_reduce(buf)
        if i > 0:
            lo.copy_(buf[i - 1, b1, b2, :n1, :n2])
        if i < S - 1:
            hi.copy_(buf[i, b1, b2, :n1, :n2])
    return y


# ---------------------------------------------------------------------------
# Distributed reductions
# ---------------------------------------------------------------------------

def ownership_weights(local_shape, grid: RankGrid,
                      dtype=torch.float64) -> torch.Tensor:
    """Per-node multiplicity weights of the rank-local block: a node on a
    cut plane is stored on both neighbours, so global reductions weight it
    by 1/2 per partitioned axis it sits on (1/4 on shared edges, 1/8 on
    shared corners); the outer planes of the box keep weight 1."""
    w = torch.ones(local_shape, dtype=dtype, device=grid.device)
    for ax in range(3):
        S = grid.shape[ax]
        if S == 1:
            continue
        i = grid.coords[ax]
        prof = torch.ones(local_shape[ax], dtype=dtype, device=grid.device)
        if i > 0:
            prof[0] = 0.5
        if i < S - 1:
            prof[-1] = 0.5
        shape = [1, 1, 1]
        shape[ax] = local_shape[ax]
        w = w * prof.reshape(shape)
    return w


def weighted_dot(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                 grid: RankGrid) -> float:
    """Distributed dot product of rank-local fields whose entries carry
    the multiplicity weights `w`: the weighted local sum, summed over the
    ranks."""
    s = torch.sum(x * y * w.to(x.dtype)).reshape(1).to(torch.float64)
    return float(grid.all_reduce(s)[0])


def global_dot(x: torch.Tensor, y: torch.Tensor, grid: RankGrid) -> float:
    """Distributed dot product of rank-local node blocks."""
    return weighted_dot(x, y, ownership_weights(x.shape, grid, x.dtype),
                        grid)


def global_norm(x: torch.Tensor, grid: RankGrid) -> float:
    return float(np.sqrt(global_dot(x, x, grid)))
