"""The window cost of a flat gather-index stream, host-only numpy: the
criterion by which `fustpu_torch.mesh.unstructured.locality_order` picks a
cell order for an imported non-prismatic mesh.

The criterion is the TPU gather/scatter engine's: ``fustpu/ops/
pallas_gather.py`` covers each tile of TM consecutive indices with one or
two windows of WR x 128 ids, and `build_plan` sizes WR and the window count
by an attempt ladder, leaving any index outside the windows to a spill
path.  The port has no such engine (the card gathers and scatters through
the dofmap directly), but it keeps the criterion so that both packages
order an imported mesh identically, and so number its dofs identically.
The same sweep also keeps consecutive cells' dofs close together, which
helps the card's L2; whether a GPU-specific order does better is not
measured.

Vendored from ``fustpu/ops/pallas_gather.py``: `pick_wr` (:268),
`pick_wr2` (:292), `_densest` (:319), `_attempt_ladder` (:329) and the tile
loop of `build_plan` (:347-427), which `window_cost` runs without building
the plan's code streams.  TM is fixed at the JAX package's default 2048.
"""

from __future__ import annotations

import numpy as np

TM = 2048


def pick_wr(g: np.ndarray, lo: int = 64, hi: int = 512,
            dead: int | None = None, tm: int = TM) -> int:
    """Smallest window row count (multiple of 8) whose single window holds
    the worst tile span; `dead` ids are excluded from spans."""
    spans = [0]
    for s in range(0, g.size, tm):
        blk = g[s:s + tm]
        if dead is not None:
            blk = blk[blk != dead]
        if blk.size:
            spans.append(int(blk.max()) - int(blk.min()))
    # the start is floored to an 8-row boundary and the top id can
    # straddle one extra 128-id row
    need = int(np.max(spans)) // 128 + 10
    wr = -(-need // 8) * 8
    return int(min(max(wr, lo), hi))


def pick_wr2(g: np.ndarray, lo: int = 16, hi: int = 512,
             dead: int | None = None, tm: int = TM) -> int:
    """Window row count for two-window plans: each tile's ids split at
    their largest gap, and WR holds the worse of the two clusters."""
    rows = [1]
    for s in range(0, g.size, tm):
        blk = g[s:s + tm]
        if dead is not None:
            blk = blk[blk != dead]
        if blk.size < 2:
            continue
        ids = np.sort(blk)
        gaps = np.diff(ids)
        k = int(np.argmax(gaps))
        span = max(int(ids[k]) - int(ids[0]),
                   int(ids[-1]) - int(ids[k + 1]))
        rows.append(span // 128 + 10)
    wr = -(-max(rows) // 8) * 8
    return int(min(max(wr, lo), hi))


def _densest(sorted_ids: np.ndarray, WSZ: int) -> int:
    """8-row-aligned window start covering the most of `sorted_ids`."""
    hi_cnt = np.searchsorted(sorted_ids, sorted_ids + WSZ - 1024,
                             side="right")
    best = int(np.argmax(hi_cnt - np.arange(sorted_ids.size)))
    return (int(sorted_ids[best]) // (8 * 128)) * 8


def _attempt_ladder(wr1: int, wr2: int) -> list[tuple[int, int]]:
    """(nwin, WR) candidates, cheapest preferred (build_plan's automatic
    window count)."""
    attempts = [(1, wr1), (2, wr2)] \
        + ([(2, 2 * wr2)] if 2 * wr2 < wr1 else []) \
        + ([(2, wr1)] if wr1 > wr2 else [])
    if 2 * wr2 < 0.6 * wr1:
        attempts = attempts[1:] + attempts[:1]
    return attempts


def window_cost(indices: np.ndarray, nsrc: int, spill_tol: float = 0.005,
                tm: int = TM) -> tuple[int, int, int]:
    """(WR, nwin, spills) of the plan `build_plan(indices, nsrc)` would
    build: the first rung of the attempt ladder whose spill count is at
    most `spill_tol` of the indices, or the last rung.  Index `nsrc` is a
    dead slot that needs no window."""
    g = np.asarray(indices, np.int64).reshape(-1)
    N = g.size
    attempts = _attempt_ladder(pick_wr(g, dead=nsrc, tm=tm),
                               pick_wr2(g, dead=nsrc, tm=tm))
    ntiles = -(-(N + 1) // tm)
    gp = np.full(ntiles * tm, nsrc, np.int64)
    gp[:N] = g
    for nwin, WR in attempts:
        WSZ = WR * 128
        spills = 0
        for t in range(ntiles):
            blk = gp[t * tm:(t + 1) * tm]
            isdead = blk == nsrc
            real = blk[~isdead]
            if real.size == 0:
                s = 0
            elif int(real.max()) - int(real.min()) < WSZ:
                s = (int(real.min()) // (8 * 128)) * 8
            else:
                s = _densest(np.sort(real), WSZ)
            rel = blk - s * 128
            ok = (rel >= 0) & (rel < WSZ) & ~isdead
            if nwin == 2:
                rest = np.sort(blk[~ok & ~isdead])
                s2 = s
                if rest.size:
                    s2 = (_densest(rest, WSZ)
                          if int(rest[-1]) - int(rest[0]) >= WSZ
                          else (int(rest[0]) // (8 * 128)) * 8)
                rel2 = blk - s2 * 128
                ok = ok | (~isdead & (rel2 >= 0) & (rel2 < WSZ))
            nv = min(tm, N - t * tm)       # positions past N are padding
            spills += int(np.count_nonzero(~ok[:nv] & ~isdead[:nv]))
        if spills <= spill_tol * N:
            break
    return WR, nwin, spills
