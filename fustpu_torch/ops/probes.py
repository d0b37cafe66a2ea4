"""Memory probes of the experiment demos: the hand-written CUDA kernels of
``fustpu_torch/csrc/probes.cu``, their wrappers and plain versions.

- `g_weighted_sum(G, c, nc, layout)` (counterpart of
  ``demos/exp_g_layout.py``'s `padded_sum` / `flat_sum`):
  out = c + sum_{cells along x, i, m} (1 + m) G[..., m, ...] on the
  (ncy n, ncz n) plane, reading G in the stiffness kernels' per-cell
  layout (``"cells"``: (cells, 6, n^3)) or component-major
  (``"components"``: (6, cells, n^3)).  The JAX probe's (ncx, n, 6, ey, ez)
  G is `to_cells(G)`.
- `relayout(x, kind)` (counterpart of ``demos/exp_mosaic_relayout.py``'s
  `probe`): the four permutations of that probe over tiles of (TM, 1):
  ``reshape`` to (TM / 128, 128) rows, its ``reverse``, the ``transpose``
  of each (TM / 128, 128) tile, and a ``copy``.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  Each kernel counts its calls in
`launches`.  `relayout_flat` runs the relayout's first design (a flat
one-vector-a-thread copy, a transpose through padded 32 x 32 tiles), kept
as the comparison and counted apart in `comparison_launches`.  Only the
experiment demos run them.  The relayouts launch through the lean path of
``fustpu_torch.ops.launch``.
"""

from __future__ import annotations

import torch

from fustpu_torch.ops import launch

LAYOUTS = ("cells", "components")
KINDS = ("reshape", "reverse", "transpose", "copy")
TM = 8192                          # the JAX probe's tile: (8192, 1)
LANES = 128

launches = {"g_layout_cells": 0, "g_layout_components": 0,
            "relayout_copy": 0, "relayout_transpose": 0}
comparison_launches = {"relayout_copy_flat": 0,
                       "relayout_transpose_padded": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def reset_launches() -> None:
    for counts in (launches, comparison_launches):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# The G layout probe
# ---------------------------------------------------------------------------

def to_cells(Gx: torch.Tensor, nc) -> torch.Tensor:
    """The JAX package's per-slab (ncx, n, 6, ncy n, ncz n) G (pack_G's
    layout, the G of exp_g_layout) -> the per-cell (cells, 6, n^3)."""
    ncx, ncy, ncz = nc
    n = Gx.shape[1]
    G = Gx.reshape(ncx, n, 6, ncy, n, ncz, n).permute(0, 3, 5, 2, 1, 4, 6)
    return G.reshape(ncx * ncy * ncz, 6, n ** 3).contiguous()


def to_layout(G: torch.Tensor, layout: str) -> torch.Tensor:
    """Per-cell (cells, 6, n^3) G in `layout`."""
    if layout == "cells":
        return G
    if layout == "components":
        return G.transpose(0, 1).contiguous()
    raise ValueError(f"layout {layout!r}: expected one of {LAYOUTS}")


def cells_view(G: torch.Tensor, nc, layout: str) -> torch.Tensor:
    """(ncx, ncy, ncz, 6, n, n, n) view of G in either layout."""
    n = round(G.shape[-1] ** (1 / 3))
    if layout == "components":
        G = G.transpose(0, 1)
    return G.reshape(*nc, 6, n, n, n)


def g_weighted_sum_plain(G: torch.Tensor, c: torch.Tensor, nc,
                         layout: str = "cells") -> torch.Tensor:
    """Plain version of `g_weighted_sum`: one einsum and an add."""
    Gv = cells_view(G, nc, layout)
    w = torch.arange(1, 7, dtype=G.dtype, device=G.device)
    s = torch.einsum("abcmijk,m->bjck", Gv, w)
    return c + s.reshape(c.shape)


def _chunks(ncx: int, cols: int, n: int) -> int:
    """The kernel's fixed split S of the x-cells: enough blocks for ~8 per
    SM of an H100's 132, never more chunks than cells along x."""
    cpb = 1 if n * n >= 256 else 256 // (n * n)
    col_blocks = -(-cols // cpb)
    return max(1, min(ncx, -(-8 * 132 // col_blocks)))


def g_weighted_sum(G: torch.Tensor, c: torch.Tensor, nc,
                   layout: str = "cells") -> torch.Tensor:
    """out = c + sum (1 + m) G over the x-cells, nodes along x and the six
    components m, on the (ncy n, ncz n) plane (the plain version for a
    CPU tensor)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: expected one of {LAYOUTS}")
    if G.device.type == "cpu":
        return g_weighted_sum_plain(G, c, nc, layout)
    from fustpu_torch import _build

    ncx, ncy, ncz = nc
    n = round(G.shape[-1] ** (1 / 3))
    cells = ncx * ncy * ncz
    shape = (cells, 6, n ** 3) if layout == "cells" else (6, cells, n ** 3)
    if G.dtype not in _SUFFIX or c.dtype != G.dtype:
        raise ValueError(f"g_layout kernel: G {G.dtype}, c {c.dtype} "
                         "(float32 or float64, the same)")
    if tuple(G.shape) != shape or tuple(c.shape) != (ncy * n, ncz * n):
        raise ValueError(f"g_layout kernel: G {tuple(G.shape)}, c "
                         f"{tuple(c.shape)}; expected {shape}, "
                         f"{(ncy * n, ncz * n)}")
    if c.device != G.device or not (G.is_contiguous()
                                    and c.is_contiguous()):
        raise ValueError("g_layout kernel: G and c contiguous on one card")
    S = _chunks(ncx, ncy * ncz, n)
    part = torch.empty((S, *c.shape), dtype=G.dtype, device=G.device)
    out = torch.empty_like(c)
    fn = getattr(_build.load(), f"fustpu_g_layout_{_SUFFIX[G.dtype]}")
    with torch.cuda.device(G.device):
        stream = torch.cuda.current_stream(G.device).cuda_stream
        err = fn(G.data_ptr(), c.data_ptr(), part.data_ptr(), out.data_ptr(),
                 int(layout == "components"), n, ncx, ncy, ncz, S, stream)
    if err != 0:
        raise RuntimeError(f"g_layout kernel launch failed: error {err}")
    launches[f"g_layout_{layout}"] += 1
    return out


# ---------------------------------------------------------------------------
# The relayout probe
# ---------------------------------------------------------------------------

def relayout_shape(n: int, kind: str) -> tuple:
    """The output shape of `relayout` for n values (whole (TM, 1) tiles)."""
    if kind in ("reverse", "copy"):
        return (n, 1)
    if kind == "reshape":
        return (n // LANES, LANES)
    if kind == "transpose":
        return (n // TM * LANES, TM // LANES)
    raise ValueError(f"kind {kind!r}: expected one of {KINDS}")


def relayout_plain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Plain version of `relayout`: reshape, `.transpose().contiguous()` or
    `clone`."""
    n = x.numel()
    if kind == "transpose":
        t = x.reshape(n // TM, TM // LANES, LANES).transpose(1, 2)
        return t.contiguous().reshape(relayout_shape(n, kind))
    if kind == "reverse":
        return x.reshape(-1, LANES).reshape(n, 1).clone()
    return x.reshape(relayout_shape(n, kind)).clone()


def relayout(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The permutation `kind` of x, (k TM, 1) (the plain version for a CPU
    tensor)."""
    return _relayout(x, kind, flat=False)


def relayout_flat(x: torch.Tensor, kind: str) -> torch.Tensor:
    """`relayout` through the first design's kernels, the comparison
    (``relayout_copy_flat``, ``relayout_transpose_padded``)."""
    return _relayout(x, kind, flat=True)


def _relayout(x: torch.Tensor, kind: str, flat: bool) -> torch.Tensor:
    n = x.numel()
    if x.dim() != 2 or x.size(1) != 1 or n % TM:
        raise ValueError(f"relayout: x of shape {tuple(x.shape)}, expected "
                         f"(k {TM}, 1)")
    if x.is_cpu:
        return relayout_plain(x, kind)
    esize = x.element_size()
    if not (x.is_cuda and x.is_contiguous()) or esize not in (4, 8):
        raise ValueError("relayout kernel: contiguous 4- or 8-byte values "
                         "on a card")
    # the copy's output is shaped like x; the others' shape checks `kind`
    y = torch.empty_like(x) if kind in ("copy", "reverse") else \
        x.new_empty(relayout_shape(n, kind))
    px, py = x.data_ptr(), y.data_ptr()
    if px % 16 or py % 16:
        raise ValueError("relayout kernel: 16-byte aligned data")
    dev = x.get_device()
    if kind == "transpose":
        if flat:
            launch.launch("fustpu_relayout_transpose_padded", dev, px, py,
                          esize, n // TM, TM // LANES, LANES)
            comparison_launches["relayout_transpose_padded"] += 1
        else:
            launch.launch("fustpu_relayout_transpose", dev, px, py, esize,
                          n // TM)
            launches["relayout_transpose"] += 1
    elif flat:
        launch.launch("fustpu_relayout_copy_flat", dev, px, py, n * esize)
        comparison_launches["relayout_copy_flat"] += 1
    else:
        nbytes = n * esize
        launch.launch("fustpu_relayout_copy", dev, px, py, nbytes,
                      launch.copy_blocks(nbytes // 16))
        launches["relayout_copy"] += 1
    return y
