"""The lean launch path of the hand-written kernels, and the grids of the
relayout copy and the engine gather.

`launch(name, device, *args)` calls the C entry point `name` of the kernel
library (``fustpu_torch/_build.py``) with `args` and the current stream of
card `device`:

- each entry point is resolved once, at its first launch (the library is
  built and loaded then);
- the stream is PyTorch's raw current stream of that card, read without a
  device switch where the card is already the current one (a switch only
  where it is not, so that the kernel runs on the card that holds its
  tensors);
- a non-zero return (an argument the C side refuses, or the launch's
  `cudaError_t`) raises.

The relayout wrappers (``ops/probes``) and the staged engine's
(``ops/cuda_engine``) launch through it.  Their checks stay in the
wrappers.  Nothing here runs at import time.

The grids: `copy_blocks` covers the relayout copy's vectors, a span of
COPY_UNROLL x COPY_THREADS a block (``csrc/probes.cu`` `relayout_copy`);
`gather_blocks` sizes the engine gather's grid to at most one wave of the
card, from its SM count, and the kernel strides over the rest
(``csrc/engine.cu`` `engine_gather_quads`); `contract_blocks` sizes the
bfloat16 contraction's persistent grid to one wave (the card's occupancy
answer, `contract_occupancy`, times its SMs), at most one block a chunk of
CONTRACT_CELLS[P] cells, block b walking chunks b, b + grid, ...; and
`scatter_blocks` gives the bfloat16 scatter one block a run of
SCATTER_DOFS dofs (``csrc/engine_bf16.cu`` `contract_ring`,
`scatter_runs`).  The thread counts and the work of a thread or a block
here are the kernels' own constants.
"""

from __future__ import annotations

import functools

import torch

COPY_THREADS = 256       # probes.cu kCopyThreads
COPY_UNROLL = 2          # probes.cu kCopyUnroll: 16 B vectors a thread
GATHER_THREADS = 256     # engine.cu kGatherThreads
GATHER_QUAD = 4          # positions a thread takes at a time
BLOCKS_PER_SM = 8        # 2,048 threads, an SM's most, at 256 a block
# engine_bf16.cu scatter_runs: a block's run of dofs (two a thread; the
# tiles of the run's inverse-map segment hold twice as many entries)
SCATTER_DOFS = 128
# engine_bf16.cu Ring<N, PAIR>::CH: cells a chunk of the bf16 contraction at
# degree P (the kernel refuses another count)
CONTRACT_CELLS = {2: 24, 3: 16, 4: 8, 5: 8, 6: 8, 7: 4, 8: 4, 9: 2, 10: 2}

_entries: dict = {}


def entry(name: str):
    """The C entry point `name`, resolved at its first use only."""
    fn = _entries.get(name)
    if fn is None:
        from fustpu_torch import _build

        fn = _entries[name] = getattr(_build.load(), name)
    return fn


_api: tuple = ()


def _cuda_api() -> tuple:
    """(the current device's index, the raw current stream of a device
    index): PyTorch's own C functions, looked up at the first launch (a
    build of PyTorch without CUDA has neither)."""
    global _api
    if not _api:
        _api = (torch._C._cuda_getDevice, torch._C._cuda_getCurrentRawStream)
    return _api


def launch(name: str, device: int, *args) -> None:
    """Call entry point `name` with `args` and the current stream of card
    `device` (an index, as `Tensor.get_device()` gives it); raise if it
    returns non-zero."""
    fn = _entries.get(name) or entry(name)
    current, stream = _api or _cuda_api()
    if device == current():
        err = fn(*args, stream(device))
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream(device))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {err}")


@functools.cache
def sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def copy_blocks(nvec: int) -> int:
    """The relayout copy's grid for `nvec` 16 B vectors: one span of
    COPY_UNROLL x COPY_THREADS vectors a block (at least one block)."""
    return max(1, -(-nvec // (COPY_THREADS * COPY_UNROLL)))


def gather_blocks(n: int, sms: int) -> int:
    """The single-field gather's grid for `n` positions (n // 4 quads of
    GATHER_THREADS a block): at least 1 block, at most one wave
    (BLOCKS_PER_SM blocks on each of `sms` SMs)."""
    quads = n // GATHER_QUAD
    return max(1, min(sms * BLOCKS_PER_SM, -(-quads // GATHER_THREADS)))


@functools.cache
def contract_occupancy(device: int, P: int, mode: int) -> int:
    """Blocks of the bfloat16 contraction at degree P and `mode` (0 plain,
    1 coefficient, 2 pair) that one SM of card `device` holds: the card's
    own occupancy answer, asked once."""
    fn = entry("fustpu_engine_contract_bf16_occupancy")
    with torch.cuda.device(device):
        blocks = fn(P, mode)
    if blocks < 1:
        raise RuntimeError(f"bf16 contraction at degree {P}, mode {mode}: "
                           f"no block fits an SM ({blocks})")
    return blocks


def contract_blocks(cells: int, P: int, per_sm: int, sms: int) -> int:
    """The bfloat16 contraction's grid for `cells` cells at degree P: one
    wave (`per_sm` blocks on each of `sms` SMs), at most one block a chunk
    of CONTRACT_CELLS[P] cells, at least 1."""
    chunks = -(-cells // CONTRACT_CELLS[P])
    return max(1, min(sms * per_sm, chunks))


def scatter_blocks(ndofs: int) -> int:
    """The bfloat16 scatter's grid: one block a run of SCATTER_DOFS dofs
    (at least 1)."""
    return max(1, -(-ndofs // SCATTER_DOFS))


def counter_dicts() -> list:
    """Every launch counter of the kernels that a model's step can launch,
    as the wrappers' own dicts (the stiffness kernels in every design, the
    staged engine with its first designs, the RK4 update): what a replayed
    CUDA graph adds to (``models/timestepping.py``)."""
    from fustpu_torch.ops import (anatomy, cuda_corner, cuda_engine,
                                  cuda_extruded, cuda_indexed, cuda_slab2,
                                  cuda_stiffness, cuda_vector)

    return [cuda_stiffness.launches, cuda_stiffness.bf16_launches,
            cuda_extruded.launches, cuda_extruded.class_launches,
            cuda_extruded.bf16_launches, cuda_indexed.launches,
            cuda_indexed.class_launches, cuda_indexed.bf16_launches,
            cuda_corner.launches, cuda_corner.class_launches,
            cuda_corner.bf16_launches, cuda_engine.launches,
            cuda_engine.bf16_launches, cuda_engine.comparison_launches,
            anatomy.launches, cuda_slab2.launches, cuda_vector.launches,
            cuda_vector.bf16_launches]
