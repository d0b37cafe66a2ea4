"""Anatomy of the structured stiffness kernel #1: variants of it that keep
one part of its work, in two designs, the hand-written CUDA kernels of
``fustpu_torch/csrc/anatomy.cu`` (the walk) and ``anatomy_classes.cu``
(the parity-class design), their schedule, wrappers and plain versions.

Counterpart of ``make_variant`` in ``demos/exp_kernel_anatomy.py`` (whose
`vpu`, `mxu` and `ywin` variants keep one TPU unit's work).  `variant(op,
x, name, design)` for the names of `VARIANTS` and the designs of
`DESIGNS`:

- ``full``: #1 itself (`full_pair`: its pair form, #2);
- ``contract`` (`mxu`): the sum factorisation with the constant metric
  (0, 0, 0, 1, 0, 1) and no G read;
- ``gstream`` (`vpu`): the x and G loads, the pointwise metric and the
  scatter, the 1-D contractions replaced by the identity:
  y_node += (G00 + 2 G01 + 2 G02 + G11 + 2 G12 + G22) u_node per cell;
- ``ywin``: the operator, with x arriving another way.

Designs:

- ``pencil`` (the default): policies of the z-pencil walk that the main
  path runs (``csrc/anatomy_walk.cuh``); ``full`` is
  ``cuda_stiffness.stiffness`` itself, bitwise; ``gstream`` keeps the
  walk's ring copies of G, x staging, y buffer and write-out with the
  pointwise body; ``contract`` keeps no ring (the unit metric in
  registers); ``ywin`` brings x by bulk copies, one a z-line run, into an
  area of its own (bitwise ``full``).  They run on #1's schedule
  (`variant_schedule`);
- ``classes``: the variants of the parity-class design (eight
  parity classes of scattered cells, ``csrc/stiffness.cuh``), which the
  main path ran before the walk; `variant_classes` and
  `full_pair_classes`.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  Each variant of each design counts its
applies in `launches` (`counter`).  Only the experiment demos
``fustpu_torch.demos.exp_kernel_anatomy`` and ``exp_pencil`` (the
parity-class design against the pencil kernel) run them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fustpu_torch.ops import cuda_stiffness as cs
from fustpu_torch.ops import spectral_mm as mm

VARIANTS = ("full", "gstream", "contract", "ywin")
DESIGNS = ("pencil", "classes")
# the kernels' variant flag (anatomy.cu, anatomy_classes.cu)
_FLAG = {"full": 0, "contract": 1, "gstream": 2, "ywin": 3}


def counter(name: str, design: str = "pencil") -> str:
    """The key of `launches` that counts variant `name` (or "full_pair")
    of `design`: the parity-class #1 / #2 keep ``anatomy_full`` /
    ``_full_pair`` and its variants take ``anatomy_classes_*``; the walk's
    variants take
    ``anatomy_*`` and its #1 / #2 ``anatomy_pencil_full`` / ``_full_pair``."""
    full = name in ("full", "full_pair")
    if design == "classes":
        return f"anatomy_{name}" if full else f"anatomy_classes_{name}"
    return f"anatomy_pencil_{name}" if full else f"anatomy_{name}"


# Applies that went through each variant's kernel.
launches = {counter(name, design): 0 for design in DESIGNS
            for name in (*VARIANTS, "full_pair")}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _names(name: str, design: str) -> None:
    if design not in DESIGNS:
        raise ValueError(f"design {design!r}: expected one of {DESIGNS}")
    if name not in VARIANTS:
        raise ValueError(f"variant {name!r}: expected one of {VARIANTS}")


# ---------------------------------------------------------------------------
# The pencil variants' schedule
# ---------------------------------------------------------------------------

def variant_smem(P: int, itemsize: int, cpb: int, name: str
                 ) -> tuple[int, int, int]:
    """(stages, bytes a stage, dynamic shared bytes a block) of a pencil
    variant (the layout of ``stiffness_pencil.cuh`` with its policies):
    full and gstream #1's (``cuda_stiffness.pencil_smem``); ywin #1's with
    one more mbarrier (x's) and, after the stages, an area of the n^2
    z-line runs of x, a slot of cpb P + 1 values and 16 B each; contract
    no ring, and every cell slot's f1, f2 (2 n^3 values) after the chunk
    buffers."""
    stage, smem = cs.pencil_smem(P, itemsize, cpb)
    n = P + 1
    if name == "ywin":
        xs = n * n * cs._round16((cpb * P + 1) * itemsize + 16)
        bar = cs._round16(8 * (cs.STAGES + 1)) - cs._round16(8 * cs.STAGES)
        return cs.STAGES, stage, smem + xs + bar
    if name == "contract":
        head = cs._round16(8 * cs.ROW_RING * cs.TABLE_ROW)
        values = 4 * n ** 3 * cpb + 2 * n * n * (cpb * P + 1)
        return 0, 0, head + values * itemsize
    return cs.STAGES, stage, smem


def variant_schedule(nc, P: int, itemsize: int, sms: int, name: str,
                     occupancy=cs.model_occupancy,
                     full_occupancy=cs.model_occupancy,
                     cpb: int | None = None) -> cs.PencilSchedule:
    """The walk's launch of pencil variant `name` on a card of `sms` SMs:
    #1's schedule (`cuda_stiffness.pencil_schedule`, whose occupancy is
    `full_occupancy`) for full; #1's cells a chunk, and so its chunk
    table, for gstream and ywin, with their own shared bytes and
    occupancy (`occupancy`, the variant kernel's).  contract reserves no
    ring stage and streams nothing, so no bytes pace its steps: it takes
    the cells a chunk with the fewest chunk steps (``cuda_stiffness._
    steps``) and, on a tie, the smaller chunk, the more blocks in flight
    (measured at P = 4, float32, 32^3 and 64 x 40 x 40 by
    ``demos/exp_kernel_anatomy --sweep``).  `cpb` fixes the cells a
    chunk (the sweep)."""
    if name not in VARIANTS:
        raise ValueError(f"variant {name!r}: expected one of {VARIANTS}")
    if name != "contract":
        fixed = cpb or cs.pencil_schedule(nc, P, itemsize, sms,
                                          occupancy=full_occupancy).cpb
        if name == "full":
            return cs.pencil_schedule(nc, P, itemsize, sms,
                                      occupancy=full_occupancy, cpb=fixed)
        return cs.pencil_schedule(
            nc, P, itemsize, sms, occupancy=occupancy, cpb=fixed,
            layout=lambda c: variant_smem(P, itemsize, c, name)[1:])
    best = None
    for c in [cpb] if cpb else range(1, cs.MAX_THREADS // (P + 1) ** 2 + 1):
        try:
            s = cs.pencil_schedule(
                nc, P, itemsize, sms, occupancy=occupancy, cpb=c, stages=0,
                layout=lambda c: variant_smem(P, itemsize, c, name)[1:])
        except ValueError:               # more cells than a pencil or a
            continue                     # block holds
        key = (cs._steps(nc, c, s.blocks), c)
        if best is None or key < best[0]:
            best = (key, s)
    if best is None:
        raise ValueError(f"anatomy contract: no block of degree {P} fits an "
                         "SM")
    return best[1]


@functools.cache
def _card_schedule(nc: tuple, P: int, dtype: torch.dtype, name: str,
                   device: torch.device, cpb: int | None = None) -> tuple:
    """A pencil variant's schedule on `device`, its chunk table there and
    its classes as a C array, built once per shape (`cpb`: another cells a
    chunk than the schedule's choice)."""
    from fustpu_torch import _build

    lib = _build.load()

    def answer(got):
        if got < 0:
            raise RuntimeError(f"anatomy {name} occupancy query failed: "
                               f"error {-got}")
        return got

    def occupancy(P, itemsize, pair, cpb, smem):
        return answer(lib.fustpu_anatomy_pencil_occupancy(
            _FLAG[name], P, int(itemsize == 8), cpb, smem))

    def full_occupancy(P, itemsize, pair, cpb, smem):
        return answer(lib.fustpu_stiffness_occupancy(
            P, int(itemsize == 8), 0, cpb, smem))

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    itemsize = torch.empty((), dtype=dtype).element_size()
    with torch.cuda.device(device):
        sched = variant_schedule(nc, P, itemsize, sms, name, occupancy,
                                 full_occupancy, cpb)
    classes = sched.classes.reshape(-1)
    return (sched, torch.as_tensor(sched.chunks, device=device),
            (ctypes.c_longlong * classes.size)(*classes.tolist()))


def card_schedule(op: cs.CellStiffness, x: torch.Tensor, name: str,
                  cpb: int | None = None) -> cs.PencilSchedule:
    """The schedule that pencil variant `name` of `op` runs on x's card
    (`cpb`: at that cells a chunk)."""
    return _card_schedule(tuple(op.nc), op.P, x.dtype, name, x.device,
                          cpb)[0]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def unit_yz(op: cs.CellStiffness) -> cs.CellStiffness:
    """`op` with the constant metric (0, 0, 0, 1, 0, 1) in place of G: the
    operator that ``contract`` computes."""
    G = torch.zeros_like(op.G)
    G[:, 3] = 1.0
    G[:, 5] = 1.0
    return op._replace(G=G)


def gstream_plain(op: cs.CellStiffness, x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``gstream``, in the matmul layout: the windowed
    expansion of x, times the combined metric, folded back."""
    mm_op = cs.to_mm(op)[0]
    w = torch.tensor([1.0, 2.0, 2.0, 1.0, 2.0, 1.0], dtype=x.dtype,
                     device=x.device)
    g = torch.einsum("m...,m->...", mm_op.G, w)
    return mm.fold(mm_op, g * mm.expand(mm_op, x))


def variant_plain(op: cs.CellStiffness, x: torch.Tensor,
                  name: str) -> torch.Tensor:
    """Plain version of `variant` (either design)."""
    if name in ("full", "ywin"):
        return cs.stiffness_plain(op, x)
    if name == "contract":
        return cs.stiffness_plain(unit_yz(op), x)
    if name == "gstream":
        return gstream_plain(op, x)
    raise ValueError(f"variant {name!r}: expected one of {VARIANTS}")


def variant_cost(op: cs.CellStiffness, ndofs: int,
                 name: str) -> tuple[int, int]:
    """(least bytes, operations) of one apply of variant `name`: full and
    ywin G and x read once and y written once, per node 2 x 3 derivative
    sums of n products, 15 for the metric and 1 for the add; gstream the
    same bytes, per node the metric and its sum (17) and the add; contract
    x and y only, per node 2 of the 3 derivative pairs and the add."""
    cells, _, nnn = op.G.shape
    n, b = op.P + 1, op.G.element_size()
    nbytes = op.G.numel() * b + 2 * ndofs * b
    if name == "gstream":
        return nbytes, cells * nnn * 18
    if name == "contract":
        return 2 * ndofs * b, cells * nnn * (8 * n + 1)
    return nbytes, cells * nnn * (12 * n + 16)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def variant(op: cs.CellStiffness, x: torch.Tensor, name: str,
            design: str = "pencil", cpb: int | None = None) -> torch.Tensor:
    """The variant `name` of the structured kernel in `design` on `op` and
    x (the plain version for a CPU tensor); `cpb`: the walk's cells a
    chunk, where not its schedule's choice."""
    _names(name, design)
    if x.device.type == "cpu":
        return variant_plain(op, x, name)
    from fustpu_torch import _build

    cs._check(op, x, pair=False)
    if design == "pencil":
        if op.G.data_ptr() % 16 or x.data_ptr() % 16:
            raise ValueError("anatomy kernel: G's or x's data is not 16 "
                             "B-aligned (the bulk copies need it)")
        if x.numel() >= 2 ** 31:
            raise ValueError(f"anatomy kernel: {x.numel()} grid nodes, the "
                             "kernel indexes fewer than 2^31")
    y = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    suffix = cs._SUFFIX[x.dtype]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if design == "classes":
            fn = getattr(_build.load(), f"fustpu_anatomy_classes_{suffix}")
            err = fn(_FLAG[name], x.data_ptr(), op.G.data_ptr(),
                     op.D.data_ptr(), y.data_ptr(), op.P, *op.nc, stream)
        else:
            sched, chunks, classes = _card_schedule(
                tuple(op.nc), op.P, x.dtype, name, x.device, cpb)
            fn = getattr(_build.load(), f"fustpu_anatomy_pencil_{suffix}")
            err = fn(_FLAG[name], x.data_ptr(), op.G.data_ptr(),
                     op.D.data_ptr(), y.data_ptr(), op.P, chunks.data_ptr(),
                     classes, len(sched.classes), sched.blocks, sched.cpb,
                     sched.stages, sched.stage_bytes, sched.smem, *op.nc,
                     stream)
    if err != 0:
        raise RuntimeError(f"anatomy {name} ({design}) kernel launch failed: "
                           f"error {err}")
    launches[counter(name, design)] += 1
    return y


def variant_classes(op: cs.CellStiffness, x: torch.Tensor,
                    name: str) -> torch.Tensor:
    """`variant` of the parity-class design."""
    return variant(op, x, name, "classes")


def full_pair(op: cs.CellStiffness, x1: torch.Tensor, x2: torch.Tensor,
              design: str = "pencil") -> torch.Tensor:
    """#2 in `design` on `op`: the z-pencil pair kernel on #2's schedule,
    or the parity-class pair kernel (the plain version for CPU
    tensors)."""
    _names("full", design)
    if x1.device.type == "cpu":
        return cs.stiffness_pair_plain(op, x1, x2)
    from fustpu_torch import _build

    cs._check(op, x1, x2, pair=True)
    if design == "pencil" and op.G.data_ptr() % 16:
        raise ValueError("anatomy kernel: G's data is not 16 B-aligned (the "
                         "bulk copies need it)")
    y = torch.zeros(x1.shape, dtype=x1.dtype, device=x1.device)
    suffix = cs._SUFFIX[x1.dtype]
    ptrs = (x1.data_ptr(), x2.data_ptr(), op.C.data_ptr(), op.G.data_ptr(),
            op.D.data_ptr(), y.data_ptr(), op.P)
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        if design == "classes":
            fn = getattr(_build.load(),
                         f"fustpu_anatomy_classes_pair_{suffix}")
            err = fn(*ptrs, *op.nc, stream)
        else:
            sched, chunks, classes = cs._card_schedule(
                tuple(op.nc), op.P, x1.dtype, True, x1.device)
            fn = getattr(_build.load(), f"fustpu_anatomy_pencil_pair_{suffix}")
            err = fn(*ptrs, chunks.data_ptr(), classes, len(sched.classes),
                     sched.blocks, sched.cpb, sched.stages,
                     sched.stage_bytes, sched.smem, *op.nc, stream)
    if err != 0:
        raise RuntimeError(f"anatomy full_pair ({design}) kernel launch "
                           f"failed: error {err}")
    launches[counter("full_pair", design)] += 1
    return y


def full_pair_classes(op: cs.CellStiffness, x1: torch.Tensor,
                      x2: torch.Tensor) -> torch.Tensor:
    """`full_pair` of the parity-class design."""
    return full_pair(op, x1, x2, "classes")
