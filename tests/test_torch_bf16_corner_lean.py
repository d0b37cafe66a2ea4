"""The bfloat16 corner walk redesigned for Hopper (the lean corner walk,
``fustpu_torch/csrc/corner_lean.cuh``; #3 on box pencils, #6c on hex8 and
hex27 stacks, through ``ops/cuda_corner``), the capacity mode's main path
in bfloat16.

On the CPU: the lean walk's schedule is the first bfloat16 corner design's
(cells a chunk, segments, classes, chunk table) at P = 2..10, box and
stacks, single and pair, with its own shared layout (float rows padded to
a multiple of 4, the widened channels' 16 B-aligned slots) within the
card's 232,448 B and nothing static; the routing set is what the CUDA
sources instantiate; a bf16 corner model's kernel name and counter key
follow the routing while float32 and float64 models keep theirs; the lean
wrappers refuse a CPU tensor, a wrong dtype and a misaligned T before
anything is built or launched; the host-packed D, GLL nodes and weights
are bitwise the floats that the first design's kernel widens; the demos'
bf16 lean-against-first modes run on the CPU.  On the card (`-m cuda`,
skipped here): the lean walk against the first design at small sizes,
at each (degree, form) that runs it, within the redesign gate, and against
the plain version.  The card tests run on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_bf16_corner_lean.py -m cuda
"""

from __future__ import annotations

import ctypes
import functools
import re

import numpy as np
import pytest
import torch

from fustpu_torch import _build
from fustpu_torch.mesh import msh_io, shapes
from fustpu_torch.mesh.box import build_box_mesh
from fustpu_torch.mesh.extruded import as_extruded
from fustpu_torch.mesh.unstructured import from_box
from fustpu_torch.models import discretization as dz
from fustpu_torch.ops import cuda_corner as cc
from fustpu_torch.ops import cuda_extruded as ce
from fustpu_torch.ops import cuda_stiffness as cs

torch.set_num_threads(1)

BF16 = torch.bfloat16
# a bf16 kernel against its plain version on the same bf16 inputs
CARD_TOL = 2.0 ** -7
# the redesign gate: the lean walk against the first bfloat16 corner walk,
# each on its own schedule (PERF.md section 2): rel-l2 and the share of
# values differing
GATE_TOL, GATE_SHARE = 1e-3, 0.01
SMEM_BLOCK = 232_448
CYL = dict(radius=0.012, length=0.02, piston_radius=0.008, m=3, mr=1,
           nr_ann=1)
GEOS = {"box": (1, False), "hex8": (1, True), "hex27": (2, True)}


def rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


@functools.lru_cache(maxsize=None)
def _cylinder(P: int, nz: int = 4):
    """The imported test cylinder (hex8 stacks) at degree P, written and
    read back in a temporary directory of its own."""
    import tempfile

    v, c, t = shapes.cylinder_mesh(nz=nz, **CYL)
    with tempfile.TemporaryDirectory() as tmp:
        return msh_io.read_msh(msh_io.write_msh(f"{tmp}/cyl", v, c, t), P)


def _stack_mesh(geo: str, P: int):
    if geo == "hex8":
        return _cylinder(P)
    return as_extruded(shapes.hex27_lattice(
        from_box(build_box_mesh((2, 2, 3), P), shuffle_seed=11),
        shapes.curved_prism_map))


def _model_occupancy(P, pair, cpb, smem, most=256):
    """Blocks an SM by threads and shared memory alone, 0 beyond `most`
    threads (the card's answer also counts registers)."""
    threads = (P + 1) ** 2 * cpb
    if threads > most:
        return 0
    return min(2048 // threads, 32,
               cs.SMEM_SM // (smem + cs.SMEM_RESERVED))


def _first_schedule(geo: str, P: int, pair: bool, sms: int = 132):
    """The first bfloat16 corner design's schedule of a small mesh of
    `geo` on a card of `sms` SMs (the host's choice under the model
    occupancy and the first design's launch bounds: 128 threads for the
    single-field trilinear walk at P <= 4, else 256)."""
    gd, stacks = GEOS[geo]
    most = 128 if gd == 1 and not pair and P <= 4 else 256
    occ = lambda P_, itemsize, pair_, cpb, smem: _model_occupancy(
        P_, pair_, cpb, smem + cs._static_smem(P_, itemsize), most)
    channels = cs.corner_channels(gd)
    if not stacks:
        return cs.pencil_schedule((5, 3, 7), P, 2, sms, pair, occ,
                                  channels), 5 * 3 * 7
    mesh = _stack_mesh(geo, P)
    colour = ce.colour_stacks(mesh.rows2d)
    return (ce.stack_schedule(colour, mesh.rows2d, mesh.nz, P, 2, sms, pair,
                              occupancy=occ, channels=channels),
            mesh.rows2d.shape[0] * mesh.nz)


@pytest.mark.parametrize("geo", list(GEOS))
@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("P", range(2, 11))
def test_lean_corner_schedule_is_the_first_designs(geo, pair, P):
    """The lean corner walk's schedule (`cc.lean_schedule`) on the first
    design's: the same cells a chunk, segments, stages, stage bytes,
    classes and chunk table (every cell once, each chunk's span 16 B-aligned
    inside the channels, within its stage), only the shared bytes, blocks an
    SM and grid its own; its layout (`cc.lean_smem`) is the walk's: the head
    and the first design's stages, then float32 u, f1, f2 with each row
    padded to KP (a multiple of 4 values, 16 B), the widened channels (16
    B-aligned slots a cell: 40 floats trilinear, 184 hex27), the chunk's y,
    for the pair x2 and (c1, c2), and D; within 232,448 B with nothing
    static; the occupancy is asked with that layout and the first design's
    cells a chunk."""
    gd, stacks = GEOS[geo]
    first, ncells = _first_schedule(geo, P, pair)
    asked = []

    def occupancy(P_, pair_, cpb, smem):
        asked.append((P_, pair_, cpb, smem))
        return 3

    lean = cc.lean_schedule(first, P, pair, stacks, gd, occupancy, 132)
    assert asked == [(P, pair, first.cpb, lean.smem)]
    assert (lean.blocks_per_sm, lean.blocks) == (3, 3 * 132)
    for f in ("cpb", "stages", "stage_bytes"):
        assert getattr(lean, f) == getattr(first, f)
    if stacks:
        assert lean.segments == first.segments
        assert np.array_equal(lean.ids, first.ids)
    assert np.array_equal(lean.classes, first.classes)
    assert np.array_equal(lean.chunks, first.chunks)
    # the layout, from its parts
    n, cpb = P + 1, first.cpb
    kp = -(-n // 4) * 4
    assert kp % 4 == 0 and n <= kp < n + 4
    cellf = n * n * kp
    slot = cc.slot_floats(gd)
    assert slot == (40 if gd == 1 else 184) and slot % 4 == 0
    rows = n * n * (cpb * P + 1)
    floats = (4 * cpb * cellf + cpb * slot + 2 * rows
              + (2 * rows + 4 * cpb if pair else 0) + -(-n * n // 4) * 4)
    head = 16 * -(-8 * first.stages // 16) + 16 * -(-8 * 3 * 5 // 16) + (
        16 * -(-4 * 3 * n * n // 16) if stacks else 0)
    stage = 16 * -(-(cpb * cs.corner_channels(gd) * 2 + 16) // 16)
    assert lean.stage_bytes == stage
    assert lean.smem == head + first.stages * stage + 4 * floats
    assert lean.smem <= SMEM_BLOCK
    # the float4 areas start 16 B-aligned: u, f1 / f2 and the channels
    start = head + first.stages * stage
    assert start % 16 == 0 and (4 * 4 * cpb * cellf) % 16 == 0
    # every cell once, the spans inside the channels and their stages
    covered = np.zeros(ncells, np.int64)
    for c0, m, *_ in lean.chunks:
        covered[c0:c0 + m] += 1
    assert (covered == 1).all()
    cell = cs.corner_channels(gd) * 2
    off, nbytes = lean.chunks[:, 2], lean.chunks[:, 3]
    assert (off % 16 == 0).all() and (nbytes % 16 == 0).all()
    assert (off + nbytes <= ncells * cell).all()
    assert (lean.chunks[:, 0] * cell - off + lean.chunks[:, 1] * cell
            <= stage).all()


def test_lean_corner_schedule_refuses_what_does_not_fit():
    """The first design's block that the lean walk cannot hold (the card's
    answer 0) is refused, not run on another schedule."""
    first, _ = _first_schedule("box", 4, True)
    with pytest.raises(ValueError, match="does not fit"):
        cc.lean_schedule(first, 4, True, False, 1, lambda *a: 0, 132)


def _degrees(source: str, name: str) -> set:
    """The degrees of the Degrees<...> type `name` in a CUDA source."""
    text = (_build.CSRC / source).read_text()
    got = re.search(rf"using {name} =\s*[\w:]*Degrees<([\d, ]*)>", text)
    return {int(d) for d in got.group(1).split(",") if d.strip()}


@pytest.mark.parametrize("geo,source,names", [
    ("box", "corner_lean.cu", ("BoxSingle", "BoxPair")),
    ("hex8", "corner_lean_stack.cu", ("Hex8Single", "Hex8Pair")),
    ("hex27", "corner_lean_stack27.cu", ("Hex27Single", "Hex27Pair"))])
def test_lean_corner_instances_match_the_routing(geo, source, names):
    """The CUDA sources instantiate the lean corner walk exactly at the
    (P, pair, geometry) that LEAN_CORNER_BF16 routes to it."""
    for pair, name in zip((False, True), names):
        assert _degrees(source, name) == {
            P for P in range(2, 11) if (P, pair, geo) in cc.LEAN_CORNER_BF16}
    assert all(2 <= P <= 10 and g in cc.GEOMETRIES
               for P, _, g in cc.LEAN_CORNER_BF16)


@pytest.mark.parametrize("P", [3, 4])
def test_split_tools_copy_the_sources_at_one_degree(P):
    """``tools/corner_split`` and ``tools/chunk_split`` copy the sources
    with every degree list holding P alone, and a lean corner copy with
    PlanP4's rows set as its name says (the table the package builds
    unchanged in the plain "lean")."""
    from fustpu_torch.tools import chunk_split, copies, corner_split

    names = [*corner_split.FIRST, "lean", "lean no_dreg+wide+minb=414111"]
    got = corner_split.variants(P, list(corner_split.SOURCES), names)
    assert len(got) == len(corner_split.SOURCES) * len(names)
    plan = (_build.CSRC / "corner_lean.cuh").read_text()
    for (form, name), (src, texts, flags) in got.items():
        assert src in corner_split.SOURCES[form] and flags == []
        for text in texts.values():
            assert set(re.findall(r"Degrees<([\d, ]*)>", text)) <= {str(P)}
            assert set(re.findall(r"#define FUSTPU_DEGREES\(M\) (.*)",
                                  text)) <= {f"M({P})"}
        if name == "lean":
            assert texts["corner_lean.cuh"] == plan
        elif name.startswith("lean"):
            rows = dict(re.findall(
                r"static constexpr \w+ (\w+)\[6\] = \{([^}]*)\};",
                texts["corner_lean.cuh"]))
            assert rows == {"DREG": ", ".join(["false"] * 6),
                            "WIDE": ", ".join(["true"] * 6),
                            "MINB": "4, 1, 4, 1, 1, 1"}
    with pytest.raises(ValueError, match="sets 2 forms"):
        corner_split.lean_plan("lean minb=41")
    for name, (src, text) in chunk_split.variants(P).items():
        assert re.findall(r"#define FUSTPU_\w+\(M\) (.*)", text) and set(
            re.findall(r"#define FUSTPU_\w+\(M\) (.*)", text)) == {
                f"M({P})"}, name
    with pytest.raises(AssertionError):
        copies.at_degree("no list here", P, ["FUSTPU_DEGREES"])


def _ops(geo: str, P: int, dtype):
    """The corner operators of a small mesh of `geo` in `dtype`: single
    (with a coefficient) and pair."""
    mesh = (build_box_mesh((3, 4, 5), P, hi=(1.0, 0.8, 1.3), perturb=0.15,
                           seed=7) if geo == "box" else _stack_mesh(geo, P))
    disc = dz.Discretization(mesh)
    rng = np.random.default_rng(P)
    shape = mesh.nc if geo == "box" else (mesh.num_cells,)
    c1, c2 = rng.uniform(0.5, 2.0, shape), rng.uniform(-1.5, -0.5, shape)
    return mesh, {False: disc.stiffness_op(dtype, "cpu", corner=True,
                                           coeff=c1),
                  True: disc.stiffness_op(dtype, "cpu", corner=True,
                                          pair=(c1, c2))}


@pytest.mark.parametrize("geo", list(GEOS))
@pytest.mark.parametrize("P", [2, 4, 9])
def test_corner_kernel_names_follow_the_routing(monkeypatch, geo, P):
    """A bf16 corner model counts its applies under `name`_bf16 where the
    routing set sends it to the lean walk and `name`_bf16_first_walk
    elsewhere (``cuda_stiffness.bf16_key``), and `lean_runs` says so;
    float32 and float64 corner models keep their names and never run the
    lean walk.  With the set emptied every bf16 form keeps the first
    design."""
    for dtype in (BF16, torch.float32, torch.float64):
        _, ops = _ops(geo, P, dtype)
        for pair, op in ops.items():
            assert cc.geometry(op) == geo
            base = op.kernel + ("_pair" if pair else "")
            lean = (P, pair, geo) in cc.LEAN_CORNER_BF16
            model = dz.CornerStiffness(op, "cuda")
            if dtype == BF16:
                assert cc.lean_runs(op, pair, dtype) == lean
                assert model.kernel == cs.bf16_key(base, lean)
                assert model.kernel in cc.bf16_launches
            else:
                assert not cc.lean_runs(op, pair, dtype)
                assert model.kernel == base and base in cc.launches
            assert dz.CornerStiffness(op, "mm").kernel is None
    monkeypatch.setattr(cc, "LEAN_CORNER_BF16", frozenset())
    _, ops = _ops(geo, P, BF16)
    for pair, op in ops.items():
        assert dz.CornerStiffness(op, "cuda").kernel == cs.bf16_key(
            op.kernel + ("_pair" if pair else ""), False)


class _OnCard(torch.Tensor):
    """A CPU tensor that the wrappers take for a card tensor, so that their
    checks run; nothing launches (`_build.load` and the schedule are
    replaced)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _on_card(op):
    return op._replace(**{k: v.as_subclass(_OnCard)
                          for k, v in op._asdict().items()
                          if isinstance(v, torch.Tensor)})


@pytest.mark.parametrize("geo", list(GEOS))
def test_lean_wrappers_refuse_before_any_launch(monkeypatch, geo):
    """The lean walk's launcher takes bfloat16 card tensors with 16
    B-aligned channels only: a CPU tensor, float32 fields and channels, and
    a T two bytes off its 16 B alignment are refused before the library is
    built or a schedule made; the comparison wrappers refuse float32."""
    def refuse(*args, **kwargs):
        raise AssertionError("reached the build or the schedule")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(cc, "_card", refuse)
    mesh, ops = _ops(geo, 3, BF16)
    _, ops32 = _ops(geo, 3, torch.float32)
    for pair, op in ops.items():
        xs = [torch.zeros(mesh.grid_shape, dtype=BF16)
              for _ in range(1 + pair)]
        extra = (op.C.data_ptr(),) if pair else ()
        with pytest.raises(ValueError, match="tensor on cpu"):
            cc._launch(op, xs, extra, design="lean")
        card = _on_card(op)
        x16 = [x.as_subclass(_OnCard) for x in xs]
        x32 = [x.float().as_subclass(_OnCard) for x in xs]
        with pytest.raises(ValueError, match="dtype torch.float32"):
            cc._launch(_on_card(ops32[pair]), x32, extra, design="lean")
        buf = torch.empty(op.T.numel() + 1, dtype=BF16)
        T = buf[1:].view(op.T.shape)
        T.copy_(op.T)
        assert T.is_contiguous() and T.data_ptr() % 16 == 2
        with pytest.raises(ValueError, match="16 B-aligned"):
            cc._launch(_on_card(op._replace(T=T)), x16, extra,
                       design="lean")
        first = ((cc.corner_pair_first if pair else cc.corner_first)
                 if geo == "box" else
                 (cc.extruded_corner_pair_first if pair
                  else cc.extruded_corner_first))
        with pytest.raises(ValueError, match="dtype torch.float32"):
            first(_on_card(ops32[pair]), *x32)
        # a bfloat16 card apply passes every check and stops at the
        # schedule, with no path to the plain version
        with pytest.raises(AssertionError, match="reached"):
            cc._launch(card, x16, extra, design="lean")
    assert not any(cc.bf16_launches.values())
    assert not any(cc.comparison_launches.values())


@pytest.mark.parametrize("geo", list(GEOS))
def test_host_constants_are_the_first_designs_floats(geo):
    """What the lean walk takes by value, D and the GLL nodes and weights
    packed on the host (`cs.host_D`), is bitwise the floats that the first
    design's kernel reads: D widened from bfloat16 (exactly) and Q, already
    float32."""
    for P in (2, 4, 8):
        _, ops = _ops(geo, P, BF16)
        op = ops[False]
        n = P + 1
        for t, want in ((op.D, op.D.float()), (op.Q, op.Q)):
            assert want.dtype == torch.float32
            got = np.ctypeslib.as_array(
                (ctypes.c_float * t.numel()).from_address(cs.host_D(t)))
            assert np.array_equal(got.view(np.uint32),
                                  want.reshape(-1).numpy().view(np.uint32))
        assert op.Q.shape == (2, n)
        # the widening of a bfloat16 value is exact: its bits, shifted
        bits = op.D.reshape(-1).view(torch.int16).numpy().astype(np.uint16)
        assert np.array_equal(bits.astype(np.uint32) << 16,
                              op.D.float().reshape(-1).numpy()
                              .view(np.uint32))


@pytest.mark.parametrize("demo,argv", [
    ("exp_pencil", ["--corner", "--bf16", "--nc", "3", "2", "4",
                    "--degree", "3", "--device", "cpu"]),
    ("exp_imported", ["--corner", "--bf16", "--hex27", "--elements", "4",
                      "--degree", "4", "--device", "cpu"])])
def test_demos_run_lean_against_first_on_cpu(demo, argv, capsys):
    """The demos' bf16 lean-against-first modes run on the CPU (the plain
    versions, nothing timed) and say so."""
    import importlib

    mod = importlib.import_module(f"fustpu_torch.demos.{demo}")
    out = mod.main(argv)
    assert out
    assert "bf16 lean vs first" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card_meshes(P):
    """The small meshes of the card test at degree P: a perturbed box, the
    imported cylinder (hex8 stacks), the curved hex27 prism."""
    return {"box": build_box_mesh((4, 3, 5), P, hi=(1.0, 0.8, 1.3),
                                  perturb=0.15, seed=P),
            "hex8": _cylinder(P, 4 if P <= 6 else 2),
            "hex27": _stack_mesh("hex27", P)}


@pytest.mark.cuda
@pytest.mark.parametrize("P", sorted({P for P, _, _ in cc.LEAN_CORNER_BF16}))
def test_lean_corner_walk_matches_first_design_on_card(P):
    """At each degree P that runs the lean corner walk, every bf16 corner
    form (box, hex8, hex27; single with a coefficient, and pair) where it
    runs there, on the lean corner walk against the first
    bfloat16 corner walk on the same inputs, each on its own schedule
    (which is the same): within the redesign gate (GATE_TOL, at most
    GATE_SHARE of the values differing; every routed form measured
    bitwise on the card's large meshes), both within
    CARD_TOL of the plain version, two applies bitwise; the main path
    counts under the routed key, the comparison in its own counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    rng = np.random.default_rng(P)
    for geo, mesh in _card_meshes(P).items():
        disc = dz.Discretization(mesh)
        shape = mesh.nc if geo == "box" else (mesh.num_cells,)
        c1 = rng.uniform(0.5, 2.0, shape)
        c2 = rng.uniform(-1.5, -0.5, shape)
        xs = [torch.as_tensor(rng.standard_normal(mesh.grid_shape),
                              device="cuda").to(BF16) for _ in range(2)]
        for pair, kw in ((False, {"coeff": c1}), (True, {"pair": (c1, c2)})):
            op = disc.stiffness_op(BF16, "cuda", corner=True, **kw)
            if not cc.lean_runs(op, pair, BF16):
                continue
            a = xs[:1 + pair]
            cc.reset_launches()
            y = cc._apply(op, a)
            first = cc._apply(op, a, first=True)
            torch.cuda.synchronize()
            base = op.kernel + ("_pair" if pair else "")
            assert cc.bf16_launches[cs.bf16_key(base)] == 1
            assert cc.comparison_launches[f"{base}_first_bf16"] == 1
            assert cc.card_schedule(op, a[0], pair).cpb == \
                cc.card_schedule(op, a[0], pair, design="first").cpb
            differ = int((y != first).sum())
            assert rel(y.cpu(), first.cpu()) <= GATE_TOL, (geo, pair)
            assert differ <= GATE_SHARE * y.numel(), (geo, pair, differ)
            plain = (cc.corner_pair_plain if pair else cc.corner_plain)(
                op, *a)
            assert rel(y.cpu(), plain.cpu()) <= CARD_TOL
            assert rel(first.cpu(), plain.cpu()) <= CARD_TOL
            assert torch.equal(cc._apply(op, a), y)
