"""The step profiler's trace reduction (fustpu_torch.tools.profile_step) on
a hand-made Chrome trace: grouping, launch counts and the busy union; the
ptxas report's parser (fustpu_torch.tools.kernel_resources) on a
hand-made report; the two-checkout turns (fustpu_torch.tools.turns) on a
command that prints its checkout; and the least bytes that the bounds of
the stiffness applies count."""

import sys

import numpy as np
import pytest
import torch

from fustpu_torch.tools import kernel_resources, turns
from fustpu_torch.tools.profile_step import summarize_trace

torch.set_num_threads(1)


def _ev(cat, name, ts, dur, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summarize_trace_groups_and_busy_union():
    events = [
        _ev("kernel", "void stiffness_kernel<float, 5, false>", 0.0, 10.0),
        _ev("kernel", "void stiffness_kernel<float, 5, false>", 5.0, 10.0),
        _ev("kernel", "vectorized_elementwise_kernel", 20.0, 4.0),
        _ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 30.0, 2.0),
        _ev("cpu_op", "aten::add_", 0.0, 100.0),          # host: ignored
        _ev("kernel", "stiffness_kernel", 50.0, 1.0, ph="i"),  # not a span
    ]
    s = summarize_trace(events)
    assert s["stiffness"] == (20.0, 2)
    assert s["elementwise"] == (4.0, 1)
    assert s["copies"] == (2.0, 1)
    # [0, 15) overlapped, [20, 24), [30, 32)
    assert s["busy_us"] == pytest.approx(21.0)
    assert s["span_us"] == pytest.approx(32.0)


def test_summarize_trace_without_device_events():
    s = summarize_trace([_ev("cpu_op", "aten::mul", 0.0, 3.0)])
    assert s["busy_us"] == 0.0 and s["span_us"] == 0.0
    assert s["stiffness"] == (0.0, 0)


def test_summarize_trace_counts_the_extruded_kernel():
    events = [
        _ev("kernel", "void extruded_kernel<float, 5, true>", 0.0, 8.0),
        _ev("kernel", "void extruded_kernel<float, 5, true>", 8.0, 8.0),
        _ev("kernel", "vectorized_elementwise_kernel", 16.0, 2.0),
    ]
    s = summarize_trace(events)
    assert s["stiffness"] == (16.0, 2)
    assert s["elementwise"] == (2.0, 1)
    assert s["busy_us"] == pytest.approx(18.0)


def test_summarize_trace_counts_the_indexed_kernel():
    events = [
        _ev("kernel", "void indexed_kernel<float, 5, false>", 0.0, 6.0),
        _ev("kernel", "void indexed_kernel<float, 5, true>", 10.0, 6.0),
        _ev("gpu_memset", "Memset (Device)", 16.0, 1.0),
    ]
    s = summarize_trace(events)
    assert s["stiffness"] == (12.0, 2)
    assert s["copies"] == (1.0, 1)
    assert s["busy_us"] == pytest.approx(13.0)


def test_summarize_trace_counts_the_pencil_kernel():
    """The main path's structured kernel (four class launches an apply)."""
    name = "void fustpu::pencil::pencil_kernel<float, 5, false>(...)"
    events = [_ev("kernel", name, 10.0 * c, 9.0) for c in range(4)]
    events.append(_ev("kernel", "vectorized_elementwise_kernel", 40.0, 3.0))
    s = summarize_trace(events)
    assert s["stiffness"] == (36.0, 4)
    assert s["elementwise"] == (3.0, 1)
    assert s["busy_us"] == pytest.approx(39.0)


def test_summarize_trace_counts_the_stack_and_chunk_kernels():
    """The main path's imported-mesh kernels: the pencil kernel on stacks
    and the chunk kernel (one launch a class each)."""
    stack = "void fustpu::pencil::pencil_kernel<float, 5, false, " \
        "fustpu::pencil::StackRows>(...)"
    chunk = "void (anonymous namespace)::chunk_kernel<float, 5, true>(...)"
    events = [_ev("kernel", stack, 0.0, 5.0), _ev("kernel", chunk, 5.0, 7.0),
              _ev("kernel", "vectorized_elementwise_kernel", 12.0, 1.0)]
    s = summarize_trace(events)
    assert s["stiffness"] == (12.0, 2)
    assert s["elementwise"] == (1.0, 1)
    assert s["busy_us"] == pytest.approx(13.0)


def test_summarize_trace_counts_the_corner_walk():
    """The capacity mode's walk: the pencil kernel, and its corner_kernel
    form with its own launch bounds, count as the stiffness group."""
    walk = "void fustpu::pencil::corner_kernel<float, 5, false, " \
        "fustpu::pencil::BoxRows, ...>(...)"
    pair = "void fustpu::pencil::pencil_kernel<float, 5, true, " \
        "fustpu::pencil::StackRows, ...>(...)"
    events = [_ev("kernel", walk, 0.0, 4.0), _ev("kernel", pair, 4.0, 5.0),
              _ev("kernel", "vectorized_elementwise_kernel", 9.0, 1.0)]
    s = summarize_trace(events)
    assert s["stiffness"] == (9.0, 2)
    assert s["elementwise"] == (1.0, 1)


def test_stiffness_bytes_counts_the_corner_channels():
    """In the capacity mode the geometry an apply must read is the corner
    channels (37 per cell), not a metric stream."""
    from fustpu_torch.config import Material, Source
    from fustpu_torch.mesh.box import build_box_mesh
    from fustpu_torch.models.linear import LinearWaveModel
    from fustpu_torch.tools.profile_step import _stiffness_bytes

    mesh = build_box_mesh((3, 2, 2), 2)
    model = LinearWaveModel(mesh, Material(), Source(),
                            mesh.boundary_facets("x-"), None,
                            dtype=torch.float32, device="cpu",
                            stiffness_impl="pallas_corner")
    field = mesh.ndofs * 4
    assert _stiffness_bytes(model.stiffness, mesh.ndofs) == \
        mesh.num_cells * 37 * 4 + 2 * field


def test_stiffness_bytes_counts_bf16_corner_channels():
    """The bf16 capacity mode's bytes: the corner channels and the fields
    at 2 bytes a value (the GLL nodes and weights, float32, are the
    kernel's constants, not the function's inputs)."""
    from fustpu_torch.config import Material, Source
    from fustpu_torch.mesh.box import build_box_mesh
    from fustpu_torch.models.linear import LinearWaveModel
    from fustpu_torch.tools.profile_step import _stiffness_bytes

    mesh = build_box_mesh((3, 2, 2), 2)
    model = LinearWaveModel(mesh, Material(), Source(),
                            mesh.boundary_facets("x-"), None,
                            dtype=torch.bfloat16, device="cpu",
                            stiffness_impl="pallas_corner")
    assert model.stiffness.T.dtype == torch.bfloat16
    assert _stiffness_bytes(model.stiffness, mesh.ndofs) == \
        mesh.num_cells * 37 * 2 + 2 * mesh.ndofs * 2


def test_profile_step_selects_runs_by_their_words():
    """`--only` keeps the runs whose demo arguments hold every word: the two
    bf16 engine bowls for `indexed_engine bf16`; every run for none."""
    from fustpu_torch.tools import profile_step as ps

    got = ps.selected(["indexed_engine", "bf16"])
    assert got == [ps.ENGINE + ps.BF16, ps.ENGINE + ps.BF16 + ["--two-layer"]]
    assert ps.selected([]) == list(ps.CONFIGS) and len(ps.CONFIGS) == 17


def test_summarize_trace_counts_the_engine_kernels():
    """The staged engine's three kernels count as the stiffness group, and
    an apply's minimum bytes are the indexed kernel's (G, dofmap, fields):
    the engine's stream and inverse map are its own traffic, not the
    function's."""
    from fustpu_torch.mesh.box import build_box_mesh
    from fustpu_torch.mesh.unstructured import from_box
    from fustpu_torch.models.discretization import (Discretization,
                                                    EngineStiffness)
    from fustpu_torch.tools.profile_step import _stiffness_bytes

    events = [
        _ev("kernel", "void engine_gather<float, 1>", 0.0, 2.0),
        _ev("kernel", "void engine_contract<float, 5, 0>", 2.0, 6.0),
        _ev("kernel", "void engine_scatter<float>", 8.0, 2.0),
        _ev("kernel", "vectorized_elementwise_kernel", 10.0, 1.0),
        _ev("kernel", "void <unnamed>::contract_ring<5, 0, <unnamed>::"
            "Ring<5, false>>(...)", 11.0, 3.0),
        _ev("kernel", "void <unnamed>::scatter_runs<64, 4>(...)", 14.0,
            1.0),
    ]
    s = summarize_trace(events)
    assert s["stiffness"] == (14.0, 5)
    assert s["elementwise"] == (1.0, 1)
    mesh = from_box(build_box_mesh((3, 2, 2), 2), shuffle_seed=1)
    op = Discretization(mesh).stiffness_op(torch.float32, "cpu", engine=True)
    nnn = 27
    assert _stiffness_bytes(EngineStiffness(op, "cuda"), mesh.ndofs) == \
        mesh.num_cells * (6 * nnn * 4 + nnn * 4) + 2 * mesh.ndofs * 4



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_least_bytes_read_each_input_once_and_write_y_once(dtype):
    """The bounds' least bytes of a stiffness apply: the geometry, each
    input field and the pair coefficients read once and y written once.
    A kernel that reads y back (a colour class adding to what earlier
    classes left) moves more, which its share of the bound shows; the
    function itself needs no read of y."""
    from fustpu_torch.demos import exp_imported, exp_kernel_anatomy, exp_pencil
    from fustpu_torch.mesh.box import build_box_mesh
    from fustpu_torch.models.discretization import Discretization
    from fustpu_torch.ops import anatomy
    from fustpu_torch.ops import cuda_corner as cc

    mesh = build_box_mesh((3, 2, 2), 2)
    disc = Discretization(mesh)
    b = torch.empty((), dtype=dtype).element_size()
    c1, c2 = np.full(mesh.nc, 1.5), np.full(mesh.nc, -0.5)
    op = disc.stiffness_op(dtype, "cpu")
    pop = disc.stiffness_op(dtype, "cpu", pair=(c1, c2))
    g, vec = op.G.numel() * b, mesh.ndofs * b
    coeffs = mesh.num_cells * 2 * b
    assert exp_pencil.least_bytes(op, mesh.ndofs, 1) == g + 2 * vec
    assert exp_pencil.least_bytes(pop, mesh.ndofs, 2) == \
        g + 3 * vec + coeffs
    assert exp_imported.least_bytes(op.G, mesh.ndofs, 1, 100) == \
        g + 2 * vec + 100
    assert exp_imported.least_bytes(op.G, mesh.ndofs, 2, 0) == \
        g + 3 * vec + coeffs
    for name in ("full", "gstream", "ywin"):
        assert anatomy.variant_cost(op, mesh.ndofs, name)[0] == g + 2 * vec
    assert anatomy.variant_cost(op, mesh.ndofs, "contract")[0] == 2 * vec
    assert exp_kernel_anatomy.pair_cost(pop, mesh.ndofs)[0] == \
        g + 3 * vec + coeffs
    if dtype == torch.float32:          # the corner mode has no bf16 form
        cop = disc.stiffness_op(dtype, "cpu", corner=True)
        t = cop.T.numel() * b
        assert cc.apply_cost(cop, mesh.ndofs, 1, 100)[0] == \
            t + 2 * vec + 100
        assert cc.apply_cost(cop, mesh.ndofs, 2)[0] == t + 3 * vec + coeffs

PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN6fustpu6pencil13pencil_kernelIfLi5ELb0EEEvv' for 'sm_90a'
ptxas info    : Function properties for _ZN6fustpu6pencil13pencil_kernelIfLi5ELb0EEEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 128 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN6fustpu6pencil13corner_kernelIdLi5ELb1EEEvv' for 'sm_90a'
ptxas info    : Function properties for _ZN6fustpu6pencil13corner_kernelIdLi5ELb1EEEvv
    24 bytes stack frame, 16 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 400 bytes cmem[0]
"""


def test_kernel_resources_parses_ptxas_report():
    rows = kernel_resources.parse(PTXAS)
    assert [r["mangled"][-20:] for r in rows] == [
        "kernelIfLi5ELb0EEEvv", "kernelIdLi5ELb1EEEvv"]
    assert [(r["registers"], r["spill_stores"], r["spill_loads"],
             r["stack"], r["smem"]) for r in rows] == [(128, 0, 0, 0, 128),
                                                       (96, 16, 8, 24, 0)]
    assert kernel_resources.parse("nothing compiled") == []


SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_113contract_ringILi5ELi0EEEvv
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/              @!P0 LDS.U16 R2, [R3+0x10] ;
        /*0020*/                   LDS R4, [R5] ;
        /*0030*/               @P1 STS [R6], R7 ;
        /*0040*/                   UBLKCP.S.G [UR4], [UR6], UR8 ;
        /*0050*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0060*/                   STG.E.128 desc[UR4][R8.64], R12 ;
        /*0070*/                   FFMA R9, R10, c[0x0][0x210], R9 ;
\t\tFunction : _ZN12_GLOBAL__N_112scatter_runsEv
        /*0000*/                   LDG.E.U16 R2, desc[UR4][R2.64] ;
        /*0010*/                   LDG.E.128.CONSTANT R4, desc[UR4][R6.64] ;
        /*0020*/                   EXIT ;
"""


def test_kernel_resources_counts_sass_memory_instructions():
    got = kernel_resources.parse_sass(SASS)
    assert set(got) == {"_ZN12_GLOBAL__N_113contract_ringILi5ELi0EEEvv",
                        "_ZN12_GLOBAL__N_112scatter_runsEv"}
    ring = got["_ZN12_GLOBAL__N_113contract_ringILi5ELi0EEEvv"]
    assert ring == dict(LDS=2, STS=1, LDG=0, STG=1, LDC=1, UBLKCP=1, BAR=1)
    assert got["_ZN12_GLOBAL__N_112scatter_runsEv"]["LDG"] == 2
    assert kernel_resources.parse_sass("no functions") == {}


def test_turns_runs_each_checkout_in_turns(tmp_path, capsys):
    a, b = tmp_path / "parent", tmp_path / "change"
    for d in (a, b):
        d.mkdir()
        (d / "which.txt").write_text(d.name)
    logs = turns.main(["--a", str(a), "--b", str(b), "--labels",
                       "parent,change", "--out", str(tmp_path / "out"),
                       "--grep", "tree", "--", sys.executable, "-c",
                       "print('tree', open('which.txt').read())"])
    assert [k for k in logs] == [("parent", 0), ("change", 1),
                                 ("change", 2), ("parent", 3)]
    assert all(out.split() == ["tree", label]
               for (label, _), out in logs.items())
    text = capsys.readouterr().out
    assert "[parent 3] tree parent" in text and "[change 1] rc 0" in text
    assert len(list((tmp_path / "out").glob("*.log"))) == 4
    with pytest.raises(SystemExit, match="failed"):
        turns.main(["--a", str(a), "--b", str(b), "--out",
                    str(tmp_path / "out"), "--", sys.executable, "-c",
                    "raise SystemExit(3)"])
