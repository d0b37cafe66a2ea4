"""The step profiler's trace reduction (fustpu_torch.tools.profile_step) on
a hand-made Chrome trace: grouping, launch counts and the busy union."""

import pytest
import torch

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
        mesh.num_cells * 37 * 4 + 3 * field
