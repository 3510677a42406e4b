"""Each metric reader on a recorded trace and recorded calls."""
import json

import pytest
import torch

from harness import trace as T
from harness.cell import reader

# A slice of two calls: kernels overlap once, one memcpy, a stage range.
EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": T.CALL_RANGE,
     "ts": 1000.0, "dur": 1000.0},
    {"ph": "X", "cat": "user_annotation", "name": T.CALL_RANGE,
     "ts": 2000.0, "dur": 1000.0},
    {"ph": "X", "cat": "user_annotation", "name": "detect",
     "ts": 1500.0, "dur": 500.0},
    {"ph": "X", "cat": "kernel", "name": "void stem_conv01_kernel<1>()",
     "ts": 1100.0, "dur": 200.0},
    {"ph": "X", "cat": "kernel", "name": "void stem_layer_kernel<2>()",
     "ts": 1200.0, "dur": 200.0},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
     "ts": 2500.0, "dur": 100.0},
    {"ph": "X", "cat": "kernel", "name": "outside", "ts": 5000.0,
     "dur": 50.0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1100.0,
     "dur": 10.0},
]


def rec(trace=None):
    calls = [{"t0": 0.0, "t1": 0.5, "items": 128, "flops": 2.0e11,
              "fallback": 4, "stem_least_s": 1.5e-4,
              "stages": {"detect": 0.06, "recognize": 0.02}},
             {"t0": 0.5, "t1": 1.0, "items": 128, "flops": 2.0e11,
              "fallback": 0, "stem_least_s": 1.5e-4,
              "stages": {"detect": 0.08, "recognize": 0.04}}]
    return {"setup_s": 12.5, "calls": calls, "untraced": calls,
            "traced": calls[:1], "trace": trace}


def test_parse_union_and_gaps():
    tr = T.parse(EVENTS)
    assert tr["window_s"] == pytest.approx(2000e-6)
    assert tr["busy_s"] == pytest.approx(400e-6)       # 1100-1400, 2500-2600
    assert tr["kernels"]["Memcpy HtoD"] == pytest.approx(100e-6)
    assert "outside" not in tr["kernels"]
    assert sum(tr["idle"].values()) == pytest.approx(1600e-6)
    assert tr["idle"]["detect"] == pytest.approx(1100e-6)
    assert tr["idle"][T.CALL_RANGE] == pytest.approx(500e-6)
    b = T.breakdown(tr)
    assert b["device_ops"][0][0].startswith("void stem_")
    assert len(b["idle_gaps"]) <= 10


def test_parse_a_recorded_cpu_trace(tmp_path):
    with T.profiled() as tr:
        with torch.profiler.record_function(T.CALL_RANGE):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert tr["window_s"] > 0 and tr["busy_s"] == 0.0
    assert reader("device_idle.lines")(rec(tr)) == pytest.approx(100.0)
    assert reader("stem_roofline")(rec(tr)) is None


def test_host_clock_readers():
    r = rec()
    assert reader("lines_per_s")(r) == pytest.approx(256.0)
    assert reader("pages_per_s")(r) == pytest.approx(256.0)
    assert reader("page_p95_ms")(r) == pytest.approx(500.0)
    assert reader("setup_s")(r) == 12.5
    assert reader("mfu.lines")(r) == pytest.approx(
        100 * 4e11 / (1.0 * 989e12))
    assert reader("mfu.pages")(r) == reader("mfu.lines")(r)
    assert reader("fallback_share")(r) == pytest.approx(100 * 4 / 256)
    assert reader("stage_ms.detect")(r) == pytest.approx(70.0)
    assert reader("stage_ms.recognize")(r) == pytest.approx(30.0)


def test_trace_readers():
    r = rec(T.parse(EVENTS))
    assert reader("device_idle.pages")(r) == pytest.approx(80.0)
    assert reader("stem_roofline")(r) == pytest.approx(
        100 * 1.5e-4 / 400e-6)
    assert reader("device_idle.lines")(rec()) is None


def test_readers_return_nothing_without_data():
    empty = {"setup_s": 1.0, "calls": [], "untraced": [], "traced": [],
             "trace": None}
    for name in ("mfu.lines", "fallback_share", "stage_ms.detect",
                 "stem_roofline", "device_idle.pages"):
        assert reader(name)(empty) is None
    assert json.dumps(T.parse([]))
