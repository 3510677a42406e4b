"""The readers of the program's spans and counter (``metrics/idle.*``,
``metrics/host_waits.lines``, ``harness/spans.py``): on a synthetic trace
that carries the program's span names, on a program without spans, with
nothing to read, and on a trace recorded on the CPU around a small
``recognize_batch``."""
import numpy as np
import pytest
import torch

from harness import spec
from harness import trace as T
from harness.cell import reader

IDLE = ("idle.encode", "idle.engine_host", "idle.decode",
        "idle.detect_host", "idle.detect_net", "idle.crops",
        "idle.page_recognize")


def _span(name, a, b):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": float(a),
            "dur": float(b - a)}


# Two calls of 1000 us: a lines call and a page call. A 10 us kernel starts
# every 50 us, so each 40 us gap has its middle in exactly one innermost
# span, and a span of length d holds 0.8 d of idle.
SPANS = [
    (T.CALL_RANGE, 1000, 2000), (T.CALL_RANGE, 2000, 3000),
    ("engine.group", 1000, 1300), ("engine.upload", 1000, 1100),
    ("engine.encode", 1100, 1300), ("engine.fetch", 1300, 1400),
    ("engine.texts", 1400, 1500), ("decode.spec", 1500, 1900),
    ("decode.round", 1500, 1700), ("decode.step_loop", 1700, 1900),
    ("detect", 2000, 2600), ("detect.resize", 2000, 2100),
    ("detect.forward", 2100, 2200), ("detect.wait", 2200, 2300),
    ("detect.boxes", 2300, 2400), ("detect.layout", 2400, 2500),
    ("preprocess", 2600, 2800), ("recognize", 2800, 3000),
    ("engine.encode", 2800, 2900)]
KERNELS = [{"ph": "X", "cat": "kernel", "name": "k", "ts": float(t),
            "dur": 10.0} for t in range(1000, 3000, 50)]
# Idle under each reader's spans (us) over the 2000 us slice.
WANT = {"idle.encode": 300, "idle.engine_host": 300, "idle.decode": 400,
        "idle.detect_host": 400, "idle.detect_net": 100, "idle.crops": 200,
        "idle.page_recognize": 1000}


def rec(trace=None, traced=()):
    return {"setup_s": 1.0, "calls": list(traced), "untraced": [],
            "traced": list(traced), "trace": trace}


def test_listed_in_the_benchmark():
    per_layer = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}
    for name in IDLE + ("host_waits.lines",):
        m = per_layer[name]
        assert m["source"] == ("program_counter" if name.startswith("host")
                               else "program_span")
        assert (spec.HERE / "metrics" / f"{name}.py").exists()


def test_idle_readers_on_the_program_spans():
    tr = T.parse([_span(*s) for s in SPANS] + KERNELS)
    assert tr["window_s"] == pytest.approx(2000e-6)
    assert tr["idle"]["detect"] == pytest.approx(80e-6)
    for name, us in WANT.items():
        assert reader(name)(rec(tr)) == pytest.approx(100 * 0.8 * us / 2000)
    # The named spans and the coarse ranges share out the whole idle.
    named = sum(reader(n)(rec(tr)) for n in
                ("idle.page_recognize", "idle.detect_host",
                 "idle.detect_net", "idle.crops"))
    coarse = sum(tr["idle"][k] for k in ("detect", "recognize", T.CALL_RANGE))
    assert named + 100 * coarse / tr["window_s"] == pytest.approx(
        100 * (1 - tr["busy_s"] / tr["window_s"]))


def test_readers_return_nothing_without_data():
    empty = rec()
    for name in IDLE + ("host_waits.lines",):
        assert reader(name)(empty) is None
    # A program that records no spans: its slice has only the harness's
    # call ranges and the pipeline's stages.
    old = T.parse([_span(*s) for s in SPANS
                   if "." not in s[0] or s[0] == T.CALL_RANGE] + KERNELS)
    assert old["idle"] and all(reader(n)(rec(old)) is None for n in IDLE)


@pytest.fixture
def small_engine():
    from kiri_tpu_torch.engine import RecognizerEngine

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield RecognizerEngine.from_checkpoint(
        str(spec.ROOT / "models" / "model.safetensors"), device="cpu")
    torch.set_num_threads(before)


def test_a_recorded_slice_is_put_to_the_engine(small_engine):
    from kiri_tpu_torch.utils.profiling import reset_counters

    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 255, (3, 48, 320), dtype=np.uint8)
    widths = np.asarray([300, 150, 320])
    reset_counters()
    with T.profiled() as tr:
        with torch.profiler.record_function(T.CALL_RANGE):
            out = small_engine.recognize_batch(imgs, "ctc", widths)
    assert len(out) == 3
    assert tr["idle"] and T.CALL_RANGE not in tr["idle"]
    assert all(k.startswith("engine.") for k in tr["idle"])
    r = rec(tr, traced=[{"items": 3}])
    assert reader("idle.encode")(r) + reader("idle.engine_host")(r) == \
        pytest.approx(100.0)
    assert reader("host_waits.lines")(r) == 1.0
    assert reader("host_waits.lines")(rec(tr)) is None
