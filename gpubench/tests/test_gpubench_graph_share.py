"""The readers of the decoder's step counters (``metrics/graph_share.lines``,
``metrics/graph_share.pages``): the counters fed by hand and by a step loop
recorded on the CPU (which runs every step eagerly), the share computed,
and nothing without traced calls or counted steps."""
import numpy as np
import pytest
import torch

from harness import spec
from harness.cell import reader
from kiri_tpu_torch.config import CFG
from kiri_tpu_torch.models.recognizer import Recognizer
from kiri_tpu_torch.ops import decode as D
from kiri_tpu_torch.utils import profiling

NAMES = ("graph_share.lines", "graph_share.pages")
CELLS = {"graph_share.lines": ("lines-accurate", "lines_per_s"),
         "graph_share.pages": ("pages-batch", "pages_per_s")}


def rec(traced=()):
    return {"setup_s": 1.0, "calls": list(traced), "untraced": [],
            "traced": list(traced), "trace": None}


@pytest.fixture(autouse=True)
def clean_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


@pytest.mark.parametrize("name", NAMES)
def test_listed_in_the_benchmark(name):
    m = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}[name]
    assert m["source"] == "program_counter" and m["unit"] == "%"
    assert (m["workloads"], m["moves"]) == ([CELLS[name][0]], CELLS[name][1])
    assert m["layer"] == ("engine.RecognizerEngine decoder paths over "
                          "ops/decode")
    assert (spec.HERE / "metrics" / f"{name}.py").exists()


@pytest.mark.parametrize("name", NAMES)
def test_share_of_the_counted_steps(name):
    one = rec([{"items": 128}])
    assert reader(name)(one) is None                 # no step counted
    profiling.count("decode.graph_steps", 36)        # not recording: lost
    assert reader(name)(one) is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        profiling.count("decode.graph_steps", 36)
        profiling.count("decode.eager_steps", 4)
    assert reader(name)(one) == pytest.approx(90.0)
    assert reader(name)(rec()) is None               # no traced call
    profiling.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        profiling.count("decode.graph_steps", 8)
    assert reader(name)(one) == pytest.approx(100.0)


def test_a_recorded_cpu_step_loop_reads_zero():
    cfg = CFG(ENC_DIM=64, ENC_LAYERS=1, ENC_FF=128, ENC_HEADS=4, DEC_DIM=64,
              DEC_LAYERS=1, DEC_FF=128, DEC_HEADS=4, MAX_DEC_LEN=64,
              COMPUTE_DTYPE="float32")
    model = Recognizer(cfg, 7).init_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    memp = torch.from_numpy(rng.normal(0, 1, (3, 12, 64)).astype(np.float32))
    tl = torch.tensor([0, 4, 6], dtype=torch.int32)
    with torch.inference_mode(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = D.greedy_decode(model, memp, tl, cfg=cfg, l_cap=16)
    steps = profiling.counters()["decode.eager_steps"]
    assert steps >= int(out.hist_steps.max()) >= 1
    for name in NAMES:
        assert reader(name)(rec([{"items": 3}])) == 0.0
