"""The decoder's step loops as CUDA graphs (``ops/decode.py``'s
``_step_loop``): on the card the graphed ``beam_search`` (K = 1 and 3, with
and without its history) and ``greedy_decode`` give the eager steps' bits
on the same device, a second loop of the same shapes captures nothing, a
loop first met while a profiler records stays eager, a decoder on a card
that is not the current one replays on its own card, the graphs' buffers
stay under their bytes, and a copy of the model (as
``parallel.shard_variables`` makes) captures its own; on the CPU and for
a tensor-parallel model nothing is captured. A small random decoder (2
layers, width 64, 4 heads); no JAX.

The tests marked ``card`` skip without a CUDA device. On a machine with
one: ``python -m pytest -p no:cacheprovider --noconftest
tests/test_torch_decode_graphs.py``."""
from __future__ import annotations

import copy
import pickle
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kiri_tpu_torch.config import CFG
from kiri_tpu_torch.models.recognizer import Recognizer
from kiri_tpu_torch.ops import decode as D
from kiri_tpu_torch.utils import profiling

# The EOS bias holds the random model's lines open for a few steps and
# then pushes them to end, so loops take several chunks.
SMALL = CFG(ENC_DIM=64, ENC_LAYERS=1, ENC_FF=128, ENC_HEADS=4, DEC_DIM=64,
            DEC_LAYERS=2, DEC_FF=128, DEC_HEADS=4, MAX_DEC_LEN=64,
            COMPUTE_DTYPE="float32", STEP_BUCKETS=(16, 32, 64),
            EOS_LOGP_BIAS=6.0, EOS_LOGP_BOOST=2.0, EOS_BIAS_UNTIL_LEN=7)
ACTS = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
VOCAB = 7                          # characters with <unk>: 10 decoder ids
L_CAP = 32
# (k_beam, record_history) for beam_search; None for greedy_decode.
LOOPS = {"beam1": (1, False), "beam3": (3, False), "beam1-history": (1, True),
         "beam3-history": (3, True), "greedy": None}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the machine with the card)")
    return torch.device("cuda")


def _model(device) -> Recognizer:
    model = Recognizer(SMALL, VOCAB)
    model.init_weights(torch.Generator().manual_seed(0))
    return model.to(device).eval()


def _inputs(seed: int, device, dtype, n: int = 6, t_mem: int = 20):
    rng = np.random.default_rng(seed)
    memp = torch.from_numpy(rng.normal(0, 1, (n, t_mem, 64)).astype(
        np.float32)).to(device, dtype)
    ctc = torch.from_numpy(rng.normal(0, 2, (n, t_mem, VOCAB + 2)).astype(
        np.float32)).to(device)
    tl = torch.from_numpy(rng.integers(0, 12, n).astype(np.int32)).to(device)
    conf = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)).to(
        device)
    return memp, ctc, tl, conf


def _decode(model, loop: str, seed: int, device, dtype=torch.bfloat16,
            n: int = 6):
    memp, ctc, tl, conf = _inputs(seed, device, dtype, n)
    with torch.inference_mode():
        if LOOPS[loop] is None:
            return D.greedy_decode(model, memp, tl, cfg=SMALL, l_cap=L_CAP)
        k, hist = LOOPS[loop]
        return D.beam_search(model, memp, ctc, tl, conf, cfg=SMALL,
                             k_beam=k, l_cap=L_CAP, record_history=hist)


def _equal(a: D.DecodeOut, b: D.DecodeOut) -> None:
    for name, x, y in zip(a._fields, a, b):
        assert (x is None) == (y is None), name
        if x is not None:
            assert torch.equal(x, y), name


def _graphs(model, dtype=torch.bfloat16) -> D.StepGraphs:
    return model.decoder_weights(dtype).step_graphs


@pytest.mark.card
@pytest.mark.parametrize("loop", list(LOOPS))
def test_graphed_step_loops_equal_the_eager_steps(card, loop, monkeypatch):
    model = _model(card)
    first = _decode(model, loop, 1, card)
    graphs = _graphs(model)
    assert graphs.captures == 1
    assert int(first.hist_steps.max()) > 2 * D.POLL_EVERY   # several chunks
    second = _decode(model, loop, 2, card)        # other data, same shapes
    assert graphs.captures == 1
    again = _decode(model, loop, 1, card)
    _equal(first, again)
    monkeypatch.setattr(D, "_step_graphs", lambda *a: None)
    _equal(first, _decode(model, loop, 1, card))
    _equal(second, _decode(model, loop, 2, card))
    assert graphs.captures == 1


@pytest.mark.card
def test_a_loop_met_under_the_profiler_stays_eager(card):
    model = _model(card)
    profiling.reset_counters()
    with profile(activities=ACTS):
        under = _decode(model, "beam3", 1, card)
    assert _graphs(model).captures == 0
    eager = profiling.counters()
    assert eager.get("decode.eager_steps", 0) > 0
    assert "decode.graph_steps" not in eager
    outside = _decode(model, "beam3", 1, card)
    assert _graphs(model).captures == 1
    _equal(under, outside)
    profiling.reset_counters()
    with profile(activities=ACTS):
        replayed = _decode(model, "beam3", 1, card)
    _equal(under, replayed)
    c = profiling.counters()
    assert c.get("decode.graph_steps", 0) > 0
    assert "decode.eager_steps" not in c
    profiling.reset_counters()


@pytest.mark.card
@pytest.mark.parametrize("loop", list(LOOPS))
def test_a_loop_on_another_card_replays_there(card, loop, monkeypatch):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    other = torch.device("cuda", torch.cuda.device_count() - 1)
    assert torch.cuda.current_device() != other.index
    model = _model(other)
    first = _decode(model, loop, 1, other)
    again = _decode(model, loop, 1, other)
    assert _graphs(model).captures == 1
    monkeypatch.setattr(D, "_step_graphs", lambda *a: None)
    eager = _decode(model, loop, 1, other)
    _equal(first, eager)
    _equal(again, eager)


@pytest.mark.card
def test_the_graphs_buffers_stay_under_their_bytes(card, monkeypatch):
    model = _model(card)
    graphs = _graphs(model)
    _decode(model, "beam3", 1, card, n=8)
    big = graphs.nbytes
    monkeypatch.setattr(D, "MAX_STEP_GRAPH_BYTES", 4 * big)
    for n in range(1, 8):              # 4.5 times ``big`` in all
        _decode(model, "beam3", 1, card, n=n)
        assert graphs.nbytes <= 4 * big
    assert graphs.captures == 8 and len(graphs.graphs) < 8
    assert graphs.nbytes == sum(g.nbytes for g in graphs.graphs.values())
    # A loop whose buffers pass a quarter of the bytes runs eagerly.
    monkeypatch.setattr(D, "MAX_STEP_GRAPH_BYTES", 4 * big - 1)
    model = _model(card)
    out = _decode(model, "beam3", 1, card, n=8)
    assert _graphs(model).captures == 0
    monkeypatch.setattr(D, "_step_graphs", lambda *a: None)
    _equal(out, _decode(model, "beam3", 1, card, n=8))


@pytest.mark.card
def test_a_copy_of_the_model_captures_its_own_graphs(card):
    model = _model(card)
    first = _decode(model, "beam3", 1, card)
    twin = copy.deepcopy(model)
    assert _graphs(twin).captures == 0 and _graphs(model).captures == 1
    _equal(first, _decode(twin, "beam3", 1, card))
    assert _graphs(twin).captures == 1


def test_a_copy_of_the_graphs_starts_empty():
    graphs = D.StepGraphs()
    graphs.graphs["key"] = threading.Lock()     # copies as a graph would not
    graphs.captures, graphs.nbytes = 1, 64
    for twin in (copy.deepcopy(graphs), pickle.loads(pickle.dumps(graphs))):
        assert isinstance(twin, D.StepGraphs) and not twin.graphs
        assert twin.captures == twin.nbytes == 0


@pytest.mark.parametrize("model_size", [None, 1, 2])
def test_graphs_engage_on_the_card_unless_tensor_parallel(model_size):
    model = _model("cpu")
    if model_size is not None:                  # as shard_variables leaves it
        model.mesh = SimpleNamespace(model_size=model_size)
    cuda = torch.device("cuda")
    assert D._step_graphs(model, torch.float32, torch.device("cpu")) is None
    graphs = D._step_graphs(model, torch.float32, cuda)
    assert (graphs is None) == (model_size == 2)
    assert graphs is None or graphs is _graphs(model, torch.float32)


def test_graph_bytes_count_each_storage_once(monkeypatch):
    x = torch.zeros(10, 4)                                    # 160 bytes
    y = torch.zeros(3, dtype=torch.int32)                     # 12
    assert D._nbytes((x, x[1:], x.t(), y, y)) == 172
    monkeypatch.setattr(D, "MAX_STEP_GRAPH_BYTES", 4 * 172)
    assert D.StepGraphs.holds((x, y))
    assert not D.StepGraphs.holds((x, y, torch.zeros(1)))


@pytest.mark.parametrize("loop", ["beam1", "beam3-history", "greedy"])
def test_cpu_step_loops_never_capture(loop):
    model = _model("cpu")
    _decode(model, loop, 1, "cpu", torch.float32)
    graphs = _graphs(model, torch.float32)
    assert graphs.captures == 0 and not graphs.graphs
