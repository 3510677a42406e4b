"""The port's spans and its host-wait counter (kiri_tpu_torch/utils/
profiling.py): free with no profiler recording; under ``trace`` the
engine's, the decoder's, the detector's and the page pipeline's spans show
as ``record_function`` ranges, nested and never overlapping otherwise, and
``host_waits`` counts each wait for the device once. On the CPU, with the
small random recognizer of tests/test_torch_decoder_layers.py and the
committed DB detector on two small crops of the smoke pages."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from test_torch_decoder_layers import few_torch_threads, make_small_model  # noqa: F401
from torch_pages import DET, small_ckpt, smoke_pages  # noqa: F401

from kiri_tpu_torch.engine import RecognizerEngine
from kiri_tpu_torch.utils import profiling as prof
from kiri_tpu_torch.utils.profiling import StageTimer, annotate, trace

ENGINE_SPANS = ("engine.group", "engine.upload", "engine.encode",
                "engine.fetch", "engine.texts")
DETECT_SPANS = ("detect.resize", "detect.forward", "detect.wait",
                "detect.boxes", "detect.layout")


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    _, _, _, model, cfg, tok = make_small_model(
        tmp_path_factory.mktemp("spans"), EOS_LOGP_BIAS=6.0,
        EOS_LOGP_BOOST=2.0, EOS_BIAS_UNTIL_LEN=7)
    return model, cfg, tok


def _lines(n=5, seed=9):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 255, (n, 48, 160), dtype=np.uint8)
    return imgs, np.asarray([160, 96, 160, 64, 160][:n], np.int32)


def _ranges(logdir):
    """[(name, start, end)] of the trace's ``record_function`` ranges, in
    microseconds."""
    files = sorted(logdir.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _inside(a, b, eps=1.0):
    return b[1] - eps <= a[1] and a[2] <= b[2] + eps


def _assert_nested(ranges, eps=1.0):
    """Any two ranges are disjoint or one holds the other."""
    rs = sorted(ranges, key=lambda r: (r[1], -r[2]))
    for i, a in enumerate(rs):
        for b in rs[i + 1:]:
            if b[1] >= a[2] - eps:
                break
            assert _inside(b, a, eps), (a, b)


def _traced(tmp_path, fn):
    prof.reset_counters()
    with trace(str(tmp_path)):
        with annotate("test.call"):
            out = fn()
    return out, _ranges(tmp_path), prof.counters()


def _names(ranges, name):
    return [r for r in ranges if r[0] == name]


def test_spans_are_free_without_a_profiler(small, monkeypatch):
    model, cfg, tok = small

    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    prof.reset_counters()
    eng = RecognizerEngine(model, cfg, tok, device="cpu")
    imgs, widths = _lines()
    for method in ("ctc", "decoder"):
        assert len(eng.recognize_batch(imgs, method, widths)) == len(imgs)
    with annotate("x"):
        prof.count("host_waits")
    assert prof.counters() == {}


def test_stage_timer_keeps_totals_without_a_profiler(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", None)
    timer = StageTimer()
    for _ in range(2):
        with timer.stage("detect"):
            torch.ones(8).sum()
    assert timer.counts["detect"] == 2 and timer.totals["detect"] > 0


def test_ctc_call_spans_and_one_wait(small, tmp_path):
    model, cfg, tok = small
    eng = RecognizerEngine(model, cfg, tok, device="cpu")
    imgs, widths = _lines()
    out, ranges, counts = _traced(
        tmp_path, lambda: eng.recognize_batch(imgs, "ctc", widths))
    assert len(out) == len(imgs)
    for name in ENGINE_SPANS:
        assert _names(ranges, name), name
    _assert_nested(ranges)
    call = _names(ranges, "test.call")[0]
    assert all(_inside(r, call) for r in ranges)
    group = _names(ranges, "engine.group")
    for name in ("engine.upload", "engine.encode"):
        assert all(any(_inside(r, g) for g in group)
                   for r in _names(ranges, name))
    assert counts == {"host_waits": 1}


def test_decoder_call_waits_once_a_round_and_a_fetch(small, tmp_path,
                                                     monkeypatch):
    model, cfg, tok = small
    forwards = []
    heads = model.decoder_forward_heads
    monkeypatch.setattr(model, "decoder_forward_heads",
                        lambda *a, **k: forwards.append(1) or heads(*a, **k))
    eng = RecognizerEngine(model, cfg.replace(ACCURATE_CTC_RESCORE=False),
                           tok, device="cpu")
    imgs, widths = _lines()
    _, ranges, counts = _traced(
        tmp_path, lambda: eng.recognize_batch(imgs, "decoder", widths))
    assert eng.fallback_rows == 0
    specs = _names(ranges, "decode.spec")
    rounds = _names(ranges, "decode.round")
    assert specs and rounds
    assert all(any(_inside(r, s) for s in specs) for r in rounds)
    # One round a pass of the loop: each forward, and the pass that finds
    # no row active.
    assert 0 <= len(rounds) - len(forwards) <= len(specs)
    _assert_nested(ranges)
    fetches = _names(ranges, "engine.fetch")
    assert counts == {"host_waits": len(rounds) + len(fetches)}


def test_fallback_shows_the_step_loop(small, tmp_path):
    model, cfg, tok = small
    one = cfg.replace(SPEC_MAX_ROUNDS=1, ACCURATE_CTC_RESCORE=False)
    eng = RecognizerEngine(model, one, tok, device="cpu")
    imgs, widths = _lines()
    _, ranges, counts = _traced(
        tmp_path, lambda: eng.recognize_batch(imgs, "decoder", widths))
    assert eng.fallback_rows == len(imgs)
    loops = _names(ranges, "decode.step_loop")
    assert loops
    _assert_nested(ranges)
    rounds, fetches = (len(_names(ranges, n))
                       for n in ("decode.round", "engine.fetch"))
    # Each step loop's polls wait too.
    assert counts["host_waits"] >= rounds + fetches


def test_process_documents_spans_and_stages(small_ckpt, smoke_pages,
                                            tmp_path):
    from kiri_tpu_torch.pipeline import OCR

    pages = [smoke_pages["pages"][0]["image"][:224, :320],
             smoke_pages["pages"][4]["image"][:160, :480]]
    ocr = OCR(small_ckpt, det_model_path=DET, device="cpu",
              decode_method="fast")
    out, ranges, counts = _traced(tmp_path,
                                  lambda: ocr.process_documents(pages))
    assert len(out) == 2 and any(out)
    for name in DETECT_SPANS + ENGINE_SPANS:
        assert _names(ranges, name), name
    _assert_nested(ranges)
    stages = ocr.last_timer.totals
    assert set(stages) == {"detect", "preprocess", "recognize"}
    assert ocr.last_timer.counts["preprocess"] == len(pages)
    for name in ("detect.resize", "detect.forward", "detect.wait",
                 "detect.boxes", "detect.layout"):
        assert all(any(_inside(r, d) for d in _names(ranges, "detect"))
                   for r in _names(ranges, name)), name
    assert all(any(_inside(r, d) for d in _names(ranges, "recognize"))
               for r in _names(ranges, "engine.encode"))
    # On the CPU the maps are copied as they are made: only the engine's
    # fetch waits.
    assert counts == {"host_waits": 1}
