"""kiri_tpu_torch's RecognizerEngine on the CPU at float32: every method on
the committed checkpoint against kiri_tpu's answers stored with the smoke
lines (texts equal, confidences within 1e-4), the CTC path also against
kiri_tpu's engine live. tests/test_torch_engine_small.py holds every
method, the step-loop fallback and 4-bit uploads against kiri_tpu's engine
live on a small random model."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
from test_torch_decoder_layers import few_torch_threads  # noqa: F401

from kiri_tpu.engine import RecognizerEngine as JEngine
from kiri_tpu.tokenizer import CharTokenizer as JTok
from kiri_tpu.train.checkpoints import find_vocab_file as j_vocab
from kiri_tpu.train.checkpoints import load_checkpoint as j_load
from kiri_tpu_torch.engine import RecognizerEngine
from kiri_tpu_torch.smoke import load_smoke_lines

REPO = Path(__file__).resolve().parent.parent
CKPT = str(REPO / "models" / "model.safetensors")
N_LIVE = 12     # lines also run through kiri_tpu's engine in this test


@pytest.fixture(scope="module")
def smoke():
    return load_smoke_lines()


@pytest.fixture(scope="module")
def engine():
    eng = RecognizerEngine.from_checkpoint(CKPT, device="cpu")
    return RecognizerEngine(eng.model, eng.cfg.replace(COMPUTE_DTYPE="float32"),
                            eng.tok, device="cpu")


@pytest.fixture(scope="module")
def jax_engine():
    variables, cfg, meta = j_load(CKPT)
    cfg = cfg.replace(COMPUTE_DTYPE="float32")
    return JEngine(variables, cfg, JTok(j_vocab(meta["vocab_path"], CKPT),
                                        cfg))


def _check(res, texts, conf):
    assert [t for t, _ in res] == [str(t) for t in texts]
    np.testing.assert_allclose([c for _, c in res], conf, atol=1e-5)


def test_recognize_batch_matches_smoke_texts(engine, smoke):
    d, _ = smoke
    res = engine.recognize_batch(d["imgs"], "ctc", d["widths"])
    _check(res, d["batch_texts_f32"], d["batch_conf_f32"])


def test_recognize_crops_matches_smoke_texts(engine, smoke):
    d, crops = smoke
    _check(engine.recognize_crops(crops, "ctc"), d["crops_texts_f32"],
           d["crops_conf_f32"])


@pytest.mark.parametrize("path", ["batch", "bucketed", "crops"])
def test_matches_kiri_tpu_engine(engine, jax_engine, smoke, path):
    d, crops = smoke
    imgs, widths = d["imgs"][:N_LIVE], d["widths"][:N_LIVE]
    if path == "batch":
        ours = engine.recognize_batch(imgs, "ctc")
        ref = jax_engine.recognize_batch(imgs, "ctc")
    elif path == "bucketed":
        ours = engine.recognize_batch(imgs, "ctc", widths)
        ref = jax_engine.recognize_batch(imgs, "ctc", widths=widths)
    else:
        ours = engine.recognize_crops(crops[:N_LIVE], "ctc")
        ref = jax_engine.recognize_crops(crops[:N_LIVE], "ctc")
    _check(ours, [t for t, _ in ref], [c for _, c in ref])


def test_empty_and_encode_batch(engine, smoke):
    d, _ = smoke
    assert engine.recognize_batch(np.zeros((0, 48, 640), np.uint8),
                                  "ctc") == []
    assert engine.recognize_crops([], "ctc") == []
    memp, ctc, ids, conf, est, n = engine.encode_batch(d["imgs"][:3])
    assert n == 3 and tuple(ctc.shape) == (4, 160, 210)
    assert tuple(memp.shape) == (4, 160, 256) and tuple(ids.shape) == (4, 160)


def test_enhance_and_spec_beam_run_bad_arguments_raise(engine, smoke):
    """``enhance=True`` and ``cfg.SPEC_BEAM`` run (they raised before the
    port had them); an unknown method and ``upload_bits=3`` raise
    ValueError."""
    d, crops = smoke
    res = engine.recognize_crops(crops[:2], "ctc", enhance=True)
    assert len(res) == 2 and all(isinstance(t, str) for t, _ in res)
    spec_beam = RecognizerEngine(engine.model,
                                 engine.cfg.replace(SPEC_BEAM=True),
                                 engine.tok, device="cpu")
    assert len(spec_beam.recognize_batch(d["imgs"][:2], "beam")) == 2
    assert len(spec_beam.recognize_batch(d["imgs"][:2], "ctc")) == 2
    with pytest.raises(ValueError, match="method"):
        engine.recognize_batch(d["imgs"][:2], "greedy")
    with pytest.raises(ValueError, match="method"):
        engine.recognize_crops(crops[:2], "warp", enhance=True)
    with pytest.raises(ValueError):
        RecognizerEngine(engine.model, engine.cfg, engine.tok, device="cpu",
                         upload_bits=3)


# ------------------------------------------ decoder paths, the checkpoint
def _check_stored(res, d, key):
    assert [t for t, _ in res] == [str(t) for t in d[f"{key}_texts_f32"]]
    np.testing.assert_allclose([c for _, c in res], d[f"{key}_conf_f32"],
                               atol=1e-4)
    assert all(isinstance(c, float) and 0.0 <= c <= 1.0 for _, c in res)


@pytest.mark.parametrize("method", ["decoder", "beam", "auto"])
def test_decoder_paths_match_stored_kiri_tpu_answers(engine, smoke, method):
    d, _ = smoke
    _check_stored(engine.recognize_batch(d["imgs"], method, d["widths"]), d,
                  f"batch_{method}")


def test_crops_decoder_matches_stored_kiri_tpu_answers(engine, smoke):
    d, crops = smoke
    _check_stored(engine.recognize_crops(crops, "decoder"), d, "crops_decoder")


def test_auto_escalates_low_confidence_rows(engine, smoke):
    """Under the fixture's raised threshold 25 of the 64 lines go to beam
    search and the others keep their CTC result."""
    d, _ = smoke
    thr = float(d["auto_escalate_threshold"])
    assert float(d["auto_margin_f32"]) >= 1e-3
    low = d["batch_conf_f32"] < thr
    assert 0 < low.sum() < len(low)
    eng = RecognizerEngine(engine.model,
                           engine.cfg.replace(AUTO_CONF_THRESHOLD=thr),
                           engine.tok, device="cpu")
    res = eng.recognize_batch(d["imgs"], "auto", d["widths"])
    _check_stored(res, d, "batch_auto_escalated")
    for (text, conf), is_low, ctc, beam in zip(
            res, low, zip(d["batch_texts_f32"], d["batch_conf_f32"]),
            zip(d["batch_beam_texts_f32"], d["batch_beam_conf_f32"])):
        want = beam if is_low else ctc
        assert text == str(want[0]) and abs(conf - want[1]) < 1e-4


def test_round_budget_sends_rows_through_the_step_loop(engine, smoke):
    """SPEC_MAX_ROUNDS=1: lines whose draft needs more than one correction
    are decoded again by the step loop and read as kiri_tpu reads them. (At
    the default budget of 8 rounds one smoke line takes that way too.)"""
    d, _ = smoke
    eng = RecognizerEngine(engine.model,
                           engine.cfg.replace(SPEC_MAX_ROUNDS=1), engine.tok,
                           device="cpu")
    _check_stored(eng.recognize_batch(d["imgs"], "decoder", d["widths"]), d,
                  "batch_decoder_rounds1")
    assert eng.fallback_rows >= 2


@pytest.mark.parametrize("method", ["ctc", "decoder", "beam", "auto"])
def test_batch_of_three_reads_as_in_a_batch_of_eight(engine, smoke, method):
    """3 is no batch bucket: the batch is padded to 4, and the padding rows
    neither show nor change the others."""
    d, _ = smoke
    imgs = d["imgs"][16:24]
    three = engine.recognize_batch(imgs[:3], method)
    eight = engine.recognize_batch(imgs, method)
    assert len(three) == 3 and len(eight) == 8
    assert [t for t, _ in three] == [t for t, _ in eight[:3]]
    np.testing.assert_allclose([c for _, c in three],
                               [c for _, c in eight[:3]], atol=1e-4)
