"""kiri_tpu_torch's RecognizerEngine (CTC fast path) on the CPU against
kiri_tpu's engine and the committed smoke lines, at float32."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

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


def test_later_slices_raise(engine, smoke):
    d, crops = smoke
    for method in ("decoder", "beam", "auto"):
        with pytest.raises(NotImplementedError, match="later slice"):
            engine.recognize_batch(d["imgs"][:2], method)
    with pytest.raises(NotImplementedError, match="later slice"):
        engine.recognize_crops(crops[:2], "ctc", enhance=True)
    with pytest.raises(NotImplementedError, match="later slice"):
        RecognizerEngine(engine.model, engine.cfg, engine.tok, device="cpu",
                         upload_bits=4)
    with pytest.raises(ValueError):
        RecognizerEngine(engine.model, engine.cfg, engine.tok, device="cpu",
                         upload_bits=3)
