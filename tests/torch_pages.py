"""Shared set-up of the page-pipeline tests (tests/test_torch_pipeline*.py,
tests/test_torch_pages_ckpt.py): the committed pages, the small random
recognizer saved as a checkpoint both packages load, cv2 without IPP, and
comparisons of result dicts and stream chunks."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
DET = str(REPO / "models" / "detector.safetensors")
CKPT = str(REPO / "models" / "model.safetensors")
CONF_TOL = 1e-4
#: DB box scores (det_confidence): measured 1.59e-5 on the committed pages.
#: kiri_tpu's float32 map differs from a float64 forward by up to 1.5e-4,
#: the port's by 5.5e-6 (tests/test_torch_detect.py).
SCORE_TOL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def cv2_without_ipp():
    """cv2's own resize code: with IPP its cubic resize depends on the CPU
    (tests/test_torch_imgproc.py)."""
    import cv2

    before = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(before)


@pytest.fixture(scope="module")
def smoke_pages():
    from kiri_tpu_torch.smoke import load_smoke_pages

    return load_smoke_pages()


@pytest.fixture(scope="module")
def small_ckpt(tmp_path_factory):
    """The small random recognizer of tests/test_torch_decoder_layers.py at
    width 320, saved by kiri_tpu as a checkpoint with its vocab."""
    from test_torch_decoder_layers import make_small_model

    from kiri_tpu.train.checkpoints import save_checkpoint

    tmp = tmp_path_factory.mktemp("small_ocr")
    variables, jcfg = make_small_model(
        tmp, IMG_W=320, WIDTH_BUCKETS=(160, 320), EOS_LOGP_BIAS=6.0,
        EOS_LOGP_BOOST=2.0, EOS_BIAS_UNTIL_LEN=7)[:2]
    path = tmp / "model.safetensors"
    save_checkpoint(path, variables, jcfg, vocab_path=str(tmp / "vocab.json"))
    # kiri_tpu's from_dict reads BEAM_STEP_BUCKETS back as a list, which its
    # jitted decoders cannot hash (ROADMAP queue 3, config.py:176): leave
    # it at its default.
    meta_path = tmp / "model_meta.json"
    meta = json.loads(meta_path.read_text())
    del meta["config"]["BEAM_STEP_BUCKETS"]
    meta_path.write_text(json.dumps(meta))
    return str(path)


def ocr_pair(ckpt: str, **kw):
    """(kiri_tpu's OCR, the port's on the CPU) with the same arguments."""
    from kiri_tpu.pipeline import OCR as JOCR
    from kiri_tpu_torch.pipeline import OCR

    return (JOCR(ckpt, det_model_path=DET, **kw),
            OCR(ckpt, det_model_path=DET, device="cpu", **kw))


def same_dicts(ours, ref) -> None:
    """Lists of result dicts or stream chunks: equal keys and values, the
    recognition confidences within CONF_TOL and the box scores within
    SCORE_TOL."""
    tols = {"confidence": CONF_TOL, "det_confidence": SCORE_TOL}
    strip = [[{k: v for k, v in r.items() if k not in tols} for r in rs]
             for rs in (ours, ref)]
    assert strip[0] == strip[1]
    for key, tol in tols.items():
        got, want = ([r.get(key, 0.0) for r in rs] for rs in (ours, ref))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
