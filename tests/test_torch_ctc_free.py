"""A checkpoint without a CTC head (``cfg.USE_CTC`` false) in
kiri_tpu_torch's RecognizerEngine, against kiri_tpu's engine on the small
random model of tests/test_torch_decoder_layers.py, float32 on the CPU.

kiri_tpu returns zero CTC ids, confidences and estimates, so "ctc" reads
("", 0.0) and "auto" escalates every line to beam; "decoder" runs the step
loop instead of the CTC-drafted ``spec_decode``; the certificate-gated beam
runs the bucketed step loop. Texts must be equal, confidences within 1e-4.
The "ctc" stream, where kiri_tpu raises (a softmax of None), gives one
finished record of "" per line."""
from __future__ import annotations

import numpy as np
import pytest
from test_torch_decoder_layers import few_torch_threads, make_small_model  # noqa: F401

from kiri_tpu.engine import RecognizerEngine as JEngine
from kiri_tpu_torch.engine import RecognizerEngine


@pytest.fixture(scope="module")
def no_ctc(tmp_path_factory):
    return make_small_model(tmp_path_factory.mktemp("noctc"), USE_CTC=False,
                            EOS_LOGP_BIAS=6.0, EOS_LOGP_BOOST=2.0,
                            EOS_BIAS_UNTIL_LEN=7)


def _inputs():
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 255, (5, 48, 160), dtype=np.uint8)
    widths = np.asarray([160, 96, 160, 64, 90], np.int32)
    crops = [rng.integers(0, 255, (h, w), dtype=np.uint8)
             for h, w in ((30, 90), (48, 200), (64, 120))]
    return imgs, widths, crops


def test_model_has_no_ctc_head(no_ctc):
    model = no_ctc[3]
    assert not hasattr(model, "ctc_head")
    assert "ctc_head" not in no_ctc[0]["params"]


@pytest.mark.parametrize("method,path,spec_beam", [
    ("ctc", "bucketed", False), ("ctc", "crops", False),
    ("decoder", "batch", False), ("decoder", "bucketed", False),
    ("decoder", "crops", False), ("beam", "bucketed", False),
    ("beam", "batch", True), ("auto", "bucketed", False),
    ("auto", "crops", False)])
def test_ctc_free_checkpoint_reads_as_kiri_tpu(no_ctc, method, path,
                                               spec_beam):
    variables, jcfg, jtok, model, cfg, tok = no_ctc
    imgs, widths, crops = _inputs()
    jcfg, cfg = (c.replace(SPEC_BEAM=spec_beam) for c in (jcfg, cfg))
    jeng = JEngine(variables, jcfg, jtok)
    eng = RecognizerEngine(model, cfg, tok, device="cpu")
    if path == "batch":
        ours = eng.recognize_batch(imgs[:3], method)
        ref = jeng.recognize_batch(imgs[:3], method)
    elif path == "bucketed":
        ours = eng.recognize_batch(imgs, method, widths)
        ref = jeng.recognize_batch(imgs, method, widths=widths)
    else:
        ours = eng.recognize_crops(crops, method)
        ref = jeng.recognize_crops(crops, method)
    assert [t for t, _ in ours] == [t for t, _ in ref]
    np.testing.assert_allclose([c for _, c in ours], [c for _, c in ref],
                               atol=1e-4)
    if method == "ctc":
        assert ours == [("", 0.0)] * len(ours)
    else:
        assert any(t for t, _ in ours)
    assert eng.certified_rows == 0


@pytest.mark.parametrize("method,window", [("decoder", None),
                                           ("beam", None), ("decoder", 4),
                                           ("beam", 4)])
def test_ctc_free_streams_read_as_kiri_tpu(no_ctc, method, window):
    variables, jcfg, jtok, model, cfg, tok = no_ctc
    imgs = _inputs()[0][:3]
    ours = [list(r) for r in RecognizerEngine(model, cfg, tok, device="cpu")
            .stream_records_batch(imgs, method, window=window)]
    ref = [list(r) for r in JEngine(variables, jcfg, jtok)
           .stream_records_batch(imgs, method, window=window)]
    assert [[r["text"] for r in x] for x in ours] == \
        [[r["text"] for r in x] for x in ref]
    np.testing.assert_allclose(
        [r["confidence"] for x in ours for r in x],
        [r["confidence"] for x in ref for r in x], atol=1e-4)


def test_ctc_free_ctc_stream_is_one_empty_record(no_ctc):
    model, cfg, tok = no_ctc[3:]
    eng = RecognizerEngine(model, cfg, tok, device="cpu")
    for m in ("ctc", "auto"):
        recs = [list(r) for r in eng.stream_records_batch(_inputs()[0][:2], m)]
        assert recs == [[{"token": "", "token_id": -1, "text": "",
                          "confidence": 0.0, "step": 0,
                          "finished": True}]] * 2
