"""kiri_tpu_torch.OCR against kiri_tpu.OCR on the CPU on rotated pages and
with the CRAFT detector: the small random recognizer of tests/torch_pages.py
over the committed pages (kiri_tpu_torch/assets/smoke_pages.npz: the three
rotated pages, one of them noisy, and an upright one).

- ``deskew=True`` over DB and over CRAFT, with ``deskew_single_resample``
  on (crops warped from the original page) and off (crops cut from the
  rotated page), host and device preprocessing: ``process_document`` and
  ``extract_text`` (grouped by the upright boxes);
- ``det_method="craft"`` on an upright page (the 640x640 single-column
  one: CRAFT merges every line of the 480x640 page into one box, in both
  packages);
- the noisy rotated page with ``enhance=True``: the page is despiked once
  and the crops are warped linearly;
- ``process_documents`` / ``extract_text_batch`` (pooled) against the
  per-page results and kiri_tpu's;
- the streams: ``process_document_streaming``, ``extract_text_streaming``
  and ``extract_text_stream_chars`` on a rotated page.

Boxes, texts and line numbers equal, confidences within 1e-4 and box
scores within ``SCORE_TOL`` (5e-5 DB; CRAFT's scores are float16 map
values, equal or one float16 step apart: 1e-3).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
from test_torch_decoder_layers import few_torch_threads  # noqa: F401
from torch_pages import (DET, REPO, cv2_without_ipp,  # noqa: F401
                         same_dicts, small_ckpt, smoke_pages)

from kiri_tpu.pipeline import OCR as JOCR
from kiri_tpu_torch import pipeline as tpipeline
from kiri_tpu_torch.pipeline import OCR

CRAFT = str(REPO / "models" / "craft.safetensors")
CRAFT_SCORE_TOL = 1e-3
UPRIGHT = 3     # 480x640, single column: a canvas group of its own


@pytest.fixture(scope="module")
def rot_pages(smoke_pages):
    return [p["image"] for p in smoke_pages["rot_pages"]]


def pair(ckpt: str, det: str, **kw):
    method = "craft" if det == CRAFT else "db"
    return (JOCR(ckpt, det_model_path=det, det_method=method, **kw),
            OCR(ckpt, det_model_path=det, det_method=method, device="cpu",
                **kw))


def same(ours, ref, det: str) -> None:
    if det == DET:
        same_dicts(ours, ref)
        return
    strip = [[{k: v for k, v in r.items() if k != "det_confidence"}
              for r in rs] for rs in (ours, ref)]
    same_dicts(*strip)
    np.testing.assert_allclose([r["det_confidence"] for r in ours],
                               [r["det_confidence"] for r in ref], rtol=0,
                               atol=CRAFT_SCORE_TOL)


@pytest.mark.parametrize("det", [DET, CRAFT], ids=["db", "craft"])
def test_deskewed_pages_read_as_kiri_tpu(small_ckpt, rot_pages, det):
    """Single resample on and off, host and device preprocessing, on the
    two clean rotated pages (the same detectors throughout)."""
    j, t = pair(small_ckpt, det, decode_method="fast", deskew=True)
    for page in rot_pages[:2]:
        for single in (True, False):
            for pre in ("host", "device"):
                if pre == "device" and not single:
                    continue
                j.deskew_single_resample = t.deskew_single_resample = single
                j.preprocess = t.preprocess = pre
                ours = t.process_document(page)
                same(ours, j.process_document(page), det)
                assert len(ours) >= 5 and any(r["text"] for r in ours)
                assert t.detector.last_deskew_angle == \
                    j.detector.last_deskew_angle != 0.0
                assert t._crops_resampled
        text, res = t.extract_text(page)
        jtext, jres = j.extract_text(page)
        assert text == jtext
        same(res, jres, det)


def test_accurate_mode_on_a_deskewed_page(small_ckpt, rot_pages):
    j, t = pair(small_ckpt, DET, decode_method="accurate", deskew=True)
    same_dicts(t.process_document(rot_pages[1]),
               j.process_document(rot_pages[1]))


def test_craft_on_an_upright_page(small_ckpt, smoke_pages):
    page = smoke_pages["pages"][0]["image"]
    j, t = pair(small_ckpt, CRAFT, decode_method="fast")
    ours = t.process_document(page)
    same(ours, j.process_document(page), CRAFT)
    assert len(ours) >= 5 and not t._crops_resampled
    text, res = t.extract_text(page)
    assert text == j.extract_text(page)[0]


def test_noisy_rotated_page_despikes_and_warps_linearly(small_ckpt,
                                                        rot_pages,
                                                        monkeypatch):
    page = rot_pages[2]
    j, t = pair(small_ckpt, DET, decode_method="fast", deskew=True,
                enhance=True)
    calls = {"despike": 0, "interp": []}
    despike, extract = tpipeline._despike, \
        tpipeline.extract_crop_single_resample

    def count_despike(f):
        calls["despike"] += 1
        return despike(f)

    def spy_extract(*a, **k):
        calls["interp"].append(k.get("interp"))
        return extract(*a, **k)

    monkeypatch.setattr(tpipeline, "_despike", count_despike)
    monkeypatch.setattr(tpipeline, "extract_crop_single_resample",
                        spy_extract)
    ours = t.process_document(page)
    same_dicts(ours, j.process_document(page))
    assert calls["despike"] == 1 and calls["interp"]
    assert set(calls["interp"]) == {"linear"}
    # Without enhance the same page is warped cubic or linear by scale,
    # from the page as it is.
    calls.update(despike=0, interp=[])
    j.enhance = t.enhance = False
    same_dicts(t.process_document(page), j.process_document(page))
    assert calls["despike"] == 0 and set(calls["interp"]) == {None}


@pytest.mark.parametrize("det", [DET, CRAFT], ids=["db", "craft"])
def test_pooled_pages_equal_per_page(small_ckpt, smoke_pages, rot_pages,
                                     det):
    pages = rot_pages + [smoke_pages["pages"][UPRIGHT]["image"]]
    j, t = pair(small_ckpt, det, decode_method="fast", deskew=True)
    pooled = t.process_documents(pages)
    for ours, page in zip(pooled, pages):
        assert ours == t.process_document(page)
    for ours, ref in zip(pooled, j.process_documents(pages)):
        same(ours, ref, det)
    batch = t.extract_text_batch(pages)
    for (text, res), (jtext, jres), page in zip(
            batch, j.extract_text_batch(pages), pages):
        assert text == jtext == t.extract_text(page)[0]
        same(res, jres, det)
    assert [s[2] != 0.0 for s in t.detector.last_batch_state] == \
        [True, True, True, False]


def test_streams_of_a_rotated_page(small_ckpt, rot_pages):
    page = rot_pages[0]
    j, t = pair(small_ckpt, DET, decode_method="fast", deskew=True)
    same_dicts(list(t.process_document_streaming(page)),
               list(j.process_document_streaming(page)))
    same_dicts(list(t.extract_text_streaming(page)),
               list(j.extract_text_streaming(page)))
    for batched in (True, False):
        same_dicts(list(t.extract_text_stream_chars(page, batched=batched)),
                   list(j.extract_text_stream_chars(page, batched=batched)))


def test_a_path_to_a_rotated_page(small_ckpt, rot_pages, tmp_path):
    import cv2

    path = tmp_path / "rotated.png"
    cv2.imwrite(str(path), rot_pages[0])
    t = OCR(small_ckpt, det_model_path=DET, decode_method="fast",
            deskew=True, device="cpu")
    assert t.process_document(str(path)) == t.process_document(rot_pages[0])
    assert Path(path).exists()
