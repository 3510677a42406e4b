"""Word-level pages and the classic-CV detector through kiri_tpu_torch.OCR
against kiri_tpu.OCR on the CPU (cv2 with IPP off):

- live, with the small random recognizer of tests/torch_pages.py:
  ``det_method="legacy"`` and ``mode="words"`` through ``process_document``,
  ``extract_text``, ``process_documents`` / ``extract_text_batch``, the
  result and character streams, host and device preprocessing, and legacy
  with deskew on a rotated page: boxes identical, texts equal, confidences
  within 1e-4 (``det_confidence`` is 1.0 for words and legacy lines);
- with the committed checkpoint in float32, against the answers stored in
  the smoke fixture (``results_legacy``) on the small pages: identical
  boxes, equal texts, confidences within 1e-3;
- ``detect_blocks`` over DB lines against the stored answers."""
from __future__ import annotations

import numpy as np
import pytest
from test_torch_decoder_layers import few_torch_threads  # noqa: F401
from torch_pages import (CKPT, DET, cv2_without_ipp, ocr_pair,  # noqa: F401
                         same_dicts, small_ckpt, smoke_pages)

from kiri_tpu_torch.pipeline import OCR

#: Fixture pages that are small enough for a live run: 640x640, 512x512,
#: the colour page (index 12 of the thirteen).
SMALL = (0, 4, 12)


def _page(smoke_pages, i):
    if i == 12:
        return smoke_pages["legacy"]["color_page"]
    every = smoke_pages["pages"] + smoke_pages["rot_pages"]
    return every[i]["image"]


@pytest.mark.parametrize("det_method,mode", [("legacy", "lines"),
                                             ("legacy", "words"),
                                             ("db", "words")])
def test_pages_read_as_kiri_tpu(small_ckpt, smoke_pages, det_method, mode):
    j, t = ocr_pair(small_ckpt, decode_method="fast", det_method=det_method)
    pages = [_page(smoke_pages, i) for i in SMALL]
    for p in pages:
        ours = t.process_document(p, mode=mode)
        same_dicts(ours, j.process_document(p, mode=mode))
        assert ours and {r["det_confidence"] for r in ours} == {1.0}
        text, res = t.extract_text(p, mode=mode)
        jtext, jres = j.extract_text(p, mode=mode)
        assert text == jtext
        same_dicts(res, jres)
    pooled = t.process_documents(pages, mode=mode)
    for o, r, p in zip(pooled, j.process_documents(pages, mode=mode), pages):
        same_dicts(o, r)
        same_dicts(o, t.process_document(p, mode=mode))
    assert ([x for x, _ in t.extract_text_batch(pages, mode=mode)]
            == [x for x, _ in j.extract_text_batch(pages, mode=mode)])


def test_streams_and_device_preprocessing_read_as_kiri_tpu(small_ckpt,
                                                           smoke_pages):
    page = _page(smoke_pages, 4)
    j, t = ocr_pair(small_ckpt, decode_method="accurate", det_method="legacy")
    for mode in ("lines", "words"):
        same_dicts(list(t.extract_text_stream_chars(page, mode=mode)),
                   list(j.extract_text_stream_chars(page, mode=mode)))
        same_dicts(list(t.process_document_streaming(page, mode=mode)),
                   list(j.process_document_streaming(page, mode=mode)))
    j, t = ocr_pair(small_ckpt, decode_method="fast", preprocess="device")
    same_dicts(t.process_document(page, mode="words"),
               j.process_document(page, mode="words"))


def test_legacy_with_deskew_reads_as_kiri_tpu(small_ckpt, smoke_pages):
    page = smoke_pages["rot_pages"][0]["image"]
    for single in (True, False):
        j, t = ocr_pair(small_ckpt, decode_method="fast", det_method="legacy",
                        deskew=True, deskew_single_resample=single)
        ours = t.process_document(page)
        same_dicts(ours, j.process_document(page))
        assert t.detector.last_deskew_angle == j.detector.last_deskew_angle
        assert t.detector.last_deskew_angle != 0.0
        text, _ = t.extract_text(page)
        assert text == j.extract_text(page)[0]
    pooled = t.process_documents([page, smoke_pages["pages"][4]["image"]])
    same_dicts(pooled[0], ours)
    same_dicts(pooled[1], j.process_document(smoke_pages["pages"][4]["image"]))
    assert t.detector.last_batch_state[1] == (None, None, 0.0)


@pytest.mark.parametrize("run,mode", [("legacy_fast_f32", "lines"),
                                      ("words_fast_f32", "words")])
def test_committed_checkpoint_matches_the_stored_texts(smoke_pages, run,
                                                       mode):
    det = "legacy" if run.startswith("legacy") else "db"
    t = OCR(CKPT, det_model_path=DET, det_method=det, decode_method="fast",
            use_fp16=False, device="cpu")
    want = smoke_pages["results_legacy"][run]
    for i in SMALL:
        ours = t.process_document(_page(smoke_pages, i), mode=mode)
        strip = [[{k: v for k, v in r.items() if k != "confidence"}
                  for r in rs] for rs in (ours, want[i])]
        assert strip[0] == strip[1], i
        np.testing.assert_allclose([r["confidence"] for r in ours],
                                   [r["confidence"] for r in want[i]],
                                   rtol=0, atol=1e-3)


def test_blocks_over_db_lines_match_the_stored_answers(smoke_pages):
    from kiri_tpu_torch.detect import TextDetector

    td = TextDetector("db", DET, device="cpu")
    for i in (0, 1, 4, 9):
        assert td.detect_blocks(_page(smoke_pages, i)) == \
            smoke_pages["db_blocks"][i], i
