"""kiri_tpu_torch.OCR against kiri_tpu.OCR on the CPU: the small random
recognizer (tests/torch_pages.py) with the committed DB detector over the
committed two-column page. ``process_document`` and ``extract_text`` in
"fast", "accurate", "beam" and "auto" with host and device preprocessing,
the single-line entry points, the decode-method surface, and the model
cache, which the port keys on the compute dtype too. Boxes, texts and line
numbers equal, confidences within 1e-4."""
from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch
from test_torch_decoder_layers import few_torch_threads  # noqa: F401
from test_torch_stream import lcp_tokens
from torch_pages import (CKPT, DET, cv2_without_ipp, ocr_pair,  # noqa: F401
                         same_dicts, small_ckpt, smoke_pages)

from kiri_tpu.pipeline import OCR as JOCR
from kiri_tpu_torch.pipeline import OCR

PAGE = 1   # the two-column page


@pytest.mark.parametrize("method", ["fast", "accurate", "beam", "auto"])
@pytest.mark.parametrize("preprocess", ["host", "device"])
def test_process_document_reads_as_kiri_tpu(small_ckpt, smoke_pages, method,
                                            preprocess):
    page = smoke_pages["pages"][PAGE]["image"]
    j, t = ocr_pair(small_ckpt, decode_method=method, preprocess=preprocess)
    ours = t.process_document(page)
    same_dicts(ours, j.process_document(page))
    assert len(ours) >= 10 and any(r["text"] for r in ours)
    assert set(t.last_timer.totals) == {"detect", "preprocess", "recognize"}
    if method == "fast" and preprocess == "host":
        text, res = t.extract_text(page)
        jtext, jres = j.extract_text(page)
        assert text == jtext and "\n" in text
        same_dicts(res, jres)


def test_single_line_entry_points_read_as_kiri_tpu(small_ckpt, smoke_pages):
    """recognize_region (u8 and the reference's normalized float layout),
    recognize_region_streaming, recognize_single_line_image and
    recognize_streaming on a line cut from the page."""
    page = smoke_pages["pages"][0]["image"]
    x, y, w, h = smoke_pages["pages"][0]["boxes"][0]
    line = page[y: y + h, x: x + w]
    j, t = ocr_pair(small_ckpt, decode_method="accurate")
    u8 = np.resize(np.asarray(line, np.uint8), (48, 320))
    norm = ((u8 / 255.0 - 0.5) / 0.5)[None, None]
    for img in (u8, norm):
        ours, ref = t.recognize_region(img), j.recognize_region(img)
        assert ours[0] == ref[0] and abs(ours[1] - ref[1]) < 1e-4
    ours = t.recognize_single_line_image(line)
    ref = j.recognize_single_line_image(line)
    assert ours[0] == ref[0] and abs(ours[1] - ref[1]) < 1e-4
    same_dicts(list(t.recognize_streaming(255 - line, "fast")),
               list(j.recognize_streaming(255 - line, "fast")))
    same_dicts(list(t.recognize_streaming(255 - line, "beam")),
               lcp_tokens(j.recognize_streaming(255 - line, "beam")))


def test_decode_method_surface(small_ckpt):
    for alias, m in (("fast", "ctc"), ("Accurate ", "decoder"),
                     ("beam", "beam"), ("auto", "auto"), ("ctc", "ctc")):
        assert OCR._normalize_decode_method(alias) == m
    with pytest.raises(ValueError, match="Invalid decode_method"):
        OCR(small_ckpt, decode_method="warp", device="cpu")
    with pytest.raises(ValueError, match="Invalid preprocess"):
        OCR(small_ckpt, preprocess="gpu", device="cpu")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        t = OCR(small_ckpt, use_beam_search=True, device="cpu")
    assert t.decode_method == "beam" and t.use_beam_search
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    t = OCR(small_ckpt, device="cpu", stream_window=0)
    assert t._stream_window_for("beam") is None
    t = OCR(small_ckpt, device="cpu")
    assert (t.stream_window, t._stream_window_for("beam"),
            t._stream_window_for("decoder")) == (16, 16, None)
    with pytest.raises(ValueError, match="det_method"):
        OCR(small_ckpt, device="cpu", det_method="east")
    blank = np.full((64, 64), 255, np.uint8)
    t = OCR(small_ckpt, device="cpu", det_method="legacy")
    assert t.detector.method == "legacy"
    assert t.process_document(blank) == JOCR(
        small_ckpt, det_method="legacy").process_document(blank) == []
    t = OCR(small_ckpt, det_model_path=DET, device="cpu")
    assert t.process_document(blank, mode="words") == []


def test_model_cache_is_keyed_on_the_dtype():
    """kiri_tpu keys its class-level cache on (path, device, upload_bits)
    and applies use_fp16 after the lookup, so a second OCR with another
    use_fp16 gets the first one's engine; the port keys on the dtype too."""
    JOCR._model_cache.clear()
    j16 = JOCR(CKPT, use_fp16=True)
    j32 = JOCR(CKPT, use_fp16=False)
    assert j32.engine is j16.engine
    assert j32.cfg.COMPUTE_DTYPE == "bfloat16"
    JOCR._model_cache.clear()
    t16 = OCR(CKPT, use_fp16=True, device="cpu")
    t32 = OCR(CKPT, use_fp16=False, device="cpu")
    assert (t16.engine.dtype, t32.engine.dtype) == (torch.bfloat16,
                                                    torch.float32)
    assert t32.cfg.COMPUTE_DTYPE == "float32"
    assert OCR(CKPT, use_fp16=False, device="cpu").engine is t32.engine
    OCR._model_cache.clear()


def test_page_paths_need_an_image_reader(small_ckpt, smoke_pages, tmp_path,
                                         monkeypatch):
    """A path gives the array's results. PNG is read by the port itself,
    also where neither cv2 nor PIL imports; any other file is read through
    cv2 (or PIL), and where neither imports the error says so."""
    import cv2

    from kiri_tpu_torch.utils import imageio

    page = smoke_pages["pages"][0]["image"]
    path = tmp_path / "page.png"
    other = tmp_path / "page.bmp"
    cv2.imwrite(str(path), page)
    cv2.imwrite(str(other), page)
    t = OCR(small_ckpt, det_model_path=DET, decode_method="fast",
            device="cpu")
    want = t.process_document(page)
    assert t.process_document(str(path)) == want
    assert t.process_document(str(other)) == want
    with pytest.raises(ValueError, match="Could not load image"):
        t._load_gray(str(tmp_path / "missing.png"))

    def no_reader(name):
        raise ImportError(name)

    monkeypatch.setattr(imageio.importlib, "import_module", no_reader)
    assert t.process_document(str(path)) == want
    with pytest.raises(RuntimeError, match="needs cv2 or PIL"):
        t.process_document(str(other))
