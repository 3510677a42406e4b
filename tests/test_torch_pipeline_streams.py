"""The streaming entry points of kiri_tpu_torch.OCR against kiri_tpu.OCR on
the CPU (the small random recognizer of tests/torch_pages.py, the committed
DB detector, the committed 480x640 page): ``process_document_streaming``,
``extract_text_streaming`` and ``extract_text_stream_chars`` batched (one
decode of the page, one-shot or in windows) and region by region. Chunk
sequences equal key for key, confidences within 1e-4; a beam chunk's
``token`` under the port's rule (the text past its longest common prefix
with the previous text, ROADMAP queue 3)."""
from __future__ import annotations

import pytest
from test_torch_decoder_layers import few_torch_threads  # noqa: F401
from test_torch_stream import lcp_tokens
from torch_pages import (cv2_without_ipp, ocr_pair, same_dicts,  # noqa: F401
                         small_ckpt, smoke_pages)

PAGE = 3   # 480x640, single column


@pytest.fixture(scope="module")
def page(smoke_pages):
    return smoke_pages["pages"][PAGE]["image"]


def test_result_streams_read_as_kiri_tpu(small_ckpt, page):
    j, t = ocr_pair(small_ckpt, decode_method="fast")
    ours = list(t.process_document_streaming(page))
    same_dicts(ours, list(j.process_document_streaming(page)))
    assert ours and all(r["total_regions"] == len(ours) for r in ours)
    ours = list(t.extract_text_streaming(page))
    same_dicts(ours, list(j.extract_text_streaming(page)))
    assert "\n" in ours[-1]["cumulative_text"]


@pytest.mark.parametrize("method,window", [("fast", None), ("accurate", None),
                                           ("beam", None), ("beam", 4),
                                           ("auto", None)])
def test_batched_char_stream_reads_as_kiri_tpu(small_ckpt, page, method,
                                               window):
    """One decode for the page: one-shot, or for "beam" with window=4 the
    step loop run 4 steps at a time."""
    kw = {} if window is None else dict(stream_window=window)
    j, t = ocr_pair(small_ckpt, decode_method=method, **kw)
    ours = list(t.extract_text_stream_chars(page))
    ref = list(j.extract_text_stream_chars(page))
    same_dicts(ours, lcp_tokens(ref) if method == "beam" else ref)
    assert ours[-1]["document_finished"]
    assert sum(c["region_start"] for c in ours) == ours[0]["total_regions"]


def test_region_by_region_char_stream_reads_as_kiri_tpu(small_ckpt, page):
    j, t = ocr_pair(small_ckpt, decode_method="fast")
    ours = list(t.extract_text_stream_chars(page, batched=False,
                                            decode_method="accurate"))
    same_dicts(ours, list(j.extract_text_stream_chars(
        page, batched=False, decode_method="accurate")))
    assert ours[-1]["document_finished"] and not any("error" in c
                                                     for c in ours)
