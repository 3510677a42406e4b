"""Multi-page and degraded-page paths of kiri_tpu_torch.OCR against
kiri_tpu.OCR on the CPU (the small random recognizer of tests/torch_pages.py
and the committed DB detector):

- ``process_documents`` / ``extract_text_batch`` over pages of mixed sizes
  (four canvas groups, so pages arrive out of input order): the pooled
  results equal kiri_tpu's and the port's own per-page results;
- ``enhance=True`` on the noisy page with host and device preprocessing;
- a blank page; and no fallback to per-page detection.

Boxes, texts and line numbers equal, confidences within 1e-4."""
from __future__ import annotations

import numpy as np
import pytest
from test_torch_decoder_layers import few_torch_threads  # noqa: F401
from torch_pages import (cv2_without_ipp, ocr_pair, same_dicts,  # noqa: F401
                         small_ckpt, smoke_pages)

MIXED = (4, 0, 3, 5, 2)   # 512, 640, 480x640, 1280 (-> 960) and 640 again


@pytest.mark.parametrize("method,preprocess", [("accurate", "host"),
                                               ("fast", "device")])
def test_pooled_pages_read_as_kiri_tpu_and_per_page(small_ckpt, smoke_pages,
                                                    method, preprocess):
    pages = [smoke_pages["pages"][i]["image"] for i in MIXED]
    j, t = ocr_pair(small_ckpt, decode_method=method, preprocess=preprocess)
    ours = t.process_documents(pages)
    ref = j.process_documents(pages)
    assert len(ours) == len(pages)
    for o, r, p in zip(ours, ref, pages):
        same_dicts(o, r)
        same_dicts(o, t.process_document(p))
    if preprocess == "host":
        batch = t.extract_text_batch(pages)
        jbatch = j.extract_text_batch(pages)
        assert [x for x, _ in batch] == [x for x, _ in jbatch]
        assert [x for x, _ in batch] == [t.extract_text(p)[0] for p in pages]


@pytest.mark.parametrize("preprocess", ["host", "device"])
def test_enhance_on_the_noisy_page_reads_as_kiri_tpu(small_ckpt,
                                                     smoke_pages,
                                                     preprocess):
    page = next(p["image"] for p in smoke_pages["pages"]
                if p["spec"][3] == "noisy")
    j, t = ocr_pair(small_ckpt, decode_method="fast", enhance=True,
                    preprocess=preprocess)
    ours = t.process_document(page)
    same_dicts(ours, j.process_document(page))
    plain = ocr_pair(small_ckpt, decode_method="fast",
                     preprocess=preprocess)[1].process_document(page)
    assert [r["confidence"] for r in plain] != [r["confidence"]
                                                for r in ours]


def test_blank_page_and_no_per_page_fallback(small_ckpt, smoke_pages,
                                             monkeypatch):
    """A blank page gives ("", []). When batched detection raises, kiri_tpu
    prints and detects page by page; the port raises."""
    j, t = ocr_pair(small_ckpt, decode_method="fast")
    blank = np.full((300, 400), 250, np.uint8)
    assert t.extract_text(blank) == j.extract_text(blank) == ("", [])
    assert t.process_documents([blank, blank]) == [[], []]
    pages = [smoke_pages["pages"][i]["image"] for i in (0, 4)]

    def broken(images):
        raise RuntimeError("batched detection failed")
        yield  # a generator, as the real one

    monkeypatch.setattr(j.detector, "iter_lines_objects_batch", broken)
    assert all(j.process_documents(pages))
    monkeypatch.setattr(t.detector, "iter_lines_objects_batch", broken)
    with pytest.raises(RuntimeError, match="batched detection failed"):
        t.process_documents(pages)
