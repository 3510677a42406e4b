"""kiri_tpu_torch.OCR with both committed checkpoints at full width, float32
on the CPU, against kiri_tpu's answers stored in the page fixture
(kiri_tpu_torch/assets/smoke_pages.npz, scripts/make_torch_smoke_pages.py):
"fast" on every page, "accurate", device preprocessing and enhancement on
a few. Boxes, texts and line numbers equal, confidences within 1e-4."""
from __future__ import annotations

import pytest
from test_torch_decoder_layers import few_torch_threads  # noqa: F401
from torch_pages import (CKPT, DET, cv2_without_ipp, same_dicts,  # noqa: F401
                         smoke_pages)

from kiri_tpu_torch.evalpage import is_khmer, score_pages
from kiri_tpu_torch.pipeline import OCR


def _ocr(**kw):
    return OCR(CKPT, det_model_path=DET, device="cpu", use_fp16=False, **kw)


@pytest.mark.parametrize("run,kw,pages", [
    ("fast_f32", dict(decode_method="fast"), range(9)),
    ("accurate_f32", dict(decode_method="accurate"), (0, 4)),
    ("fast_f32_device", dict(decode_method="fast", preprocess="device"),
     (3, 6)),
    ("fast_f32_enhance", dict(decode_method="fast", enhance=True), (7,))])
def test_committed_checkpoint_reads_the_pages_as_kiri_tpu(smoke_pages, run,
                                                          kw, pages):
    ocr = _ocr(**kw)
    stored = smoke_pages["results"][run]
    for i in pages:
        same_dicts(ocr.process_document(smoke_pages["pages"][i]["image"]),
                   stored[i])


def test_stored_page_cer_of_kiri_tpu(smoke_pages):
    """kiri_tpu's stored bf16 answers on the pages, per script, against the
    line CER gates of tests/test_ckpt_regression.py (0.02 fast, 0.03
    accurate): English within them, Khmer within the accurate gate (0.027)
    but above the fast one (0.033; small Khmer glyphs on the 1280 px page
    read at 0.069). The card run holds the port to the gate, or to
    kiri_tpu's own CER plus 0.005 where that is above it."""
    pages = smoke_pages["pages"]
    got = {}
    for run in ("fast_bf16", "accurate_bf16"):
        res = smoke_pages["results"][run]
        kh = score_pages(pages, res, is_khmer)
        en = score_pages(pages, res, lambda t: not is_khmer(t))
        assert kh["line_recall"] == en["line_recall"] == 1.0
        got[run] = (kh["gt_lines"], kh["matched_cer"], en["gt_lines"],
                    en["matched_cer"])
    assert got == {"fast_bf16": (77, 0.033, 84, 0.0061),
                   "accurate_bf16": (77, 0.027, 84, 0.0053)}
