"""Page-level accuracy: the port of ``kiri_tpu/evalpage.py``.

``eval_condition`` renders synthetic pages (``data/docsynth.py``), degrades
them under a robustness condition, runs ``ocr.process_document`` on each and
scores the results with ``score_pages``. ``score_pages`` takes pages already
rendered: each a dict with ``lines`` (x, y, w, h) and ``texts``, and
optionally ``upright_lines``, the boxes before a geometric degradation,
which set the ground truth's reading order. The rules:

- a ground-truth line matches the result whose box covers its centre; of
  several, the one whose own centre is nearest;
- unmatched lines count their whole length as errors in ``end2end_cer``;
- ``doc_cer`` compares whole transcripts, both in reading order.

``script`` (a predicate on a ground-truth text) restricts the line scores to
those lines, as for a per-script CER.
"""
from __future__ import annotations

import random
import time
import zlib
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

__all__ = ["levenshtein", "reading_order", "score_pages", "is_khmer",
           "eval_condition"]


def levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def reading_order(items):
    """(box, text) pairs in reading order: y-bands of the median line
    height (centres within 0.7 of it), then left to right."""
    items = list(items)
    if not items:
        return items
    items.sort(key=lambda it: it[0][1] + it[0][3] / 2)
    med_h = float(np.median([b[3] for b, _ in items]))
    bands, cur = [], [items[0]]
    for it in items[1:]:
        cy = it[0][1] + it[0][3] / 2
        avg = float(np.mean([b[1] + b[3] / 2 for b, _ in cur]))
        if abs(cy - avg) < med_h * 0.7:
            cur.append(it)
        else:
            bands.append(cur)
            cur = [it]
    bands.append(cur)
    out = []
    for band in bands:
        out.extend(sorted(band, key=lambda it: it[0][0]))
    return out


def is_khmer(text: str) -> bool:
    return any(0x1780 <= ord(c) <= 0x17FF for c in text)


def score_pages(pages: Sequence[Dict], results: Iterable[List[Dict]],
                script: Optional[Callable[[str], bool]] = None) -> Dict:
    """Scores of ``results`` (one ``process_document`` list per page)
    against ``pages``: docs, gt_lines, line_recall, doc_cer, matched_cer,
    end2end_cer (rounded to 4 places, as the JAX package reports them)."""
    matched_err = matched_len = missed_len = 0
    doc_err = doc_len = 0
    n_gt = n_matched = n_docs = 0
    for page, res in zip(pages, results):
        n_docs += 1
        upright = page.get("upright_lines", page["lines"])
        gt_doc = "\n".join(t for _, t in reading_order(
            zip(upright, page["texts"])))
        hyp_doc = "\n".join(r["text"] for r in res)
        doc_err += levenshtein(hyp_doc, gt_doc)
        doc_len += len(gt_doc)
        for (gx, gy, gw, gh), gt_text in zip(page["lines"], page["texts"]):
            if script is not None and not script(gt_text):
                continue
            n_gt += 1
            cx, cy = gx + gw / 2, gy + gh / 2
            hyp = None
            for r in res:
                x, y, w, h = r["box"]
                if x <= cx <= x + w and y <= cy <= y + h:
                    d = abs((y + h / 2) - cy) + abs((x + w / 2) - cx)
                    if hyp is None or d < hyp[1]:
                        hyp = (r["text"], d)
            if hyp is None:
                missed_len += len(gt_text)
                continue
            n_matched += 1
            matched_err += levenshtein(hyp[0], gt_text)
            matched_len += len(gt_text)
    return {
        "docs": n_docs, "gt_lines": n_gt,
        "line_recall": round(n_matched / max(1, n_gt), 4),
        "doc_cer": round(doc_err / max(1, doc_len), 4),
        "matched_cer": round(matched_err / max(1, matched_len), 4),
        "end2end_cer": round((matched_err + missed_len)
                             / max(1, matched_len + missed_len), 4),
    }


def eval_condition(ocr, cond: str, n: int, seed: int = 7000,
                   khmer_ratio: float = 0.4, page: int = 640,
                   deadline: Optional[float] = None) -> Dict:
    """``ocr.process_document`` over ``n`` synthetic pages under one
    robustness condition, scored against their ground truth.

    ``cond`` is a condition of ``docsynth.CONDITIONS`` or a ``+`` chain of
    them (``rotated+noisy``: the boxes go through each stage). Page ``i``
    comes from ``DocumentGenerator(page, page, seed=seed + 13 i)`` and the
    conditions draw from one ``random.Random`` seeded by the condition's
    CRC-32, as in the JAX package. Past ``deadline`` (a
    ``time.monotonic()`` value) no page is added after the first, and
    ``docs`` says how many ran."""
    from .data.docsynth import DocumentGenerator, apply_condition

    rng = random.Random(seed + zlib.crc32(cond.encode()) % 1000)
    pages, results = [], []
    for i in range(n):
        if deadline is not None and time.monotonic() > deadline and pages:
            break
        gen = DocumentGenerator(page, page, seed=seed + 13 * i,
                                khmer_ratio=khmer_ratio)
        doc = gen.generate()
        upright = doc["lines"]
        if cond != "clean":
            for c in cond.split("+"):
                doc = apply_condition(doc, c, rng)
        results.append(ocr.process_document(np.asarray(doc["image"],
                                                       np.uint8)))
        pages.append({"lines": doc["lines"], "texts": doc["texts"],
                      "upright_lines": upright})
    return {"condition": cond, **score_pages(pages, results)}
