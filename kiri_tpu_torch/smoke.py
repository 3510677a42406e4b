"""The committed smoke fixtures, for checks on machines that have no text
renderer:

- ``assets/smoke_lines.npz`` (``scripts/make_torch_smoke_lines.py``): 64
  rendered bilingual line crops, their host-preprocessed images, ground
  truth and the JAX package's answers, and 16 of the crops degraded for the
  enhancement path;
- ``assets/smoke_pages.npz`` (``scripts/make_torch_smoke_pages.py``): 9
  rendered bilingual pages, their ground truth and the JAX package's
  detections and ``process_document`` results.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

SMOKE_LINES = Path(__file__).resolve().parent / "assets" / "smoke_lines.npz"
SMOKE_PAGES = Path(__file__).resolve().parent / "assets" / "smoke_pages.npz"


def _split(flat: np.ndarray, shapes: np.ndarray) -> List[np.ndarray]:
    """Row-major crops concatenated in ``flat`` -> a list of [h, w]."""
    crops, o = [], 0
    for h, w in shapes:
        crops.append(flat[o: o + h * w].reshape(h, w))
        o += h * w
    return crops


def load_smoke_lines() -> Tuple[Dict[str, np.ndarray], List[np.ndarray]]:
    """(every array of the file, the raw crops as a list of [h, w] u8)."""
    with np.load(SMOKE_LINES) as f:
        data = {k: f[k] for k in f.files}
    return data, _split(data["crops_flat"], data["crop_shapes"])


def noisy_crops(data: Dict[str, np.ndarray]
                ) -> Tuple[List[np.ndarray], np.ndarray]:
    """(the degraded crops as a list of [h, w] u8, their sharpen mask)."""
    return (_split(data["noisy_crops_flat"], data["noisy_crop_shapes"]),
            data["noisy_sharpen"])


def _cut(flat: np.ndarray, counts: np.ndarray) -> List[np.ndarray]:
    """Rows of ``flat`` split into consecutive groups of ``counts``."""
    return np.split(flat, np.cumsum(counts)[:-1])


def load_smoke_pages() -> Dict:
    """The committed pages, one dict per page: ``image`` (u8 [H, W]),
    ``lines`` and ``texts`` (ground truth), ``spec`` (width, height,
    layout, condition, seed, lines from the short-text pool), ``det_quads`` / ``det_scores`` (the JAX
    package's ``DBDetector.detect_text``), ``boxes`` / ``box_conf`` (its
    ``TextDetector.detect_lines_objects``); with ``results`` ({run: one
    result list per page}), ``prob_page`` and ``prob_u16``."""
    with np.load(SMOKE_PAGES) as f:
        d = {k: f[k] for k in f.files}
    images = _split(d["pages_flat"], d["page_shapes"])
    specs = json.loads(str(d["page_specs"]))
    pages = []
    for i, (img, lines, texts, quads, scores, boxes, conf) in enumerate(zip(
            images, _cut(d["gt_lines"], d["gt_counts"]),
            _cut(d["gt_texts"], d["gt_counts"]),
            _cut(d["det_quads"], d["det_counts"]),
            _cut(d["det_scores"], d["det_counts"]),
            _cut(d["facade_boxes"], d["facade_counts"]),
            _cut(d["facade_conf"], d["facade_counts"]))):
        pages.append({"image": img, "spec": specs[i],
                      "lines": [tuple(map(int, b)) for b in lines],
                      "texts": [str(t) for t in texts], "det_quads": quads,
                      "det_scores": scores,
                      "boxes": [tuple(map(int, b)) for b in boxes],
                      "box_conf": conf})
    return {"pages": pages, "results": json.loads(str(d["results"])),
            "prob_page": int(d["prob_page"]), "prob_u16": d["prob_u16"]}
