"""Frozen copy of the line preparation of kiri_tpu_torch/ops/preprocess.py at
commit 0bc739aac3bff3542a3b3238ea9226e557ccfdbd: the content width, the
aspect-keeping resize to the model's height with its pad of 128, and the
width bucket (``cfg`` is the configuration's dict here).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .imgproc import resize_u8


def content_width(shape: Tuple[int, int], h: int, w: int) -> int:
    """Width the aspect-preserving resize to height ``h`` produces, capped
    at ``w``: how many columns of the padded [h, w] canvas hold content."""
    ih, iw = shape[:2]
    if ih <= 0 or iw <= 0:
        return w
    return min(w, max(1, int(round(iw * (h / float(ih))))))


def resize_keep_ratio_pad_np(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """u8 [ih, iw] -> u8 [h, w]: resize to height h with the aspect kept
    (area when it shrinks, cubic otherwise), squeezed to w when wider, else
    padded on the right with 128."""
    ih, iw = img.shape[:2]
    if ih <= 0 or iw <= 0:
        return np.full((h, w), 128, dtype=np.uint8)
    scale = h / float(ih)
    nw = max(1, int(round(iw * scale)))
    resized = resize_u8(img, min(nw, w), h,
                        "area" if scale < 1.0 else "cubic")
    if resized.shape[1] >= w:
        return np.ascontiguousarray(resized[:, :w])
    out = np.full((h, w), 128, dtype=np.uint8)
    out[:, : resized.shape[1]] = resized
    return out


def width_bucket(cfg, w: int) -> int:
    """Smallest width bucket that holds content width ``w`` (the buckets
    below IMG_W, then IMG_W)."""
    buckets = sorted(b for b in cfg["WIDTH_BUCKETS"] if b < cfg["IMG_W"])
    return next((b for b in buckets if w <= b), int(cfg["IMG_W"]))
