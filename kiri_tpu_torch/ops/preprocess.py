"""Host-side helpers of line preprocessing and batching (ports of
``kiri_tpu/ops/preprocess.py`` and ``pick_batch_bucket`` of
``kiri_tpu/ops/decode.py``), and the u8 -> [-1, 1] normalization."""
from __future__ import annotations

import math
from typing import List, Tuple

import torch


def content_width(shape: Tuple[int, int], h: int, w: int) -> int:
    """Width the aspect-preserving resize to height ``h`` produces, capped
    at ``w``: how many columns of the padded [h, w] canvas hold content."""
    ih, iw = shape[:2]
    if ih <= 0 or iw <= 0:
        return w
    return min(w, max(1, int(round(iw * (h / float(ih))))))


def width_buckets(cfg) -> List[int]:
    """Configured width buckets below IMG_W, then IMG_W itself."""
    return sorted(b for b in cfg.WIDTH_BUCKETS if b < cfg.IMG_W) + [cfg.IMG_W]


def pick_width_bucket(cfg, w: int) -> int:
    """Smallest width bucket that holds content width ``w``."""
    for b in width_buckets(cfg):
        if w <= b:
            return b
    return cfg.IMG_W


def pick_batch_bucket(cfg, n: int) -> int:
    """Smallest batch bucket >= n; past the largest, a multiple of it."""
    for b in cfg.BATCH_BUCKETS:
        if b >= n:
            return int(b)
    top = cfg.BATCH_BUCKETS[-1]
    return int(math.ceil(n / top) * top)


def normalize_u8(batch_u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """u8 pixels -> [-1, 1] in ``dtype``, each step rounded to ``dtype`` as
    the JAX package computes it. The shape is kept."""
    x = batch_u8.to(dtype) / 255.0
    return (x - 0.5) / 0.5
