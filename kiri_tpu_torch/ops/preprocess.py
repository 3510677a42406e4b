"""Host-side line preprocessing and batching (ports of
``kiri_tpu/ops/preprocess.py`` and ``pick_batch_bucket`` of
``kiri_tpu/ops/decode.py``), and the u8 -> [-1, 1] normalization.

The image operations are numpy, with cv2's resizes and grey conversion
computed as OpenCV computes them (``ops/imgproc.py``): the machine with the
card has neither cv2 nor PIL. The reference-exact path for a PIL image
(``ResizeKeepRatioPadNoCrop``, ``preprocess_pil``, ``preprocess_pil_u8``)
is Pillow's own, imported when it is called.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .imgproc import bgr_to_gray, resize_u8


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


# --------------------------------------------------------------------------
# Image operations
# --------------------------------------------------------------------------
def to_gray(img: np.ndarray) -> np.ndarray:
    """BGR or BGRA u8 -> gray (cv2's ``COLOR_BGR2GRAY``); gray is kept."""
    return bgr_to_gray(img) if img.ndim == 3 else img


def invert_if_dark(img: np.ndarray) -> np.ndarray:
    """Invert when the mean is below 127 (a dark background)."""
    if float(img.mean()) < 127.0:
        return 255 - img
    return img


def crop_region(img_gray: np.ndarray, box: Tuple[int, int, int, int],
                extra_padding: int = 5) -> Optional[np.ndarray]:
    """The box (x, y, w, h) grown by ``extra_padding`` and clipped to the
    image; None when that is empty."""
    img_h, img_w = img_gray.shape[:2]
    x, y, w, h = box
    x1 = max(0, int(x) - extra_padding)
    y1 = max(0, int(y) - extra_padding)
    x2 = min(img_w, int(x) + int(w) + extra_padding)
    y2 = min(img_h, int(y) + int(h) + extra_padding)
    roi = img_gray[y1:y2, x1:x2]
    if roi.size == 0:
        return None
    return roi


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


class ResizeKeepRatioPadNoCrop:
    """The reference's transform of a PIL image: bilinear resize to height
    ``h`` with the aspect kept, cropped to ``w`` when wider, else pasted on
    an "L" canvas of 128 at the left."""

    def __init__(self, h: int, w: int):
        self.h = h
        self.w = w

    def __call__(self, img):
        from ..data.synth import require_pillow

        image = require_pillow("the PIL input path")[0]
        iw, ih = img.size
        if ih <= 0 or iw <= 0:
            return img.resize((self.w, self.h), image.BILINEAR)
        nw = max(1, int(round(iw * (self.h / float(ih)))))
        img = img.resize((nw, self.h), image.BILINEAR)
        if nw >= self.w:
            return img.crop((0, 0, self.w, self.h))
        canvas = image.new("L", (self.w, self.h), 128)
        canvas.paste(img, (0, 0))
        return canvas


def preprocess_pil_u8(cfg, pil) -> np.ndarray:
    """PIL image -> u8 [IMG_H, IMG_W] (grey, resize, pad; no
    normalization)."""
    img = ResizeKeepRatioPadNoCrop(cfg.IMG_H, cfg.IMG_W)(pil.convert("L"))
    return np.asarray(img, dtype=np.uint8)


def preprocess_pil(cfg, pil) -> np.ndarray:
    """PIL image -> float32 [1, 1, IMG_H, IMG_W] in [-1, 1], computed as
    the reference does (divide by 255, then centre and scale)."""
    arr = preprocess_pil_u8(cfg, pil).astype(np.float32) / 255.0
    arr = (arr - 0.5) / 0.5
    return arr[None, None]


def preprocess_np(cfg, img: np.ndarray) -> np.ndarray:
    """Gray or BGR image -> u8 [IMG_H, IMG_W] model input."""
    return resize_keep_ratio_pad_np(invert_if_dark(to_gray(img)), cfg.IMG_H,
                                    cfg.IMG_W)


def preprocess_crops(cfg, crops: Sequence[np.ndarray], enhance: bool = False,
                     sharpen=False) -> Tuple[np.ndarray, np.ndarray]:
    """Line crops -> (u8 [N, IMG_H, IMG_W], content widths [N]): gray,
    invert-if-dark, ``enhance_crop`` with ``enhance``, resize and pad.
    ``sharpen`` is a bool or one bool per crop."""
    n = len(crops)
    if isinstance(sharpen, (bool, np.bool_)):
        sharpen = [bool(sharpen)] * n
    out, widths = [], []
    for roi, sh in zip(crops, sharpen):
        roi = invert_if_dark(to_gray(roi))
        if enhance:
            roi = enhance_crop(roi, sharpen=sh, target_h=cfg.IMG_H)
        widths.append(content_width(roi.shape, cfg.IMG_H, cfg.IMG_W))
        out.append(resize_keep_ratio_pad_np(roi, cfg.IMG_H, cfg.IMG_W))
    if not out:
        return (np.zeros((0, cfg.IMG_H, cfg.IMG_W), dtype=np.uint8),
                np.zeros((0,), np.int32))
    return np.stack(out), np.asarray(widths, np.int32)


def preprocess_regions(cfg, img_gray: np.ndarray,
                       boxes: Sequence[Tuple[int, int, int, int]],
                       extra_padding: int = 5, enhance: bool = False,
                       sharpen: bool = False
                       ) -> Tuple[np.ndarray, List[int], np.ndarray]:
    """Crop every box of a page and preprocess the crops: (u8 batch, the
    indices of the boxes kept (empty crops are dropped), content widths)."""
    crops, kept = [], []
    for i, box in enumerate(boxes):
        roi = crop_region(img_gray, box, extra_padding)
        if roi is not None:
            crops.append(roi)
            kept.append(i)
    batch, widths = preprocess_crops(cfg, crops, enhance=enhance,
                                     sharpen=sharpen)
    return batch, kept, widths


# --------------------------------------------------------------------------
# Adaptive cleanup of degraded crops (the host twin of
# kernels/resize.enhance_lines)
# --------------------------------------------------------------------------
#: The noise gate shared by ``enhance_crop`` and the page-level despike.
NOISE_SIGMA_THRESH = 2.5

_GAUSS5 = None


def _median3(f: np.ndarray) -> np.ndarray:
    """3x3 median filter, edges replicated."""
    win = np.lib.stride_tricks.sliding_window_view(np.pad(f, 1, mode="edge"),
                                                   (3, 3))
    return np.median(win, axis=(-2, -1))


def _gauss08(f: np.ndarray) -> np.ndarray:
    """Separable 5-tap gaussian blur, sigma 0.8, edges replicated."""
    global _GAUSS5
    if _GAUSS5 is None:
        x = np.arange(-2, 3, dtype=np.float32)
        k = np.exp(-x * x / (2 * 0.8 ** 2))
        _GAUSS5 = k / k.sum()
    k = _GAUSS5
    p = np.pad(f, ((2, 2), (0, 0)), mode="edge")
    f = sum(w * p[i: i + f.shape[0]] for i, w in enumerate(k))
    p = np.pad(f, ((0, 0), (2, 2)), mode="edge")
    return sum(w * p[:, i: i + f.shape[1]] for i, w in enumerate(k))


def _despike(f: np.ndarray, band_rows: int = 1024) -> np.ndarray:
    """Replace isolated full-range impulses by their 8-neighbour median: a
    pixel <= 10 whose neighbours are all >= 160, or >= 245 with all <= 95.
    Taller images go in row bands with a 1-pixel halo (the same result)."""
    h = f.shape[0]
    if h > band_rows:
        out = np.empty_like(f)
        for y0 in range(0, h, band_rows):
            y1 = min(h, y0 + band_rows)
            lo, hi = max(0, y0 - 1), min(h, y1 + 1)
            out[y0:y1] = _despike(f[lo:hi])[y0 - lo: y0 - lo + (y1 - y0)]
        return out
    win = np.lib.stride_tricks.sliding_window_view(
        np.pad(f, 1, mode="edge"), (3, 3)).reshape(f.shape + (9,))
    nbrs = np.delete(win, 4, axis=-1)
    spikes = (((f <= 10.0) & (nbrs.min(axis=-1) >= 160.0))
              | ((f >= 245.0) & (nbrs.max(axis=-1) <= 95.0)))
    if spikes.any():
        f = np.where(spikes, np.median(nbrs, axis=-1), f)
    return f


def estimate_noise_sigma(img: np.ndarray, max_px: int = 1_500_000) -> float:
    """1.4826 * median(|img - median3(img)|); images above ``max_px``
    pixels are stride-subsampled first."""
    img = np.asarray(img)
    px = img.shape[0] * img.shape[1]
    if px > max_px:
        k = int(np.ceil(np.sqrt(px / max_px)))
        img = img[::k, ::k]
    f = img.astype(np.float32)
    return float(np.median(np.abs(f - _median3(f)))) * 1.4826


def enhance_crop(img: np.ndarray, noise_thresh: float = NOISE_SIGMA_THRESH,
                 range_thresh: float = 200.0, min_blur_height: int = 36,
                 sharpen: bool = False, target_h: int = 48) -> np.ndarray:
    """Cleanup of a degraded u8 line crop, each repair a no-op on clean
    input: despike; above the noise gate a sigma-0.8 blur (crops under
    ``min_blur_height`` are first resized linearly to ``target_h``);
    otherwise, with ``sharpen``, an unsharp mask (amount 1.4); then a
    percentile contrast stretch of captures with no white."""
    f = _despike(img.astype(np.float32))
    if estimate_noise_sigma(f) > noise_thresh:
        if img.shape[0] < min_blur_height:
            h, w = f.shape
            nw = max(1, round(w * target_h / h))
            u8 = np.clip(f, 0.0, 255.0).astype(np.uint8)
            f = resize_u8(u8, nw, target_h, "linear").astype(np.float32)
        f = _gauss08(f)
    elif sharpen:
        f = np.clip(f + 1.4 * (f - _gauss08(f)), 0.0, 255.0)
    lo, hi = np.percentile(f, 1.0), np.percentile(f, 99.0)
    if hi < 240.0 and 1.0 < hi - lo < range_thresh:
        f = (f - lo) / (hi - lo) * 255.0
    return np.clip(f, 0.0, 255.0).astype(np.uint8)
