"""Page deskew: projection-profile skew estimation and the rotations (the
port of ``kiri_tpu/detect/deskew.py``, numpy only).

The estimate and the box mapping are copies of the JAX package's and give
the same floats. The two resamplers are the ports of what it calls:

- ``rotate_image``: Pillow's ``Image.rotate(..., BILINEAR)`` as
  ``ops/imgproc.py::rotate_bilinear``;
- ``extract_crop_single_resample``: ``cv2.warpAffine`` as
  ``ops/imgproc.py::warp_affine``.

Angle convention: ``estimate_skew`` returns the angle ``a`` such that the
page looks like an upright page passed through ``Image.rotate(a)``;
``rotate_image(img, -a)`` straightens it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ops.imgproc import rotate_bilinear, warp_affine

__all__ = ["estimate_skew", "rotate_image", "boxes_to_original",
           "extract_crop_single_resample"]


def _ink_coords(img: np.ndarray, max_side: int = 1200,
                max_px: int = 60_000) -> Tuple[np.ndarray, np.ndarray]:
    """(x, y) of the ink pixels of a strided view of the page. Ink is the
    minority side of the (0.5, 99.5) percentile midpoint, so inverted pages
    work too; where that labels more than a quarter of the page, the
    threshold moves to a quarter of the range from the ink side."""
    h, w = img.shape[:2]
    k = max(1, int(np.ceil(max(h, w) / max_side)))
    small = img[::k, ::k]
    lo, hi = np.percentile(small, (0.5, 99.5))
    thr = (float(lo) + float(hi)) / 2.0
    dark = small < thr
    ink = dark if dark.mean() <= 0.5 else ~dark
    if ink.mean() > 0.25:
        if dark.mean() <= 0.5:
            thr = float(lo) + 0.25 * (float(hi) - float(lo))
        else:
            thr = float(hi) - 0.25 * (float(hi) - float(lo))
        dark = small < thr
        ink = dark if dark.mean() <= 0.5 else ~dark
    ys, xs = np.nonzero(ink)
    if xs.size > max_px:
        sel = np.linspace(0, xs.size - 1, max_px).astype(np.int64)
        xs, ys = xs[sel], ys[sel]
    return xs.astype(np.float32), ys.astype(np.float32)


def _profile_score(xs: np.ndarray, ys: np.ndarray, angle_deg: float) -> float:
    """Sharpness of the horizontal projection profile after undoing a
    rotation by ``angle_deg``."""
    return float(_profile_scores(xs, ys, np.asarray([angle_deg]))[0])


def _profile_scores(xs: np.ndarray, ys: np.ndarray,
                    angles_deg: np.ndarray) -> np.ndarray:
    """``_profile_score`` of each angle: the variance of the row histogram
    over each angle's own occupied span."""
    th = np.deg2rad(np.asarray(angles_deg, np.float64))[:, None]
    y0 = xs[None, :] * np.sin(th) + ys[None, :] * np.cos(th)   # [A, N]
    y0 -= y0.min(axis=1, keepdims=True)
    rows = np.round(y0).astype(np.int64)
    width = int(rows.max()) + 1
    offs = rows + (np.arange(len(th), dtype=np.int64) * width)[:, None]
    prof = np.bincount(offs.ravel(),
                       minlength=len(th) * width).reshape(len(th), width)
    prof = prof.astype(np.float64)
    w_i = rows.max(axis=1).astype(np.float64) + 1.0
    n_pts = float(xs.size)
    sum_p2 = (prof * prof).sum(axis=1)
    return sum_p2 / w_i - (n_pts / w_i) ** 2


def _search(xs: np.ndarray, ys: np.ndarray, max_angle: float,
            coarse_step: float, fine_step: float) -> float:
    if xs.size < 64:
        return 0.0
    coarse = np.arange(-max_angle, max_angle + 1e-6, coarse_step)
    best = coarse[int(np.argmax(_profile_scores(xs, ys, coarse)))]
    fine = np.arange(best - coarse_step, best + coarse_step + 1e-6, fine_step)
    return float(fine[int(np.argmax(_profile_scores(xs, ys, fine)))])


def estimate_skew(img, max_angle: float = 8.0, coarse_step: float = 0.5,
                  fine_step: float = 0.05, max_trusted: float = 6.0,
                  half_tol: float = 0.75, min_gain: float = 1.10) -> float:
    """The page's skew in degrees (``Image.rotate`` convention), or 0.0.

    Coarse-to-fine profile searches on the left and the right half of the
    ink must agree within ``half_tol``; their mean must be within
    ``max_trusted``; the angle refined on all the ink must score at least
    ``min_gain`` times the upright profile.
    """
    img = np.asarray(img)
    if img.ndim == 3:
        img = img.mean(axis=2)
    xs, ys = _ink_coords(img)
    if xs.size < 128:
        return 0.0
    mid = np.median(xs)
    left = xs < mid
    a_l = _search(xs[left], ys[left], max_angle, coarse_step, fine_step)
    a_r = _search(xs[~left], ys[~left], max_angle, coarse_step, fine_step)
    if abs(a_l - a_r) > half_tol:
        return 0.0
    center = (a_l + a_r) / 2.0
    if abs(center) > max_trusted:
        return 0.0
    fine = np.arange(center - coarse_step, center + coarse_step + 1e-6,
                     fine_step)
    best = float(fine[int(np.argmax(_profile_scores(xs, ys, fine)))])
    if _profile_score(xs, ys, best) < min_gain * _profile_score(xs, ys, 0.0):
        return 0.0
    return best


def rotate_image(img: np.ndarray, angle_deg: float) -> np.ndarray:
    """u8 [H, W] rotated about its centre (``Image.rotate`` with
    ``expand=False``), the revealed corners filled with the median level."""
    img = np.asarray(img, np.uint8)
    if abs(angle_deg) < 1e-6:
        return img
    if img.ndim != 2:
        raise ValueError(f"rotate_image takes a gray page, got {img.shape}")
    return rotate_bilinear(img, angle_deg, int(np.median(img)))


def extract_crop_single_resample(orig: np.ndarray, angle_deg: float,
                                 box: Tuple[int, int, int, int], out_h: int,
                                 extra_padding: int = 5,
                                 min_scale: float = 0.75,
                                 fill: Optional[int] = None,
                                 interp: Optional[str] = None
                                 ) -> Optional[np.ndarray]:
    """One line crop of height ``out_h`` cut from the ORIGINAL page with the
    deskew rotation and the scale in a single resample.

    ``box`` is (x, y, w, h) in the deskewed frame (``rotate_image(orig,
    -angle_deg)``), padded and clipped as ``ops.preprocess.crop_region``
    does. Returns None when the box is empty or the scale ``out_h /
    padded_h`` is below ``min_scale`` (strong downscales take the two-step
    path). ``interp`` is "linear" or "cubic"; by default cubic when the
    crop is scaled up, linear otherwise.
    """
    orig = np.asarray(orig)
    h, w = orig.shape[:2]
    x, y, bw, bh = box
    x1 = max(0, int(x) - extra_padding)
    y1 = max(0, int(y) - extra_padding)
    x2 = min(w, int(x) + int(bw) + extra_padding)
    y2 = min(h, int(y) + int(bh) + extra_padding)
    ph, pw = y2 - y1, x2 - x1
    if ph <= 0 or pw <= 0:
        return None
    k = out_h / float(ph)
    if k < min_scale:
        return None
    out_w = max(1, int(round(pw * k)))
    th = np.deg2rad(angle_deg)
    c, s = np.cos(th), np.sin(th)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    # Output pixel (u, v) samples the deskewed-frame point (x1 + (u + 0.5)
    # / k - 0.5, y1 + (v + 0.5) / k - 0.5), carried into the original frame
    # by the forward rotation p' = (x c + y s, -x s + y c) about the centre.
    ox = x1 + 0.5 / k - 0.5 - cx
    oy = y1 + 0.5 / k - 0.5 - cy
    m = np.array([[c / k, s / k, c * ox + s * oy + cx],
                  [-s / k, c / k, -s * ox + c * oy + cy]], np.float64)
    if fill is None:
        fill = int(np.median(orig))
    if interp is None:
        interp = "cubic" if k >= 1.0 else "linear"
    return warp_affine(orig, m, (out_w, out_h), interp, fill)


def boxes_to_original(boxes: Sequence[Tuple[float, float, float, float]],
                      angle_deg: float, shape: Tuple[int, int]
                      ) -> List[Tuple[int, int, int, int]]:
    """(x, y, w, h) boxes of ``rotate_image(img, -angle)`` mapped back to
    the input frame: the axis-aligned hull of the rotated corners, clipped
    to the image."""
    h, w = shape[:2]
    th = np.deg2rad(angle_deg)
    c, s = np.cos(th), np.sin(th)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    out: List[Tuple[int, int, int, int]] = []
    for (x, y, bw, bh) in boxes:
        pts = np.array([[x, y], [x + bw, y], [x, y + bh], [x + bw, y + bh]],
                       np.float64) - (cx, cy)
        pts = pts @ np.array([[c, -s], [s, c]]) + (cx, cy)
        x0, y0 = pts.min(axis=0)
        x1, y1 = pts.max(axis=0)
        x0, y0 = max(0, int(round(x0))), max(0, int(round(y0)))
        x1, y1 = min(w, int(round(x1))), min(h, int(round(y1)))
        out.append((x0, y0, max(0, x1 - x0), max(0, y1 - y0)))
    return out
