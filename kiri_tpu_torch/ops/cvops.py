"""The classic-CV detector's image operations without cv2, byte for byte as
OpenCV 5.0 computes them (held to cv2 5.0.0 with IPP on and off in
``tests/test_torch_cvops.py``).

numpy here: thresholds (fixed and Otsu), the box mean of
``adaptiveThreshold``, ``COLOR_BGR2HSV`` and ``COLOR_BGR2LAB`` of u8 images
(OpenCV's integer tables), the morphological gradient with the 3x3 cross,
``Sobel(CV_64F, ksize=3)`` and ``dilate`` with a rectangle. The native
library (``native/cvops.cpp``) does CLAHE, the gaussian local mean, MSER,
connected components, Canny and the external contours' rectangles.

One finding of the probing: ``adaptiveThreshold(ADAPTIVE_THRESH_GAUSSIAN_C)``
blurs a float32 copy of the image (not the 8-bit fixed-point
``GaussianBlur``), so its bytes depend on the float operation order, which
``native/cvops.cpp::gauss_mean`` states.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..native.cvops import (canny, clahe, connected_components_with_stats,
                            external_contour_rects, gaussian_mean, mser)

__all__ = ["adaptive_threshold", "bgr_to_hsv", "bgr_to_lab", "canny",
           "clahe", "connected_components_with_stats", "dilate_rect",
           "external_contour_rects", "morph_gradient_cross", "mser",
           "otsu_threshold", "sobel3", "threshold", "threshold_otsu"]

_FLT_EPSILON = float(np.finfo(np.float32).eps)


def threshold(img: np.ndarray, thresh: float, inv: bool = False
              ) -> np.ndarray:
    """``cv2.threshold(img, thresh, 255, THRESH_BINARY[_INV])[1]`` of u8."""
    t = int(np.floor(thresh))
    above = np.asarray(img) > t
    return np.where(above != inv, 255, 0).astype(np.uint8)


def otsu_threshold(img: np.ndarray) -> int:
    """The threshold ``THRESH_OTSU`` picks for a u8 image (OpenCV's double
    loop over the histogram, ties to the lowest level)."""
    img = np.asarray(img, np.uint8)
    hist = np.bincount(img.ravel(), minlength=256)
    scale = 1.0 / img.size
    mu = 0.0
    for i in range(256):
        mu += i * float(hist[i])
    mu *= scale
    mu1 = q1 = 0.0
    max_sigma, max_val = 0.0, 0
    for i in range(256):
        p_i = hist[i] * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < _FLT_EPSILON or max(q1, q2) > 1.0 - _FLT_EPSILON:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma, max_val = sigma, i
    return max_val


def threshold_otsu(img: np.ndarray) -> Tuple[int, np.ndarray]:
    """``cv2.threshold(img, 0, 255, THRESH_BINARY + THRESH_OTSU)``."""
    t = otsu_threshold(img)
    return t, threshold(img, t)


def _box_mean(img: np.ndarray, ksize: int) -> np.ndarray:
    """Normalised ``boxFilter`` with BORDER_REPLICATE of u8: the integer
    window sum over ksize**2 (odd), rounded (never a tie)."""
    r = ksize // 2
    pad = np.pad(img.astype(np.int64), r, mode="edge")
    c = np.zeros((pad.shape[0] + 1, pad.shape[1] + 1), np.int64)
    c[1:, 1:] = pad.cumsum(0).cumsum(1)
    h, w = img.shape
    s = (c[ksize:ksize + h, ksize:ksize + w] - c[:h, ksize:ksize + w]
         - c[ksize:ksize + h, :w] + c[:h, :w])
    n = ksize * ksize
    return ((2 * s + n) // (2 * n)).astype(np.int64)


def adaptive_threshold(img: np.ndarray, method: str, block: int,
                       c: float) -> np.ndarray:
    """``cv2.adaptiveThreshold(img, 255, ADAPTIVE_THRESH_<method>_C,
    THRESH_BINARY, block, c)`` of u8, ``method`` "mean" or "gaussian"."""
    img = np.ascontiguousarray(img, np.uint8)
    if method == "mean":
        mean = _box_mean(img, block)
    elif method == "gaussian":
        mean = gaussian_mean(img, block).astype(np.int64)
    else:
        raise ValueError(f"method must be mean or gaussian: {method!r}")
    idelta = int(np.ceil(c))
    return np.where(img.astype(np.int64) - mean > -idelta, 255, 0).astype(
        np.uint8)


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_BGR2HSV)`` of u8 [H, W, 3] (hue 0-179):
    OpenCV's 12-bit division tables."""
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    v = np.maximum(np.maximum(b, g), r)
    vmin = np.minimum(np.minimum(b, g), r)
    diff = v - vmin
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << 12) / i)
    hdiv[1:] = np.rint((180 << 12) / (6.0 * i))
    s = (diff * sdiv[v] + (1 << 11)) >> 12
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + (1 << 11)) >> 12
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def _lab_tables():
    """OpenCV's u8 Lab tables: the sRGB gamma (x 8, rounded), the cube
    root (x 2**15 at i / 2040 in float32; the root itself cut to float32
    toward zero, as OpenCV's soft-float ``cbrt`` gives it; the linear part
    below 216/24389) and the 12-bit XYZ rows over the D65 white."""
    f32 = np.float32
    x = np.arange(256) / 255.0
    gamma = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    gamma_tab = np.rint(255.0 * 8 * gamma).astype(np.int64)
    xf = (f32(1) / f32(2040) * np.arange(3072).astype(f32)).astype(f32)
    xd = xf.astype(np.float64)
    root = np.cbrt(xd)
    r32 = root.astype(f32)
    r32 = np.where(r32.astype(np.float64) > root,
                   np.nextafter(r32, f32(0)), r32)
    lin = (xd * float(f32(841) / f32(108))
           + float(f32(16) / f32(116))).astype(f32)
    c = np.where(xf < f32(216) / f32(24389), lin, r32).astype(np.float64)
    cbrt_tab = np.rint(c * 32768).astype(np.int64)
    d65 = (0.950456, 1.0, 1.088754)
    m = (0.412453, 0.357580, 0.180423, 0.212671, 0.715160, 0.072169,
         0.019334, 0.119193, 0.950227)
    # Per XYZ row, the B, G, R weights.
    coeffs = [[int(np.rint(4096 * m[3 * r + k] / d65[r])) for k in (2, 1, 0)]
              for r in range(3)]
    return gamma_tab, cbrt_tab, coeffs


_LAB = None


def bgr_to_lab(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_BGR2LAB)`` of u8 [H, W, 3]."""
    global _LAB
    if _LAB is None:
        _LAB = _lab_tables()
    gamma_tab, cbrt_tab, coeffs = _LAB
    bgr = [gamma_tab[img[..., i]] for i in range(3)]

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    fx, fy, fz = (cbrt_tab[descale(sum(c * ch for c, ch in zip(row, bgr)),
                                   12)] for row in coeffs)
    l_scale = (116 * 255 + 50) // 100
    l_shift = -((16 * 255 * (1 << 15) + 50) // 100)
    lab = (descale(l_scale * fy + l_shift, 15),
           descale(500 * (fx - fy) + 128 * (1 << 15), 15),
           descale(200 * (fy - fz) + 128 * (1 << 15), 15))
    return np.clip(np.stack(lab, -1), 0, 255).astype(np.uint8)


def morph_gradient_cross(img: np.ndarray) -> np.ndarray:
    """``cv2.morphologyEx(img, MORPH_GRADIENT, ellipse 3x3)`` of u8: the
    3x3 ellipse is the cross; pixels outside the image are ignored."""
    img = np.asarray(img, np.uint8)
    lo = np.pad(img, 1, constant_values=255)
    hi = np.pad(img, 1, constant_values=0)
    h, w = img.shape
    taps = ((0, 1), (1, 0), (1, 1), (1, 2), (2, 1))
    dil = np.max([hi[y:y + h, x:x + w] for y, x in taps], 0)
    ero = np.min([lo[y:y + h, x:x + w] for y, x in taps], 0)
    return dil - ero


def sobel3(img: np.ndarray, dx: int, dy: int) -> np.ndarray:
    """``cv2.Sobel(img, CV_64F, dx, dy, ksize=3)`` with dx + dy == 1
    (BORDER_REFLECT_101)."""
    p = np.pad(np.asarray(img).astype(np.int64), 1, mode="reflect")
    h, w = np.shape(img)
    if (dx, dy) == (1, 0):
        d = p[:, 2:] - p[:, :-2]
        out = d[:-2] + 2 * d[1:-1] + d[2:]
    elif (dx, dy) == (0, 1):
        d = p[2:] - p[:-2]
        out = d[:, :-2] + 2 * d[:, 1:-1] + d[:, 2:]
    else:
        raise ValueError("sobel3 takes (dx, dy) = (1, 0) or (0, 1)")
    return out[:h, :w].astype(np.float64)


def dilate_rect(img: np.ndarray, kw: int, kh: int = 1,
                iterations: int = 1) -> np.ndarray:
    """``cv2.dilate(img, getStructuringElement(MORPH_RECT, (kw, kh)),
    iterations=iterations)`` of u8 with odd kw, kh (pixels outside the
    image are ignored, so the iterations compose to one wider window)."""
    img = np.asarray(img, np.uint8)
    rx, ry = (kw // 2) * iterations, (kh // 2) * iterations
    h, w = img.shape
    p = np.pad(img, ((ry, ry), (rx, rx)), constant_values=0)
    out = np.zeros_like(img)
    for y in range(2 * ry + 1):
        for x in range(2 * rx + 1):
            np.maximum(out, p[y:y + h, x:x + w], out=out)
    return out
