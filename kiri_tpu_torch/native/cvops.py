"""ctypes binding of ``cvops.cpp``: the classic-CV detector's pixel
operations that are loops over pixels (MSER, connected components, Canny,
external contours) or float32 filters whose operation order decides the
bytes (CLAHE, the gaussian local mean), and the PNG reader's row filters.
Each gives OpenCV 5.0's exact output; the numpy operations of
``ops/cvops.py`` call these.

The library is built with ``g++ -O3 -ffp-contract=off`` at first use into
``build/kiri_tpu_torch/libkiri_cvops_<hash>.so`` (no contraction: the
source states each fused multiply-add it wants); a failed build raises.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from . import load_library

SRC = Path(__file__).resolve().parent / "cvops.cpp"
FLAGS = ["-O3", "-ffp-contract=off", "-shared", "-fPIC"]

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_int, _dbl = ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    "mser_detect": (_int, [_u8p, _int, _int, _int, _int, _int,
                           ctypes.c_float, _dbl]),
    "mser_points_total": (ctypes.c_long, []),
    "mser_fetch": (None, [_i32p, _i32p, _f64p, _f64p, _i32p]),
    "cc_stats8": (_int, [_u8p, _int, _int, _i32p, _i32p]),
    "canny": (None, [_u8p, _int, _int, _int, _int, _u8p]),
    "external_rects": (_int, [_u8p, _int, _int, _i32p]),
    "clahe": (None, [_u8p, _int, _int, _dbl, _int, _int, _u8p]),
    "gaussian_kernel": (None, [_int, _f32p]),
    "gauss_mean": (None, [_u8p, _int, _int, _int, _u8p]),
    "png_unfilter": (_int, [_u8p, _int, _int, _int, _u8p]),
}

_lib: Optional[ctypes.CDLL] = None
# mser_detect keeps its result inside the library until mser_fetch.
_lock = threading.Lock()


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = load_library(SRC, "kiri_cvops", FLAGS, _SIGNATURES)
        return _lib


def _u8(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"expected a 2-D u8 image, got shape {img.shape}")
    return img


def _p(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class MserRegions:
    """The regions of one ``mser``: ``rects`` int32 [n, 4] (x, y, w, h),
    ``sizes`` [n], ``area`` and ``hull_area`` float64 [n]
    (``cv2.contourArea`` of the region's pixel list and of its convex hull)
    and, when asked for, ``points``: one int32 [size, 2] (x, y) array a
    region, in OpenCV's order."""

    def __init__(self, rects, sizes, area, hull_area, points):
        self.rects, self.sizes = rects, sizes
        self.area, self.hull_area = area, hull_area
        self.points: Optional[List[np.ndarray]] = points


def mser(img: np.ndarray, delta: int = 5, min_area: int = 60,
         max_area: int = 14400, max_variation: float = 0.25,
         min_diversity: float = 0.2, points: bool = False) -> MserRegions:
    """``cv2.MSER_create(delta, min_area, max_area, max_variation,
    min_diversity).detectRegions(img)`` of a u8 grey image (the other
    parameters only act on colour images): the regions of the dark-on-light
    pass, then of the light-on-dark pass. A region is kept only when its
    variation is at least ``min_diversity``, as OpenCV 5.0 keeps it."""
    img = _u8(img)
    h, w = img.shape
    if h < 3 or w < 3:
        raise ValueError("MSER needs an image of at least 3x3")
    lib = get_lib()
    with _lock:
        n = lib.mser_detect(_p(img, ctypes.c_uint8), h, w, delta, min_area,
                            max_area, max_variation, min_diversity)
        rects = np.zeros((n, 4), np.int32)
        sizes = np.zeros(n, np.int32)
        area = np.zeros(n, np.float64)
        hull = np.zeros(n, np.float64)
        pts = np.zeros((lib.mser_points_total() if points else 0, 2),
                       np.int32)
        lib.mser_fetch(_p(rects, ctypes.c_int32), _p(sizes, ctypes.c_int32),
                       _p(area, ctypes.c_double), _p(hull, ctypes.c_double),
                       _p(pts, ctypes.c_int32) if points else None)
    regions = None
    if points:
        ends = np.cumsum(sizes)
        regions = [pts[e - s:e] for s, e in zip(sizes, ends)]
    return MserRegions(rects, sizes, area, hull, regions)


def connected_components_with_stats(img: np.ndarray
                                    ) -> Tuple[int, np.ndarray, np.ndarray]:
    """``cv2.connectedComponentsWithStats(img, connectivity=8)`` without
    centroids: (n, labels int32 [h, w], stats int32 [n, 5] of (x, y, w, h,
    area), row 0 the background), labels numbered as OpenCV numbers them,
    every component kept."""
    img = _u8(img)
    h, w = img.shape
    labels = np.zeros((h, w), np.int32)
    stats = np.zeros(((h + 1) // 2 * ((w + 1) // 2) + 1, 5), np.int32)
    n = get_lib().cc_stats8(_p(img, ctypes.c_uint8), h, w,
                            _p(labels, ctypes.c_int32),
                            _p(stats, ctypes.c_int32))
    return n, labels, stats[:n].copy()


def canny(img: np.ndarray, low: int, high: int) -> np.ndarray:
    """``cv2.Canny(img, low, high)`` (aperture 3, L1 gradient), integer
    thresholds."""
    img = _u8(img)
    out = np.zeros_like(img)
    get_lib().canny(_p(img, ctypes.c_uint8), img.shape[0], img.shape[1],
                    int(low), int(high), _p(out, ctypes.c_uint8))
    return out


def external_contour_rects(img: np.ndarray) -> np.ndarray:
    """``[cv2.boundingRect(c) for c in cv2.findContours(img,
    cv2.RETR_EXTERNAL, method)[0]]`` as int32 [n, 4], in OpenCV's order."""
    img = _u8(img)
    h, w = img.shape
    rects = np.zeros(((h + 1) // 2 * ((w + 1) // 2), 4), np.int32)
    n = get_lib().external_rects(_p(img, ctypes.c_uint8), h, w,
                                 _p(rects, ctypes.c_int32))
    return rects[:n].copy()


def clahe(img: np.ndarray, clip_limit: float = 2.0,
          tiles: Tuple[int, int] = (8, 8)) -> np.ndarray:
    """``cv2.createCLAHE(clip_limit, tiles).apply(img)`` of a u8 image."""
    img = _u8(img)
    out = np.zeros_like(img)
    get_lib().clahe(_p(img, ctypes.c_uint8), img.shape[0], img.shape[1],
                    float(clip_limit), int(tiles[0]), int(tiles[1]),
                    _p(out, ctypes.c_uint8))
    return out


def gaussian_kernel(ksize: int) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, 0, cv2.CV_32F)`` for an odd ksize of
    at least 11, float32 [ksize]."""
    if ksize < 11 or ksize % 2 == 0:
        raise ValueError(f"odd ksize >= 11 expected, got {ksize}")
    out = np.zeros(ksize, np.float32)
    get_lib().gaussian_kernel(ksize, _p(out, ctypes.c_float))
    return out


def gaussian_mean(img: np.ndarray, ksize: int) -> np.ndarray:
    """The u8 local mean of ``cv2.adaptiveThreshold(...,
    ADAPTIVE_THRESH_GAUSSIAN_C, ..., ksize, ...)``: the float32 gaussian
    blur with BORDER_REPLICATE, rounded."""
    if ksize < 11 or ksize % 2 == 0:
        raise ValueError(f"odd ksize >= 11 expected, got {ksize}")
    img = _u8(img)
    out = np.zeros_like(img)
    get_lib().gauss_mean(_p(img, ctypes.c_uint8), img.shape[0], img.shape[1],
                         int(ksize), _p(out, ctypes.c_uint8))
    return out


def png_unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The PNG row filters undone: ``raw`` is h rows of a filter byte and
    ``stride`` bytes; returns u8 [h, stride]."""
    data = np.frombuffer(raw, np.uint8)
    if data.size < h * (stride + 1):
        raise ValueError("truncated PNG image data")
    data = np.ascontiguousarray(data[:h * (stride + 1)])
    out = np.zeros((h, stride), np.uint8)
    if get_lib().png_unfilter(_p(data, ctypes.c_uint8), h, stride, bpp,
                              _p(out, ctypes.c_uint8)):
        raise ValueError("bad PNG filter type")
    return out
