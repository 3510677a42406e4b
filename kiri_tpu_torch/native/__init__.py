"""ctypes binding of the detector's host geometry (``geometry.cpp``, a copy
of ``kiri_tpu/native/geometry.cpp``); ``native/cvops.py`` binds the
classic-CV detector's pixel operations (``cvops.cpp``) the same way.

Each library is compiled with ``g++ -O3`` the first time it is needed, into
``build/kiri_tpu_torch/lib<name>_<hash>.so`` at the root of the checkout
(the hash covers the source and the flags). There is no fallback: a failed
build raises with the compiler's output, because the numpy stand-ins of the
JAX package (an axis-aligned ``min_area_rect`` among them) give other boxes.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "geometry.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kiri_tpu_torch"
FLAGS = ["-O3", "-shared", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_int, _dbl = ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    "connected_components": (_int, [_u8p, _int, _int, _i32p, _i32p, _int]),
    "convex_hull": (_int, [_f64p, _int, _f64p]),
    "min_area_rect": (None, [_f64p, _int, _f64p]),
    "offset_convex_polygon": (_int, [_f64p, _int, _dbl, _f64p, _int, _int]),
    "box_score": (_dbl, [_f32p, _int, _int, _f64p]),
    "polygon_area_perimeter": (None, [_f64p, _int, _f64p, _f64p]),
    "component_boundary": (_int, [_i32p, _int, _int, _int, _f64p, _int]),
    "dilate": (None, [_u8p, _int, _int, _int, _u8p]),
}


def built_path(src: Path, stem: str, flags) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"


def lib_path() -> Path:
    return built_path(SRC, "kiri_geom", FLAGS)


def _build(src: Path, out: Path, flags) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: the host library {src} is "
                           "compiled at first use")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {src.name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)


def load_library(src: Path, stem: str, flags, signatures) -> ctypes.CDLL:
    """``src`` built (if its hashed library is not there yet) and loaded,
    with the ctypes ``signatures``; raises if it cannot be built."""
    out = built_path(src, stem, flags)
    if not out.exists():
        _build(src, out, flags)
    lib = ctypes.CDLL(str(out))
    for name, (res, args) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load_library(SRC, "kiri_geom", FLAGS, _SIGNATURES)
        return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _points(points: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.reshape(points, (-1, 2)), np.float64)


def connected_components(bitmap: np.ndarray, max_components: int = 4096
                         ) -> Tuple[int, np.ndarray, np.ndarray]:
    """8-connected components: (n, labels int32 [h, w], stats int32 [n, 5]
    = (x, y, w, h, area))."""
    bitmap = np.ascontiguousarray(bitmap, np.uint8)
    h, w = bitmap.shape
    labels = np.zeros((h, w), np.int32)
    stats = np.zeros((max_components, 5), np.int32)
    n = get_lib().connected_components(
        _ptr(bitmap, ctypes.c_uint8), h, w, _ptr(labels, ctypes.c_int32),
        _ptr(stats, ctypes.c_int32), max_components)
    return n, labels, stats[:n]


def min_area_rect(points: np.ndarray) -> Tuple[Tuple[float, float],
                                               Tuple[float, float], float]:
    """cv2.minAreaRect-compatible: ((cx, cy), (w, h), angle in (0, 90])."""
    pts = _points(points)
    out = np.zeros(5, np.float64)
    get_lib().min_area_rect(_ptr(pts, ctypes.c_double), len(pts),
                            _ptr(out, ctypes.c_double))
    return ((out[0], out[1]), (out[2], out[3]), out[4])


def box_points(rect) -> np.ndarray:
    """cv2.boxPoints-compatible corners, float32 [4, 2]."""
    (cx, cy), (w, h), angle = rect
    a = math.radians(angle)
    ca, sa = math.cos(a), math.sin(a)
    dx, dy = w / 2.0, h / 2.0
    corners = np.array([[-dx, dy], [-dx, -dy], [dx, -dy], [dx, dy]])
    rot = np.array([[ca, -sa], [sa, ca]])
    return (corners @ rot.T + np.array([cx, cy])).astype(np.float32)


def convex_hull(points: np.ndarray) -> np.ndarray:
    pts = _points(points)
    out = np.zeros_like(pts)
    k = get_lib().convex_hull(_ptr(pts, ctypes.c_double), len(pts),
                              _ptr(out, ctypes.c_double))
    return out[:k]


def offset_polygon(poly: np.ndarray, distance: float,
                   arc_points: int = 16) -> Optional[np.ndarray]:
    """A convex polygon grown by ``distance`` with round joins (pyclipper's
    JT_ROUND); None when nothing is left."""
    poly = _points(poly)
    max_out = len(poly) * (arc_points + 2) + 8
    out = np.zeros((max_out, 2), np.float64)
    m = get_lib().offset_convex_polygon(
        _ptr(poly, ctypes.c_double), len(poly), float(distance),
        _ptr(out, ctypes.c_double), max_out, arc_points)
    return out[:m] if m else None


def polygon_area_perimeter(poly: np.ndarray) -> Tuple[float, float]:
    poly = _points(poly)
    a, p = ctypes.c_double(), ctypes.c_double()
    get_lib().polygon_area_perimeter(_ptr(poly, ctypes.c_double), len(poly),
                                     ctypes.byref(a), ctypes.byref(p))
    return a.value, p.value


def box_score(pred: np.ndarray, box: np.ndarray) -> float:
    """Mean of ``pred`` inside the quad."""
    pred = np.ascontiguousarray(pred, np.float32)
    quad = np.ascontiguousarray(np.reshape(box, (4, 2)), np.float64)
    h, w = pred.shape
    return float(get_lib().box_score(_ptr(pred, ctypes.c_float), h, w,
                                     _ptr(quad, ctypes.c_double)))


def component_boundary(labels: np.ndarray, label: int,
                       max_pts: int = 100000) -> np.ndarray:
    """Boundary pixels (x, y) of one component of ``labels``."""
    labels = np.ascontiguousarray(labels, np.int32)
    h, w = labels.shape
    out = np.zeros((max_pts, 2), np.float64)
    m = get_lib().component_boundary(_ptr(labels, ctypes.c_int32), h, w,
                                     int(label), _ptr(out, ctypes.c_double),
                                     max_pts)
    return out[:m]


def dilate(bitmap: np.ndarray, ksize: int) -> np.ndarray:
    bitmap = np.ascontiguousarray(bitmap, np.uint8)
    h, w = bitmap.shape
    out = np.zeros_like(bitmap)
    get_lib().dilate(_ptr(bitmap, ctypes.c_uint8), h, w, int(ksize),
                     _ptr(out, ctypes.c_uint8))
    return out
