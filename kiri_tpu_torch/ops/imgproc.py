"""cv2-free u8 image operations, byte for byte as OpenCV computes them.

The machine with the card has no cv2, and the JAX package's host path
(``kiri_tpu/ops/preprocess.py``, ``kiri_tpu/detect/db/__init__.py``) runs
cv2 on u8 images, where OpenCV works in fixed point. These numpy versions
follow OpenCV's own code (``imgproc/src/resize.cpp``, ``color_rgb``):

- ``bgr_to_gray``: ``COLOR_BGR2GRAY``, 15-bit weights (9798, 19235, 3735)
  rounded half up;
- ``resize_u8(..., "linear")``: ``INTER_LINEAR``, 11-bit weights, the row
  pass in integers and the column pass as ``((b0 * (S0 >> 4)) >> 16) +
  ((b1 * (S1 >> 4)) >> 16) + 2 >> 2``; an exact 2x downscale is ``INTER_AREA``;
- ``resize_u8(..., "cubic")``: ``INTER_CUBIC``, 11-bit weights, the row pass
  in integers, the column pass in float32 (no fused multiply-add) for the
  columns that fill whole vectors of 8 and in integers for the rest;
- ``resize_u8(..., "area")``: ``INTER_AREA`` for downscales, integer block
  means for exact integer factors and float32 weighted sums otherwise.

A cv2 built with Intel IPP (the pip wheels) hands ``INTER_CUBIC`` of images
at least 4 px wide and high to IPP, whose float code depends on the CPU's
instruction set: there these results can differ from cv2's by one grey level
in a few pixels (``tests/test_torch_imgproc.py`` counts them).
"""
from __future__ import annotations

import math

import numpy as np

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS
_DBL_EPS = float(np.finfo(np.float64).eps)
_SIMD_LANES = 8            # int16 lanes of OpenCV's 128-bit baseline vectors
_f32 = np.float32


def bgr_to_gray(img: np.ndarray) -> np.ndarray:
    """u8 [H, W, 3|4] BGR(A) -> u8 [H, W]; the alpha channel is ignored."""
    b, g, r = (img[..., i].astype(np.int32) for i in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).astype(
        np.uint8)


def _short(x: np.ndarray) -> np.ndarray:
    """saturate_cast<short> of float32 values (round half to even)."""
    return np.clip(np.rint(x), -32768, 32767).astype(np.int64)


def _tab(ssize: int, dsize: int, kind: str):
    """Source index and integer weights of each output pixel along one
    axis: (s [d], weights [d, 2 | 4])."""
    scale = 1.0 / (dsize / ssize)
    f = ((np.arange(dsize, dtype=np.float64) + 0.5) * scale - 0.5).astype(_f32)
    s = np.floor(f).astype(np.int64)
    x = (f - s.astype(_f32)).astype(_f32)
    one = _f32(1.0)
    if kind == "linear":
        return s, x, np.stack([one - x, x], -1)
    a = _f32(-0.75)
    c0 = ((a * (x + one) - _f32(5) * a) * (x + one) + _f32(8) * a) * (
        x + one) - _f32(4) * a
    c1 = ((a + _f32(2)) * x - (a + _f32(3))) * x * x + one
    c2 = ((a + _f32(2)) * (one - x) - (a + _f32(3))) * (one - x) * (
        one - x) + one
    c3 = one - c0 - c1 - c2
    return s, x, np.stack([c0, c1, c2, c3], -1)


def _linear_x(ssize: int, dsize: int):
    """Columns: OpenCV clamps the position at both edges (weights 1, 0)."""
    s, x, _ = _tab(ssize, dsize, "linear")
    lo = s < 0
    x, s = np.where(lo, _f32(0), x), np.where(lo, 0, s)
    hi = s >= ssize - 1
    x, s = np.where(hi, _f32(0), x), np.where(hi, ssize - 1, s)
    w = np.stack([_f32(1) - x, x], -1).astype(_f32)
    return s, _short(w * _f32(_COEF_SCALE))


def _taps(s: np.ndarray, k: int, back: int, n: int) -> np.ndarray:
    return np.clip(s[:, None] - back + np.arange(k)[None, :], 0, n - 1)


def _resize_linear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    ih, iw = img.shape
    xs, xw = _linear_x(iw, w)
    # Rows: the weights are not clamped, only the rows read.
    ys, _, yw = _tab(ih, h, "linear")
    yw = _short(yw.astype(_f32) * _f32(_COEF_SCALE))
    rows = (img.astype(np.int64)[:, _taps(xs, 2, 0, iw)] * xw[None]).sum(-1)
    yi = _taps(ys, 2, 0, ih)
    out = (((yw[:, :1] * (rows[yi[:, 0]] >> 4)) >> 16)
           + ((yw[:, 1:] * (rows[yi[:, 1]] >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_f32_linear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """float32 [H, W] -> [h, w] as cv2's ``INTER_LINEAR`` computes float32
    without IPP: float weights, a row pass, then S0*b0 + S1*b1."""
    img = np.ascontiguousarray(img, _f32)
    ih, iw = img.shape
    if (ih, iw) == (h, w):
        return img.copy()
    s, x, _ = _tab(iw, w, "linear")
    lo = s < 0
    x, s = np.where(lo, _f32(0), x), np.where(lo, 0, s)
    hi = s >= iw - 1
    x, s = np.where(hi, _f32(0), x), np.where(hi, iw - 1, s)
    xi = _taps(s, 2, 0, iw)
    rows = img[:, xi[:, 0]] * (_f32(1) - x) + img[:, xi[:, 1]] * x
    ys, _, yw = _tab(ih, h, "linear")
    yi = _taps(ys, 2, 0, ih)
    return (rows[yi[:, 0]] * yw[:, :1] + rows[yi[:, 1]] * yw[:, 1:]).astype(
        _f32)


def _resize_cubic(img: np.ndarray, w: int, h: int) -> np.ndarray:
    ih, iw = img.shape
    xs, _, xw = _tab(iw, w, "cubic")
    ys, _, yw = _tab(ih, h, "cubic")
    xw = _short(xw.astype(_f32) * _f32(_COEF_SCALE))
    yw = _short(yw.astype(_f32) * _f32(_COEF_SCALE))
    rows = (img.astype(np.int64)[:, _taps(xs, 4, 1, iw)] * xw[None]).sum(-1)
    yi = _taps(ys, 4, 1, ih)
    src = [rows[yi[:, k]] for k in range(4)]
    out = np.clip((sum(src[k] * yw[:, k:k + 1] for k in range(4))
                   + (1 << 21)) >> 22, 0, 255)
    # The columns that fill whole vectors: float32, S0*b0 + (S1*b1 + (S2*b2
    # + S3*b3)), rounded half to even.
    nv = w // _SIMD_LANES * _SIMD_LANES
    if nv:
        scale = _f32(1.0 / (_COEF_SCALE * _COEF_SCALE))
        b = [(yw[:, k:k + 1].astype(_f32) * scale) for k in range(4)]
        f = [s[:, :nv].astype(_f32) for s in src]
        v = f[0] * b[0] + (f[1] * b[1] + (f[2] * b[2] + f[3] * b[3]))
        out[:, :nv] = np.clip(np.rint(v), 0, 255)
    return out.astype(np.uint8)


def _area_tab(ssize: int, dsize: int, scale: float):
    """OpenCV's ``computeResizeAreaTab``: (dst index, src index, weight)."""
    di, si, al = [], [], []
    for dx in range(dsize):
        f1 = dx * scale
        f2 = f1 + scale
        cell = min(scale, ssize - f1)
        s2 = min(math.floor(f2), ssize - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            di.append(dx), si.append(s1 - 1), al.append((s1 - f1) / cell)
        for sx in range(s1, s2):
            di.append(dx), si.append(sx), al.append(1.0 / cell)
        if f2 - s2 > 1e-3:
            di.append(dx), si.append(s2)
            al.append(min(min(f2 - s2, 1.0), cell) / cell)
    return np.asarray(di), np.asarray(si), np.asarray(al, _f32)


def _accumulate(src: np.ndarray, di, si, al, n: int, axis: int):
    """Weighted sums along ``axis`` in the table's order, float32: the first
    term of each output is assigned, the others added one at a time."""
    counts = np.bincount(di, minlength=n)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    shape = list(src.shape)
    shape[axis] = n
    out = np.zeros(shape, _f32)
    for j in range(int(counts.max())):
        has = np.nonzero(counts > j)[0]
        e = start[has] + j
        if axis == 1:
            term = src[:, si[e]] * al[e][None, :]
            out[:, has] = term if j == 0 else out[:, has] + term
        else:
            term = src[si[e]] * al[e][:, None]
            out[has] = term if j == 0 else out[has] + term
    return out


def _resize_area(img: np.ndarray, w: int, h: int) -> np.ndarray:
    ih, iw = img.shape
    sx, sy = 1.0 / (w / iw), 1.0 / (h / ih)
    ix, iy = int(round(sx)), int(round(sy))
    if abs(sx - ix) < _DBL_EPS and abs(sy - iy) < _DBL_EPS:
        blk = img[:h * iy, :w * ix].astype(np.int64).reshape(
            h, iy, w, ix).sum((1, 3))
        if ix == 2 and iy == 2:
            return ((blk + 2) >> 2).astype(np.uint8)
        v = blk.astype(_f32) * (_f32(1) / _f32(ix * iy))
        return np.clip(np.rint(v), 0, 255).astype(np.uint8)
    rows = _accumulate(img.astype(_f32), *_area_tab(iw, w, sx), w, axis=1)
    out = _accumulate(rows, *_area_tab(ih, h, sy), h, axis=0)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resize_u8(img: np.ndarray, w: int, h: int, interp: str = "linear"
              ) -> np.ndarray:
    """u8 [H, W] -> u8 [h, w], as ``cv2.resize(img, (w, h),
    interpolation=INTER_LINEAR | INTER_CUBIC | INTER_AREA)`` computes it
    ("area" only for downscales in both directions)."""
    if interp not in ("linear", "cubic", "area"):
        raise ValueError(f"interp must be linear, cubic or area: {interp!r}")
    img = np.ascontiguousarray(img, np.uint8)
    ih, iw = img.shape
    if (ih, iw) == (h, w):
        return img.copy()
    sx, sy = 1.0 / (w / iw), 1.0 / (h / ih)
    if interp == "linear" and abs(sx - 2) < _DBL_EPS and abs(sy - 2) < _DBL_EPS:
        interp = "area"
    if interp == "area":
        if sx < 1 or sy < 1:
            raise NotImplementedError("area interpolation upscales in cv2 "
                                      "by a linear variant; not ported")
        return _resize_area(img, w, h)
    return _resize_linear(img, w, h) if interp == "linear" else \
        _resize_cubic(img, w, h)
