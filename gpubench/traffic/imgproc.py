"""Frozen copy of the resizes, blur and morphology of
kiri_tpu_torch/ops/imgproc.py at commit
0bc739aac3bff3542a3b3238ea9226e557ccfdbd, for the benchmark's traffic and
reference (the warps, rotations and colour conversions left out); later
changes to the program do not reach it. The original's docstring follows.

cv2-free u8 image operations, byte for byte as OpenCV computes them.

The machine with the card has no cv2, and the JAX package's host path
(``kiri_tpu/ops/preprocess.py``, ``kiri_tpu/detect/db/__init__.py``) runs
cv2 on u8 images, where OpenCV works in fixed point. These numpy versions
follow OpenCV's own code (``imgproc/src/resize.cpp``, ``color_rgb``):

- ``resize_u8(..., "linear")``: ``INTER_LINEAR``, 11-bit weights, the row
  pass in integers and the column pass as ``((b0 * (S0 >> 4)) >> 16) +
  ((b1 * (S1 >> 4)) >> 16) + 2 >> 2``; an exact 2x downscale is ``INTER_AREA``;
- ``resize_u8(..., "cubic")``: ``INTER_CUBIC``, 11-bit weights, the row pass
  in integers, the column pass in float32 (no fused multiply-add) for the
  columns that fill whole vectors of 8 and in integers for the rest;
- ``resize_u8(..., "area")``: ``INTER_AREA`` for downscales, integer block
  means for exact integer factors and float32 weighted sums otherwise;
- ``pil_resize_width_bilinear``: Pillow's ``Image.resize((w, H), BILINEAR)``
  of an "L" image (``Resample.c``: the triangle filter widened by the scale
  when it shrinks, float64 coefficients normalised per output pixel, then
  rounded to 22-bit fixed point, sums rounded half up and clipped);
- ``pil_resize_bilinear``: the same on both axes, through Pillow's 8-bit
  intermediate image;
- ``gaussian_blur_u8`` and ``morph_2x2``: ``cv2.GaussianBlur(k, k, 0)``
  for k = 3, 5 and ``cv2.erode``/``cv2.dilate`` with a 2x2 kernel, as the
  line generator's augmentation calls them;

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
    """u8 [H, W] or [H, W, C] -> u8 [h, w(, C)], as ``cv2.resize(img,
    (w, h), interpolation=INTER_LINEAR | INTER_CUBIC | INTER_AREA)``
    computes it ("area" only for downscales in both directions); OpenCV
    resizes each channel alike."""
    if interp not in ("linear", "cubic", "area"):
        raise ValueError(f"interp must be linear, cubic or area: {interp!r}")
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 3:
        return np.stack([resize_u8(img[..., c], w, h, interp)
                         for c in range(img.shape[2])], -1)
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


_PIL_BITS = 22               # Resample.c's PRECISION_BITS for 8-bit images


def _pil_bilinear_coeffs(in_size: int, out_size: int):
    """Per output pixel: first source pixel, tap count and fixed-point
    weights [out, taps] of Pillow's bilinear filter."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    counts = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = np.array([max(0.0, 1.0 - abs((x + xmin - center + 0.5)
                                          / filterscale))
                      for x in range(xmax)], np.float64)
        ww = float(sum(w.tolist()))
        if ww != 0.0:
            w = w / ww
        q = w * (1 << _PIL_BITS)
        kk[xx, :xmax] = np.where(q < 0, np.trunc(q - 0.5), np.trunc(q + 0.5))
        xmins[xx], counts[xx] = xmin, xmax
    return xmins, counts, kk


def pil_resize_width_bilinear(img: np.ndarray, width: int) -> np.ndarray:
    """u8 [H, W] -> u8 [H, width] as Pillow's ``Image.resize((width, H),
    Image.BILINEAR)``: only the horizontal pass runs."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape
    if width == w:
        return img.copy()
    xmins, counts, kk = _pil_bilinear_coeffs(w, width)
    acc = np.full((h, width), 1 << (_PIL_BITS - 1), np.int64)
    src = img.astype(np.int64)
    for t in range(kk.shape[1]):
        live = t < counts
        cols = np.where(live, xmins + t, 0)
        acc += src[:, cols] * np.where(live, kk[:, t], 0)[None]
    return np.clip(acc >> _PIL_BITS, 0, 255).astype(np.uint8)


def pil_resize_bilinear(img: np.ndarray, width: int, height: int
                        ) -> np.ndarray:
    """u8 [H, W] -> u8 [height, width] as Pillow's ``Image.resize((width,
    height), Image.BILINEAR)``: the horizontal pass (when the width
    changes) into an 8-bit image, then the vertical pass over it with the
    same filter, each rounded half up and clipped. (Pillow resamples only
    the rows the vertical pass reads; the result is the same.)"""
    img = np.ascontiguousarray(img, np.uint8)
    if width != img.shape[1]:
        img = pil_resize_width_bilinear(img, width)
    if height != img.shape[0]:
        img = np.ascontiguousarray(
            pil_resize_width_bilinear(img.T, height).T)
    return img


def _reflect101(n: int, size: int, pad: int) -> np.ndarray:
    """Source indices of [-pad, size + pad) under OpenCV's
    ``BORDER_REFLECT_101`` (``borderInterpolate``; one pixel repeats)."""
    idx = []
    for p in range(-pad, size + pad):
        if size == 1:
            idx.append(0)
            continue
        while not 0 <= p < size:
            p = -p if p < 0 else 2 * size - p - 2
        idx.append(p)
    return np.asarray(idx, np.int64)


#: OpenCV's small Gaussian kernels of ``getGaussianKernel(k, 0)``, in the
#: 8 fraction bits of its fixed-point u8 path (all exact).
_GAUSS_Q8 = {3: (64, 128, 64), 5: (16, 64, 96, 64, 16)}


def gaussian_blur_u8(img: np.ndarray, k: int) -> np.ndarray:
    """u8 [H, W] as OpenCV 5.0's ``cv2.GaussianBlur(img, (k, k), 0)`` for
    k = 3 or 5: the bit-exact fixed-point path (row taps in 8 fraction bits,
    columns in 16, the sum rounded half up), ``BORDER_REFLECT_101``."""
    taps = _GAUSS_Q8[k]
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape
    r = k // 2
    src = img.astype(np.int64)[_reflect101(h, h, r)][:, _reflect101(w, w, r)]
    rows = sum(t * src[:, i:i + w] for i, t in enumerate(taps))
    acc = sum(t * rows[i:i + h] for i, t in enumerate(taps))
    return ((acc + (1 << 15)) >> 16).astype(np.uint8)


def morph_2x2(img: np.ndarray, op: str) -> np.ndarray:
    """u8 [H, W] as ``cv2.erode`` (op "erode") or ``cv2.dilate``
    ("dilate") with a 2x2 kernel of ones, one iteration: the anchor at
    (1, 1), so each pixel takes the min or max of itself and its upper,
    left and upper-left neighbours; pixels off the image are ignored."""
    img = np.ascontiguousarray(img, np.uint8)
    f = np.minimum if op == "erode" else np.maximum
    out = img.copy()
    out[1:] = f(out[1:], img[:-1])
    out[:, 1:] = f(out[:, 1:], out[:, :-1].copy())
    return out
