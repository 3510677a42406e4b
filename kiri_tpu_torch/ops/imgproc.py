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
  means for exact integer factors and float32 weighted sums otherwise;
- ``warp_affine``: ``warpAffine(..., WARP_INVERSE_MAP, BORDER_CONSTANT)`` of
  OpenCV 5.0 for ``INTER_LINEAR`` and ``INTER_CUBIC``, which interpolate in
  float32 at the exact source position (not in a fixed-point remap): see
  the function for the operation order;
- ``rotate_bilinear``: Pillow's ``Image.rotate(angle, BILINEAR,
  expand=False, fillcolor=fill)`` of an "L" image (``Geometry.c``: float64
  positions at pixel centres, truncation of the filtered value);
- ``pil_resize_width_bilinear``: Pillow's ``Image.resize((w, H), BILINEAR)``
  of an "L" image (``Resample.c``: the triangle filter widened by the scale
  when it shrinks, float64 coefficients normalised per output pixel, then
  rounded to 22-bit fixed point, sums rounded half up and clipped);
- ``pil_resize_bilinear``: the same on both axes, through Pillow's 8-bit
  intermediate image;
- ``gaussian_blur_u8`` and ``morph_2x2``: ``cv2.GaussianBlur(k, k, 0)``
  for k = 3, 5 and ``cv2.erode``/``cv2.dilate`` with a 2x2 kernel, as the
  line generator's augmentation calls them;
- ``pil_gray``: Pillow's ``convert("L")`` of RGB(A) pixels, the fixed-point
  luma (19595 R + 38470 G + 7471 B + 0x8000) >> 16.

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


def rotate_bilinear(img: np.ndarray, angle: float, fill: int) -> np.ndarray:
    """u8 [H, W] rotated counter-clockwise by ``angle`` degrees about its
    centre, as Pillow's ``Image.rotate(angle, resample=BILINEAR,
    expand=False, fillcolor=fill)`` computes it.

    Pillow builds the inverse affine matrix in float64 with cos and sin
    rounded to 15 decimals, samples at output pixel centres (+0.5), gives
    the fill to every output pixel whose source point lies outside
    [0, W) x [0, H), interpolates the rest with the source edges clamped
    (a missing lower row is left out) and truncates the result.
    """
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape
    angle = angle % 360.0
    if angle == 0:
        return img.copy()
    if angle == 180:
        return np.ascontiguousarray(img[::-1, ::-1])
    if angle in (90, 270) and w == h:
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else -1))
    cx, cy = w / 2, h / 2
    a = -math.radians(angle)
    m = [round(math.cos(a), 15), round(math.sin(a), 15), 0.0,
         round(-math.sin(a), 15), round(math.cos(a), 15), 0.0]
    m[2] = m[0] * -cx + m[1] * -cy + m[2] + cx
    m[5] = m[3] * -cx + m[4] * -cy + m[5] + cy
    xo = np.arange(w, dtype=np.float64)[None] + 0.5
    yo = np.arange(h, dtype=np.float64)[:, None] + 0.5
    xin = m[0] * xo + m[1] * yo + m[2]
    yin = m[3] * xo + m[4] * yo + m[5]
    inside = (xin >= 0.0) & (xin < w) & (yin >= 0.0) & (yin < h)
    xin, yin = xin - 0.5, yin - 0.5
    x, y = np.floor(xin), np.floor(yin)
    dx, dy = xin - x, yin - y
    x, y = x.astype(np.int64), y.astype(np.int64)
    x0, x1 = np.clip(x, 0, w - 1), np.clip(x + 1, 0, w - 1)
    f = img.astype(np.float64)
    yc, y2 = np.clip(y, 0, h - 1), np.clip(y + 1, 0, h - 1)
    p0, p1 = f[yc, x0], f[yc, x1]
    q0, q1 = f[y2, x0], f[y2, x1]
    v1 = p0 + (p1 - p0) * dx
    v2 = q0 + (q1 - q0) * dx
    v = np.where((y + 1 >= 0) & (y + 1 < h), v1 + (v2 - v1) * dy, v1)
    return np.where(inside, np.trunc(v), fill).astype(np.uint8)


_PIL_BITS = 22               # Resample.c's PRECISION_BITS for 8-bit images


def pil_gray(rgb: np.ndarray) -> np.ndarray:
    """u8 [H, W, 3|4] RGB(A) -> u8 [H, W] as Pillow's ``convert("L")``;
    alpha is ignored."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


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


#: Columns per block of OpenCV's vectorised linear warp (two AVX2 vectors
#: of eight float32 lanes); the columns past the last block take its
#: scalar code, whose positions round differently.
_WARP_BLOCK = 16
_A = _f32(-0.75)
_ONE = _f32(1)


def _fma32(a, b, c) -> np.ndarray:
    """float32 fused multiply-add, rounded once: the product of two float32
    values is exact in float64, and the one case where rounding the float64
    sum to float32 rounds twice (a sum exactly halfway between two float32
    values that is itself rounded) is resolved by the sum's exact error."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.astype(_f32)
    r64 = r.astype(np.float64)
    toward = np.where(s > r64, np.inf, -np.inf).astype(_f32)
    nb = np.nextafter(r, toward)
    tie = (s != r64) & (s == (r64 + nb.astype(np.float64)) * 0.5) & (err != 0)
    if tie.any():
        up = (err > 0) == (nb > r)
        r = np.where(tie & up, nb, r)
    return r


def _src_positions(m: np.ndarray, ow: int, oh: int, interp: str):
    """float32 source positions of the output pixels. Linear: in blocks of
    16 columns ``fma(x, M0, (y * M1 + M2))``, the remaining columns
    ``fma(x, M0, y * M1) + M2``; cubic: ``x * M0 + (y * M1 + M2)``."""
    mf = np.asarray(m, np.float64).astype(_f32).ravel()
    x = np.broadcast_to(np.arange(ow, dtype=_f32)[None], (oh, ow))
    y = np.broadcast_to(np.arange(oh, dtype=_f32)[:, None], (oh, ow))
    out = []
    for r in (0, 3):
        if interp == "cubic":
            out.append(x * mf[r] + (y * mf[r + 1] + mf[r + 2]))
            continue
        v = _fma32(x, mf[r], y * mf[r + 1] + mf[r + 2])
        nv = ow // _WARP_BLOCK * _WARP_BLOCK
        if nv < ow:
            t = _fma32(x[:, nv:], mf[r], y[:, nv:] * mf[r + 1]) + mf[r + 2]
            v[:, nv:] = t
        out.append(v.astype(_f32))
    return out


def _cubic_weights(t: np.ndarray):
    """The four float32 cubic weights (A = -0.75) of fraction ``t``."""
    tm = _ONE - t
    t2 = t * t
    w0 = _A * (t * (tm * tm))
    w1 = _fma32(_fma32(_A + _f32(2), t, -(_A + _f32(3))), t2, _ONE)
    w3 = _A * (t2 * tm)
    w2 = ((_ONE - w0) - w1) - w3
    return w0, w1, w2, w3


def warp_affine(src: np.ndarray, m: np.ndarray, size, interp: str,
                fill: int) -> np.ndarray:
    """u8 [H, W] -> u8 [size[1], size[0]] as OpenCV 5.0's
    ``cv2.warpAffine(src, m, size, flags=INTER_LINEAR | INTER_CUBIC |
    WARP_INVERSE_MAP, borderMode=BORDER_CONSTANT, borderValue=fill)``
    computes it without IPP: output pixel (x, y) samples source point ``m @
    (x, y, 1)``.

    Both interpolate in float32 at the exact source position (see
    ``_src_positions``); a tap outside the image reads ``fill``, and the
    result is rounded half to even and saturated.

    - linear: ``v0 = fma(a, p01 - p00, p00)``, the same for the lower row,
      then ``fma(b, v1 - v0, v0)``;
    - cubic: the weights of ``_cubic_weights`` for each axis, each row a
      chain ``fma(p3, w3, fma(p2, w2, fma(p1, w1, p0 * w0)))`` and the rows
      combined by the same chain over the vertical weights.
    """
    if interp not in ("linear", "cubic"):
        raise ValueError(f"interp must be linear or cubic: {interp!r}")
    src = np.ascontiguousarray(src, np.uint8)
    h, w = src.shape
    ow, oh = int(size[0]), int(size[1])
    sx, sy = _src_positions(m, ow, oh, interp)
    ix, iy = np.floor(sx), np.floor(sy)
    a, b = (sx - ix).astype(_f32), (sy - iy).astype(_f32)
    # Positions far outside only ever read the fill; clamping them keeps
    # the integer taps small.
    ix = np.clip(ix, -4, w + 4).astype(np.int64)
    iy = np.clip(iy, -4, h + 4).astype(np.int64)
    pad = 8
    padded = np.full((h + 2 * pad, w + 2 * pad), fill, _f32)
    padded[pad:pad + h, pad:pad + w] = src

    def tap(dy: int, dx: int) -> np.ndarray:
        return padded[iy + pad + dy, ix + pad + dx]

    if interp == "linear":
        v0 = _fma32(a, tap(0, 1) - tap(0, 0), tap(0, 0))
        v1 = _fma32(a, tap(1, 1) - tap(1, 0), tap(1, 0))
        v = _fma32(b, v1 - v0, v0)
    else:
        wx, wy = _cubic_weights(a), _cubic_weights(b)
        rows = []
        for i in range(4):
            r = tap(i - 1, -1) * wx[0]
            for j in range(1, 4):
                r = _fma32(tap(i - 1, j - 1), wx[j], r)
            rows.append(r)
        v = rows[0] * wy[0]
        for i in range(1, 4):
            v = _fma32(rows[i], wy[i], v)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)
