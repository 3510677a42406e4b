"""The port's drawing and generator image operations against Pillow 12 and
cv2 on the CPU, pixel for pixel (kiri_tpu_torch/ops/draw.py and the
generators' part of kiri_tpu_torch/ops/imgproc.py):

- ellipses filled and outlined at every axis pair up to 24 (the pseudo-glyph
  font draws at most 19 x 23 at size 64) and every width it uses (1-6);
- the font's two half-ellipse arcs, its zigzag and tilde lines, triangles
  and squares exactly as it draws them at every size 10-64 and style, the
  segments of its 5 x 5 lattices at four sizes, and arcs on every multiple
  of 90 degrees;
- hypothesis cases of lines, polygons, rectangles, ellipses and the text
  compositing step (``draw_bitmap``) with masks off the image's edges;
- cv2's GaussianBlur (3, 5) with IPP on and off, erode/dilate with a 2x2
  kernel, and Pillow's bilinear resize on both axes.
"""
from __future__ import annotations

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, ImageDraw

from kiri_tpu_torch.ops import imgproc
from kiri_tpu_torch.ops.draw import Draw

SIZES = range(10, 65)
STYLES = range(4)


def _same(w: int, h: int, draw_fn) -> None:
    """``draw_fn`` on a Pillow "L" image and on the port's array alike."""
    img = Image.new("L", (w, h), 0)
    draw_fn(ImageDraw.Draw(img))
    ours = np.zeros((h, w), np.uint8)
    draw_fn(Draw(ours))
    assert np.array_equal(np.asarray(img), ours)


def _stroke(size: int, style: int) -> int:
    return max(1, round(size * (0.055 + 0.012 * style)))


def _mark_box(size: int):
    return max(4, round(0.50 * size)), max(3, round(0.30 * size))


@pytest.mark.parametrize("a", range(25))
def test_ellipses_of_every_axis_and_width(a):
    for b in range(25):
        box = [2, 3, 2 + a, 3 + b]
        _same(30, 30, lambda d: d.ellipse(box, fill=255))
        for width in range(1, 7):
            _same(30, 30, lambda d: d.ellipse(box, outline=255, width=width))


@pytest.mark.parametrize("size", SIZES)
def test_the_fonts_arcs_lines_and_shapes(size):
    w, h = _mark_box(size)
    x1, y1 = w - 1, h - 1
    cx, cy = w // 2, h // 2
    r = max(1, min(w, h) // 3)
    for style in STYLES:
        s = _stroke(size, style)
        _same(w, h, lambda d: d.arc([0, 0, x1, 2 * h], 180, 360, fill=255,
                                    width=s))
        _same(w, h, lambda d: d.arc([0, -h, x1, y1], 0, 180, fill=255,
                                    width=s))
        _same(w, h, lambda d: d.line([0, y1, w // 3, 0, 2 * w // 3, y1, x1, 0],
                                     fill=255, width=s))
        _same(w, h, lambda d: d.line([0, cy, w // 4, 0, 3 * w // 4, y1, x1,
                                      cy], fill=255, width=s))
        _same(w, h, lambda d: d.ellipse([cx - r, cy - r, cx + r, cy + r],
                                        outline=255, width=max(1, s - 1)))
    _same(w, h, lambda d: d.polygon([cx, 0, x1, y1, 0, y1], outline=255))
    _same(w, h, lambda d: d.rectangle([cx - r, cy - r, cx + r, cy + r],
                                      fill=255))


@pytest.mark.parametrize("size", [10, 24, 44, 64])
def test_lattice_segments(size):
    """Every ordered pair of the base glyph's 5 x 5 lattice at every stroke
    the styles give."""
    w, h = max(3, round(0.60 * size)), round(0.72 * size)
    lat = [(round(x * (w - 1) / 4), round(y * (h - 1) / 4))
           for y in range(5) for x in range(5)]
    for s in sorted({_stroke(size, k) for k in STYLES}):
        for p in lat:
            for q in lat:
                if p != q:
                    _same(w, h, lambda d: d.line([p, q], fill=255, width=s))


def test_arcs_on_multiples_of_90():
    for start in range(-360, 361, 90):
        for end in range(-360, 721, 90):
            for a, b in ((0, 0), (7, 3), (3, 7), (12, 12), (15, 6)):
                for width in (1, 3):
                    _same(20, 20, lambda d: d.arc([2, 2, 2 + a, 2 + b], start,
                                                  end, fill=255, width=width))
    with pytest.raises(NotImplementedError):
        Draw(np.zeros((4, 4), np.uint8)).arc([0, 0, 3, 3], 10, 100, fill=1)


coord = st.integers(-8, 40)


@settings(max_examples=300, deadline=None)
@given(st.lists(st.tuples(coord, coord), min_size=2, max_size=5),
       st.integers(0, 9), st.integers(1, 255))
def test_lines_hypothesis(pts, width, ink):
    _same(33, 29, lambda d: d.line(pts, fill=ink, width=width))


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(coord, coord), min_size=3, max_size=6))
def test_polygons_hypothesis(pts):
    _same(33, 29, lambda d: d.polygon(pts, outline=200))


@settings(max_examples=200, deadline=None)
@given(coord, coord, st.integers(0, 30), st.integers(0, 30),
       st.integers(1, 6))
def test_boxes_hypothesis(x, y, a, b, width):
    box = [x, y, x + a, y + b]
    _same(33, 29, lambda d: d.rectangle(box, fill=99))
    _same(33, 29, lambda d: d.ellipse(box, fill=99))
    _same(33, 29, lambda d: d.ellipse(box, outline=99, width=width))
    _same(33, 29, lambda d: d.arc(box, 0, 180, fill=99, width=width))


class _MaskFont:
    """A font that hands ImageDraw.text a fixed mask."""

    def __init__(self, mask):
        self.mask = mask

    def getmask(self, text, mode="", *args, **kwargs):
        return Image.fromarray(self.mask, "L").im

    def render(self, text):
        return self.mask


@settings(max_examples=300, deadline=None)
@given(st.integers(1, 20), st.integers(1, 20), st.floats(-25, 40),
       st.floats(-25, 40), st.integers(0, 255), st.integers(0, 2 ** 32 - 1))
def test_text_compositing_hypothesis(mw, mh, x, y, ink, seed):
    """ImageDraw.text's compositing: the origin truncated, the mask clipped
    and blended with DIV255 rounding over a noisy background."""
    rng = np.random.default_rng(seed)
    mask = rng.integers(0, 256, (mh, mw), dtype=np.uint8)
    bg = rng.integers(0, 256, (17, 23), dtype=np.uint8)
    img = Image.fromarray(bg.copy())
    ImageDraw.Draw(img).text((x, y), "x", fill=ink, font=_MaskFont(mask))
    ours = bg.copy()
    Draw(ours).text((x, y), "x", ink, _MaskFont(mask))
    assert np.array_equal(np.asarray(img), ours)


@pytest.mark.parametrize("ipp", [True, False])
def test_blur_and_morphology_match_cv2(ipp):
    before = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(ipp)
    try:
        rng = np.random.default_rng(0)
        for i in range(150):
            h, w = (int(v) for v in rng.integers(1, 70, 2))
            img = rng.integers(0, 256, (h, w), dtype=np.uint8)
            if i % 2:
                img = np.where(img > 128, 240, 20).astype(np.uint8)
            for k in (3, 5):
                assert np.array_equal(imgproc.gaussian_blur_u8(img, k),
                                      cv2.GaussianBlur(img, (k, k), 0))
            kernel = np.ones((2, 2), np.uint8)
            assert np.array_equal(imgproc.morph_2x2(img, "erode"),
                                  cv2.erode(img, kernel, iterations=1))
            assert np.array_equal(imgproc.morph_2x2(img, "dilate"),
                                  cv2.dilate(img, kernel, iterations=1))
    finally:
        cv2.ipp.setUseIPP(before)


def test_pil_resize_bilinear_both_axes():
    rng = np.random.default_rng(1)
    for _ in range(300):
        h, w, oh, ow = (int(v) for v in rng.integers(1, 90, 4))
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        want = np.asarray(Image.fromarray(img).resize((ow, oh),
                                                      Image.BILINEAR))
        assert np.array_equal(imgproc.pil_resize_bilinear(img, ow, oh), want)
