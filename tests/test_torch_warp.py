"""kiri_tpu_torch's two page warps against the libraries the JAX package
calls, on seeded u8 images (odd and even sizes, fill levels 0-255):

- ``rotate_bilinear`` against Pillow's ``Image.rotate(angle, BILINEAR,
  expand=False, fillcolor=fill)`` at angles of +-0.3 to +-8 degrees (the
  deskew range), arbitrary angles and the quarter turns;
- ``warp_affine`` against ``cv2.warpAffine(..., WARP_INVERSE_MAP,
  BORDER_CONSTANT)`` with IPP off, ``INTER_LINEAR`` and ``INTER_CUBIC``, on
  the matrices ``extract_crop_single_resample`` builds (boxes reaching past
  the page edges, so the border pixels mix in the fill) and on arbitrary
  matrices that also sample far outside the image.

Tolerance: 0 differing pixels. ``_fma32`` (the float32 fused multiply-add
the warps are written in) is held to the exactly rounded result.
"""
from __future__ import annotations

from fractions import Fraction

import cv2
import numpy as np
import pytest
from PIL import Image

from kiri_tpu.detect.deskew import \
    extract_crop_single_resample as j_extract
from kiri_tpu_torch.detect.deskew import extract_crop_single_resample
from kiri_tpu_torch.ops.imgproc import _fma32, rotate_bilinear, warp_affine

_FLAGS = {"linear": cv2.INTER_LINEAR, "cubic": cv2.INTER_CUBIC}


@pytest.fixture(scope="module", autouse=True)
def cv2_without_ipp():
    before = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(before)


def _image(rng, h: int, w: int, kind: int) -> np.ndarray:
    """Noise, a page-like light background with dark strokes, or a sparse
    binary image."""
    if kind == 0:
        return rng.integers(0, 256, (h, w)).astype(np.uint8)
    if kind == 1:
        img = np.clip(rng.normal(225, 12, (h, w)), 0, 255)
        img[rng.random((h, w)) < 0.08] = rng.integers(0, 60)
        return img.astype(np.uint8)
    return np.where(rng.random((h, w)) < 0.1, 20, 230).astype(np.uint8)


def _cv2_warp(img, m, size, interp, fill):
    return cv2.warpAffine(img, m, size,
                          flags=_FLAGS[interp] | cv2.WARP_INVERSE_MAP,
                          borderMode=cv2.BORDER_CONSTANT, borderValue=fill)


@pytest.mark.parametrize("seed", range(6))
def test_rotate_bilinear_matches_pillow(seed):
    rng = np.random.default_rng(seed)
    for t in range(12):
        h, w = (int(v) for v in rng.integers(3, 140, 2))
        img = _image(rng, h, w, t % 3)
        fill = int(rng.integers(0, 256))
        angles = [float(rng.uniform(0.3, 8.0) * rng.choice([-1, 1])),
                  float(rng.uniform(-360, 360))]
        if t == 0:
            angles += [0.0, 90.0, 180.0, 270.0, -90.0, 360.0]
        for angle in angles:
            want = np.asarray(Image.fromarray(img).rotate(
                angle, resample=Image.BILINEAR, expand=False,
                fillcolor=fill))
            got = rotate_bilinear(img, angle, fill)
            assert got.shape == want.shape
            assert int((got != want).sum()) == 0, (h, w, angle, fill)


def test_rotate_bilinear_quarter_turn_of_a_square_page():
    img = _image(np.random.default_rng(7), 33, 33, 0)
    for angle in (90.0, 270.0):
        want = np.asarray(Image.fromarray(img).rotate(
            angle, resample=Image.BILINEAR, expand=False, fillcolor=5))
        np.testing.assert_array_equal(rotate_bilinear(img, angle, 5), want)


@pytest.mark.parametrize("interp", ["linear", "cubic"])
@pytest.mark.parametrize("seed", range(4))
def test_warp_affine_matches_cv2_on_deskew_crops(interp, seed):
    """The crop warps of both packages' ``extract_crop_single_resample``
    (boxes in and around the page, heights 32 and 48, scales above and
    below 1), and ``warp_affine`` itself against cv2."""
    rng = np.random.default_rng(100 + seed)
    for t in range(10):
        h, w = (int(v) for v in rng.integers(41, 400, 2))
        img = _image(rng, h, w, t % 3)
        angle = float(rng.uniform(0.3, 8.0) * rng.choice([-1, 1]))
        bw, bh = int(rng.integers(4, w)), int(rng.integers(4, min(h, 70)))
        box = (int(rng.integers(-8, w - bw + 8)),
               int(rng.integers(-8, h - bh + 8)), bw, bh)
        out_h = int(rng.choice([32, 48]))
        fill = int(rng.integers(0, 256))
        want = j_extract(img, angle, box, out_h, fill=fill, min_scale=0.0,
                         interp=_FLAGS[interp])
        got = extract_crop_single_resample(img, angle, box, out_h, fill=fill,
                                           min_scale=0.0, interp=interp)
        assert got.shape == want.shape
        assert int((got != want).sum()) == 0, (h, w, angle, box, fill)


@pytest.mark.parametrize("interp", ["linear", "cubic"])
@pytest.mark.parametrize("seed", range(3))
def test_warp_affine_matches_cv2_on_any_matrix(interp, seed):
    """Scales, shears and translations that read inside, across the edges
    of and far outside the image; output widths that fill whole blocks of
    16 columns, part of one, or none."""
    rng = np.random.default_rng(200 + seed)
    for t in range(12):
        h, w = (int(v) for v in rng.integers(2, 160, 2))
        img = _image(rng, h, w, t % 3)
        m = np.array([[rng.uniform(-2, 2), rng.uniform(-2, 2),
                       rng.uniform(-40, w + 40)],
                      [rng.uniform(-2, 2), rng.uniform(-2, 2),
                       rng.uniform(-40, h + 40)]])
        size = (int(rng.choice([1, 7, 16, 33, int(rng.integers(1, 200))])),
                int(rng.integers(1, 120)))
        fill = int(rng.integers(0, 256))
        got = warp_affine(img, m, size, interp, fill)
        want = _cv2_warp(img, m, size, interp, fill)
        assert int((got != want).sum()) == 0, (h, w, m.tolist(), size)


def test_warp_affine_refuses_other_interpolations():
    with pytest.raises(ValueError, match="linear or cubic"):
        warp_affine(np.zeros((4, 4), np.uint8), np.eye(2, 3), (4, 4),
                    "area", 0)


def test_fma32_rounds_once():
    """Against the exactly rounded float32 of a * b + c, on random values
    and on sums placed exactly halfway between two float32 values after
    float64 rounding, where a float64 sum rounds twice."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    a = rng.uniform(-300, 300, 4000).astype(f32)
    b = rng.uniform(-2, 2, 4000).astype(f32)
    c = rng.uniform(-300, 300, 4000).astype(f32)
    # Halfway cases: a * b = 2^-24 - 2^-70 and c = 1 + 2^-23. The float64
    # sum drops the 2^-70 and lands halfway between c and its upper
    # neighbour, where ties-to-even rounds up; the exact sum rounds to c.
    one_up = 1.0 + 2.0 ** -23
    tie_a = np.array([one_up, -one_up], f32)
    tie_b = np.array([2.0 ** -24 - 2.0 ** -47] * 2, f32)
    tie_c = np.array([one_up, -one_up], f32)
    a = np.concatenate([a, tie_a])
    b = np.concatenate([b, tie_b])
    c = np.concatenate([c, tie_c])
    got = _fma32(a, b, c)

    def exact(x, y, z) -> f32:
        v = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = f32(float(v))
        if Fraction(float(lo)) == v:
            return lo
        hi = np.nextafter(lo, f32(np.inf) if Fraction(float(lo)) < v
                          else f32(-np.inf))
        dl = abs(Fraction(float(lo)) - v)
        dh = abs(Fraction(float(hi)) - v)
        if dl != dh:
            return lo if dl < dh else hi
        return lo if int(lo.view(np.int32)) % 2 == 0 else hi

    want = np.array([exact(x, y, z) for x, y, z in zip(a, b, c)], f32)
    np.testing.assert_array_equal(got, want)
    naive = (a.astype(np.float64) * b + c).astype(f32)
    # The cases a float64 sum gets wrong.
    assert (naive[-2:] != want[-2:]).all()
