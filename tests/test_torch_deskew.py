"""kiri_tpu_torch's deskew (``detect/deskew.py``) against kiri_tpu's on the
CPU, on seeded docsynth pages: upright, "rotated" (2-6 degrees), rotated
and inverted, rotated and sparse (three lines), rotated and noisy.

Tolerance: none. ``estimate_skew`` gives the same float, ``rotate_image``
and ``extract_crop_single_resample`` the same bytes (cv2 with IPP off),
``boxes_to_original`` the same boxes.
"""
from __future__ import annotations

import random

import cv2
import numpy as np
import pytest

from kiri_tpu.data.docsynth import DocumentGenerator, apply_condition
from kiri_tpu.detect import deskew as jdeskew
from kiri_tpu_torch.detect import deskew


@pytest.fixture(scope="module", autouse=True)
def cv2_without_ipp():
    before = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(before)


def _page(seed: int, kind: str, size=(480, 400)) -> np.ndarray:
    w, h = size
    doc = DocumentGenerator(w, h, seed=seed, khmer_ratio=0.4).generate(
        "single_column")
    rng = random.Random(seed)
    if kind == "upright":
        return np.asarray(doc["image"], np.uint8)
    if kind == "sparse":
        img = np.asarray(doc["image"], np.uint8).copy()
        keep = np.zeros(img.shape[0], bool)
        for (_, y, _, bh) in doc["lines"][:3]:
            keep[max(0, y - 2): y + bh + 2] = True
        img[~keep] = int(np.median(img))
        doc = dict(doc, image=img, lines=doc["lines"][:3],
                   texts=doc["texts"][:3])
    doc = apply_condition(doc, "rotated", rng)
    if kind == "inverted":
        doc = apply_condition(doc, "inverted", rng)
    if kind == "noisy":
        doc = apply_condition(doc, "noisy", rng)
    return np.asarray(doc["image"], np.uint8)


KINDS = ("upright", "rotated", "inverted", "sparse", "noisy")


@pytest.fixture(scope="module")
def pages():
    return {(k, s): _page(1000 + 17 * s + i, k)
            for i, k in enumerate(KINDS) for s in range(2)}


@pytest.mark.parametrize("kind", KINDS)
def test_estimate_skew_gives_the_same_float(pages, kind):
    for s in range(2):
        img = pages[(kind, s)]
        want = jdeskew.estimate_skew(img)
        got = deskew.estimate_skew(img)
        assert got == want and type(got) is float
        if kind in ("rotated", "inverted", "noisy"):
            assert abs(got) >= 1.0          # the rotation was found
        xs, ys = deskew._ink_coords(img)
        jxs, jys = jdeskew._ink_coords(img)
        np.testing.assert_array_equal(xs, jxs)
        np.testing.assert_array_equal(ys, jys)
    # A colour page goes through the channel mean, as in kiri_tpu.
    bgr = np.stack([img, img // 2 + 100, 255 - img], -1)
    assert deskew.estimate_skew(bgr) == jdeskew.estimate_skew(bgr)


def test_estimate_skew_on_a_blank_page():
    blank = np.full((200, 300), 240, np.uint8)
    assert deskew.estimate_skew(blank) == jdeskew.estimate_skew(blank) == 0.0


@pytest.mark.parametrize("kind", ("rotated", "noisy"))
def test_rotate_image_is_pillows(pages, kind):
    img = pages[(kind, 0)]
    angle = deskew.estimate_skew(img)
    for a in (-angle, angle, 0.0, 1e-7):
        np.testing.assert_array_equal(deskew.rotate_image(img, a),
                                      jdeskew.rotate_image(img, a))


def test_boxes_to_original():
    rng = np.random.default_rng(3)
    for shape in ((640, 640), (481, 377)):
        boxes = [tuple(int(v) for v in (rng.integers(-20, shape[1]),
                                        rng.integers(-20, shape[0]),
                                        rng.integers(0, 300),
                                        rng.integers(0, 60)))
                 for _ in range(50)]
        for angle in (-5.7, -1.0, 0.0, 2.35, 8.0):
            assert deskew.boxes_to_original(boxes, angle, shape) == \
                jdeskew.boxes_to_original(boxes, angle, shape)


def test_extract_crop_single_resample_guards():
    img = np.full((100, 120), 200, np.uint8)
    for box, out_h, kw in (((200, 10, 20, 10), 48, {}),     # off the page
                           ((10, 10, 0, -20), 48, {}),      # empty
                           ((0, 0, 100, 90), 48, {}),       # 48/100 < 0.75
                           # 48/55 below min_scale
                           ((0, 0, 100, 50), 48, {"min_scale": 0.9})):
        assert deskew.extract_crop_single_resample(
            img, 3.0, box, out_h, **kw) is None
        assert jdeskew.extract_crop_single_resample(
            img, 3.0, box, out_h, **kw) is None


@pytest.mark.parametrize("kind", ("rotated", "sparse", "noisy"))
def test_single_resample_crops_byte_for_byte(pages, kind):
    """Seeded boxes of the upright frame at heights 48 and 32: cubic when
    the crop is scaled up, linear when it is scaled down, the fill the page
    median; and linear warps of every box, as the noisy-page branch takes
    them."""
    img = pages[(kind, 1)]
    angle = jdeskew.estimate_skew(img)
    h, w = img.shape
    rng = np.random.default_rng(5)
    boxes = [(int(rng.integers(0, w - 60)), int(rng.integers(0, h - 40)),
              int(rng.integers(30, 400)), int(rng.integers(12, 70)))
             for _ in range(24)]
    fill = int(np.median(img))
    n_warped = 0
    for box in boxes:
        for out_h in (48, 32):
            want = jdeskew.extract_crop_single_resample(img, angle, box,
                                                        out_h, fill=fill)
            got = deskew.extract_crop_single_resample(img, angle, box, out_h,
                                                      fill=fill)
            assert (got is None) == (want is None)
            if want is not None:
                n_warped += 1
                np.testing.assert_array_equal(got, want)
        want = jdeskew.extract_crop_single_resample(
            img, angle, box, 48, fill=fill, interp=cv2.INTER_LINEAR)
        got = deskew.extract_crop_single_resample(img, angle, box, 48,
                                                  fill=fill, interp="linear")
        if want is not None:
            np.testing.assert_array_equal(got, want)
    assert n_warped > 10


@pytest.mark.parametrize("method", ["db", "craft"])
def test_text_detector_deskew_route_gives_the_stored_answers(method):
    """``TextDetector(method, deskew=True)`` over the committed rotated
    pages, single-page and batched: kiri_tpu's applied angle, boxes and
    upright boxes (stored by scripts/make_torch_smoke_pages.py), and the
    estimate on the upright pages, which it leaves alone."""
    from pathlib import Path

    from kiri_tpu_torch.detect import TextDetector
    from kiri_tpu_torch.smoke import load_smoke_pages

    fx = load_smoke_pages()
    name = {"db": "detector", "craft": "craft"}[method]
    td = TextDetector(method, str(Path(__file__).resolve().parent.parent
                                  / "models" / f"{name}.safetensors"),
                      device="cpu", deskew=True)
    rot = fx["rot_pages"]
    for p in rot:
        want = p["deskew"][method]
        got = td.detect_lines_objects(p["image"])
        assert td.last_deskew_angle == td.last_skew_angle == want["angle"]
        assert [b.bbox for b in got] == want["boxes"]
        assert [b.bbox for b in td.last_deskew_boxes] == want["twins"]
        assert td.last_deskewed_image.shape == p["image"].shape
    upright = fx["pages"][3]["image"]
    batch = td.detect_lines_objects_batch([p["image"] for p in rot]
                                          + [upright])
    for i, p in enumerate(rot):
        want = p["deskew"][method]
        assert [b.bbox for b in batch[i]] == want["boxes"]
        img, twins, angle = td.last_batch_state[i]
        assert angle == want["angle"]
        assert [b.bbox for b in twins] == want["twins"]
    assert td.last_batch_state[3] == (None, None, 0.0)
    assert abs(fx["skew_angles"][3]) < td.deskew_min_angle
    # The upright page's boxes are the undeskewed detector's.
    assert [b.bbox for b in td.detect_lines_objects(upright)] == \
        [b.bbox for b in batch[3]]
    assert td.last_deskewed_image is None and td.last_deskew_angle == 0.0
