"""The classic-CV detector's image operations (kiri_tpu_torch/ops/cvops.py,
kiri_tpu_torch/native/cvops.cpp) give cv2 5.0.0's exact arrays, with
cv2's IPP on and off: CLAHE, Otsu and fixed thresholds, the four adaptive
thresholds, BGR->HSV and BGR->LAB over every colour, the morphological
gradient, Sobel, Canny, dilate, connected components (label order and
stats, no cap), the external contours' rectangles in order, MSER (regions,
their order, each region's pixel order, areas and hull areas) and the
colour resize."""
from __future__ import annotations

import cv2
import numpy as np
import pytest

from kiri_tpu_torch.ops import cvops
from kiri_tpu_torch.ops.imgproc import resize_u8
from torch_legacy_pages import hard_docs, large_page, smoke_page_images

IPP = [pytest.param(False, id="ipp_off"), pytest.param(True, id="ipp_on")]


@pytest.fixture
def ipp(request):
    before = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(request.param)
    yield request.param
    cv2.ipp.setUseIPP(before)


def _gray(img):
    return img if img.ndim == 2 else cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)


def _images():
    rng = np.random.default_rng(0)
    out = [("rand300x400", (rng.random((300, 400)) * 255).astype(np.uint8)),
           ("rand301x397", (rng.random((301, 397)) * 255).astype(np.uint8)),
           ("rand64x77", (rng.random((64, 77)) * 255).astype(np.uint8)),
           ("rand17x9", (rng.random((17, 9)) * 255).astype(np.uint8))]
    out += [(k, _gray(v)) for k, v in hard_docs().items()]
    out += [(k, _gray(v)) for k, v in smoke_page_images()]
    return out


_IMAGES = None


def images():
    global _IMAGES
    if _IMAGES is None:
        _IMAGES = _images()
    return _IMAGES


@pytest.mark.parametrize("ipp", IPP, indirect=True)
def test_clahe_thresholds_and_adaptive_means(ipp):
    clahe = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
    for name, g in images():
        e = clahe.apply(g)
        assert np.array_equal(cvops.clahe(g), e), name
        t, otsu = cv2.threshold(e, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
        got_t, got = cvops.threshold_otsu(e)
        assert got_t == t and np.array_equal(got, otsu), name
        for thr in (50, 96, 160):
            assert np.array_equal(cvops.threshold(e, thr),
                                  cv2.threshold(e, thr, 255,
                                                cv2.THRESH_BINARY)[1]), name
            assert np.array_equal(cvops.threshold(e, thr, inv=True),
                                  cv2.threshold(e, thr, 255,
                                                cv2.THRESH_BINARY_INV)[1])
        for method, flag, block, c in (
                ("gaussian", cv2.ADAPTIVE_THRESH_GAUSSIAN_C, 21, 10),
                ("mean", cv2.ADAPTIVE_THRESH_MEAN_C, 15, 8),
                ("gaussian", cv2.ADAPTIVE_THRESH_GAUSSIAN_C, 51, 20),
                ("mean", cv2.ADAPTIVE_THRESH_MEAN_C, 11, 5)):
            want = cv2.adaptiveThreshold(e, 255, flag, cv2.THRESH_BINARY,
                                         block, c)
            got = cvops.adaptive_threshold(e, method, block, c)
            assert np.array_equal(got, want), (name, method, block)


def test_gaussian_kernel_is_opencvs():
    from kiri_tpu_torch.native.cvops import gaussian_kernel

    for k in range(11, 102, 2):
        want = cv2.getGaussianKernel(k, 0, ktype=cv2.CV_32F).ravel()
        assert np.array_equal(gaussian_kernel(k), want), k


@pytest.mark.parametrize("ipp", IPP, indirect=True)
def test_hsv_and_lab_over_every_colour(ipp):
    cube = np.arange(1 << 24, dtype=np.uint32)
    img = np.stack([(cube >> 16) & 255, (cube >> 8) & 255, cube & 255],
                   -1).astype(np.uint8).reshape(4096, 4096, 3)
    del cube
    assert np.array_equal(cvops.bgr_to_hsv(img),
                          cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    assert np.array_equal(cvops.bgr_to_lab(img),
                          cv2.cvtColor(img, cv2.COLOR_BGR2LAB))


@pytest.mark.parametrize("ipp", IPP, indirect=True)
def test_gradient_sobel_canny_dilate_and_contours(ipp):
    cross = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (3, 3))
    assert np.array_equal(cross, [[0, 1, 0], [1, 1, 1], [0, 1, 0]])
    rect = cv2.getStructuringElement(cv2.MORPH_RECT, (3, 1))
    for name, g in images():
        assert np.array_equal(cvops.morph_gradient_cross(g),
                              cv2.morphologyEx(g, cv2.MORPH_GRADIENT, cross))
        for dx, dy in ((1, 0), (0, 1)):
            assert np.array_equal(cvops.sobel3(g, dx, dy),
                                  cv2.Sobel(g, cv2.CV_64F, dx, dy, ksize=3))
        edges = cv2.Canny(g, 50, 150)
        assert np.array_equal(cvops.canny(g, 50, 150), edges), name
        dil = cv2.dilate(edges, rect, iterations=2)
        assert np.array_equal(cvops.dilate_rect(edges, 3, 1, 2), dil), name
        contours, _ = cv2.findContours(dil, cv2.RETR_EXTERNAL,
                                       cv2.CHAIN_APPROX_SIMPLE)
        want = np.array([cv2.boundingRect(c) for c in contours],
                        np.int32).reshape(-1, 4)
        assert np.array_equal(cvops.external_contour_rects(dil), want), name


def test_external_contours_of_nested_and_random_masks():
    rng = np.random.default_rng(3)
    masks = []
    ring = np.zeros((40, 40), np.uint8)
    cv2.rectangle(ring, (5, 5), (30, 30), 255, 2)
    cv2.rectangle(ring, (10, 10), (25, 25), 255, 1)
    ring[15:18, 15:18] = 255
    ring[35:38, 2:5] = 255
    masks.append(ring)
    for t in range(200):
        h, w = rng.integers(3, 60, 2)
        m = (rng.random((h, w)) < rng.uniform(0.2, 0.7)).astype(np.uint8)
        if t % 3 == 0:
            m = cv2.dilate(m, np.ones((3, 3), np.uint8))
        masks.append(255 - m * 255 if t % 5 == 0 else m * 255)
    for m in masks:
        contours, _ = cv2.findContours(m, cv2.RETR_EXTERNAL,
                                       cv2.CHAIN_APPROX_SIMPLE)
        want = np.array([cv2.boundingRect(c) for c in contours],
                        np.int32).reshape(-1, 4)
        assert np.array_equal(cvops.external_contour_rects(m), want)


@pytest.mark.parametrize("ipp", IPP, indirect=True)
def test_connected_components_order_stats_and_no_cap(ipp):
    rng = np.random.default_rng(1)
    masks = [(rng.random((64, 64)) < 0.4).astype(np.uint8) * 255,
             (rng.random((641, 639)) < 0.45).astype(np.uint8),
             (rng.random((1200, 1600)) < 0.5).astype(np.uint8) * 255,
             np.zeros((5, 7), np.uint8), np.ones((5, 7), np.uint8)]
    masks += [cv2.adaptiveThreshold(g, 255, cv2.ADAPTIVE_THRESH_MEAN_C,
                                    cv2.THRESH_BINARY, 11, 5)
              for _, g in images()[4:8]]
    most = 0
    for m in masks:
        n, labels, stats, _ = cv2.connectedComponentsWithStats(
            m, connectivity=8)
        got_n, got_labels, got_stats = \
            cvops.connected_components_with_stats(m)
        assert got_n == n
        assert np.array_equal(got_labels, labels)
        assert np.array_equal(got_stats, stats)
        most = max(most, n)
    assert most > 4096


def _mser_cv2():
    return cv2.MSER_create(delta=5, min_area=30, max_area=14400,
                           max_variation=0.25, min_diversity=0.2,
                           max_evolution=200, area_threshold=1.01,
                           min_margin=0.003, edge_blur_size=5)


def _mser_images():
    rng = np.random.default_rng(0)
    out = []
    for s in range(6):
        img = np.full((60 + s * 10, 80 + s * 7), 200, np.uint8)
        cv2.putText(img, f"Hi ok {s}", (2, 40), cv2.FONT_HERSHEY_SIMPLEX, 1.0,
                    30, 2)
        out.append(cv2.add(img, (rng.random(img.shape) * (20 + 10 * s))
                           .astype(np.uint8)))
    blurred = np.full((40, 50), 200, np.uint8)
    blurred[5:25, 5:20] = 50
    out.append(cv2.GaussianBlur(blurred, (0, 0), 2))
    flat = np.full((30, 40), 200, np.uint8)
    flat[5:20, 5:15] = 50
    out.append(flat)
    out += [_gray(v) for v in hard_docs().values()]
    return out


@pytest.mark.parametrize("which", ["small", "pages"])
def test_mser_regions_points_and_areas(which):
    mser = _mser_cv2()
    imgs = (_mser_images() if which == "small"
            else [g for _, g in images()[10:]])
    total = 0
    for g in imgs:
        for src in (g, 255 - g):
            regions, _ = mser.detectRegions(src)
            got = cvops.mser(src, 5, 30, 14400, 0.25, 0.2, points=True)
            assert len(got.points) == len(regions)
            for i, region in enumerate(regions):
                assert np.array_equal(got.points[i], region)
                assert tuple(got.rects[i]) == cv2.boundingRect(region)
                pts = region.reshape(-1, 1, 2)
                assert got.area[i] == cv2.contourArea(pts)
                assert got.hull_area[i] == cv2.contourArea(
                    cv2.convexHull(pts))
            total += len(regions)
    assert total > 20


def test_min_diversity_drops_regions_below_it():
    """OpenCV 5.0 keeps a grey region only when its variation reaches
    min_diversity: a flat square (variation 0) is found with 0 and not
    with 0.2."""
    flat = np.full((30, 40), 200, np.uint8)
    flat[5:20, 5:15] = 50
    for md in (0.0, 1e-6, 0.2):
        want = cv2.MSER_create(delta=5, min_area=30, max_area=14400,
                               max_variation=0.25,
                               min_diversity=md).detectRegions(flat)[0]
        got = cvops.mser(flat, 5, 30, 14400, 0.25, md)
        assert [len(r) for r in want] == list(got.sizes)
    assert len(cvops.mser(flat, 5, 30, 14400, 0.25, 0.0).sizes) == 4


@pytest.mark.parametrize("ipp", IPP, indirect=True)
def test_colour_resize(ipp):
    big = large_page()
    h, w = big.shape[:2]
    s = 1600 / max(h, w)
    size = (int(w * s), int(h * s))
    for img in (big, _gray(big)):
        want = cv2.resize(img, size)
        assert np.array_equal(resize_u8(img, *size), want)
