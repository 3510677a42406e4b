"""kiri_tpu_torch.native (its own build of geometry.cpp) output for output
against kiri_tpu.native on random and detector-like inputs, and the build:
into build/kiri_tpu_torch/ under a hash, raising when it fails."""
from __future__ import annotations

import numpy as np
import pytest

from kiri_tpu import native as J
from kiri_tpu_torch import native as T


def _blobs(seed, h=120, w=200):
    rng = np.random.default_rng(seed)
    bm = np.zeros((h, w), np.uint8)
    for _ in range(12):
        y, x = rng.integers(0, h - 10), rng.integers(0, w - 30)
        bm[y: y + rng.integers(3, 10), x: x + rng.integers(5, 30)] = 1
    return bm | (rng.random((h, w)) > 0.97)


def test_library_is_built_in_the_build_dir():
    T.get_lib()
    path = T.lib_path()
    assert path.exists() and path.parent == T.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "kiri_tpu_torch")
    assert J.get_lib() is not None


@pytest.mark.parametrize("seed", range(4))
def test_components_boundaries_and_rects_match(seed):
    bm = _blobs(seed)
    n, labels, stats = T.connected_components(bm, max_components=50)
    jn, jlabels, jstats = J.connected_components(bm, max_components=50)
    assert n == jn
    assert np.array_equal(labels, jlabels) and np.array_equal(stats, jstats)
    pred = np.random.default_rng(seed).random(bm.shape).astype(np.float32)
    for comp in range(1, n + 1):
        pts = T.component_boundary(labels, comp)
        assert np.array_equal(pts, J.component_boundary(jlabels, comp))
        if len(pts) < 3:
            continue
        rect = T.min_area_rect(pts)
        assert rect == J.min_area_rect(pts)
        quad = T.box_points(rect)
        assert np.array_equal(quad, J.box_points(rect))
        assert T.box_score(pred, quad) == J.box_score(pred, quad)
        assert T.polygon_area_perimeter(quad) == J.polygon_area_perimeter(quad)
        grown = T.offset_polygon(quad.astype(float), 3.5)
        want = J.offset_polygon(quad.astype(float), 3.5)
        assert (grown is None) == (want is None)
        if grown is not None:
            assert np.array_equal(grown, want)
        assert np.array_equal(T.convex_hull(pts), J.convex_hull(pts))
    for k in (1, 3, 5):
        assert np.array_equal(T.dilate(bm, k), J.dilate(bm, k))


def test_degenerate_inputs_match():
    for pts in (np.zeros((1, 2)), np.array([[0.0, 0], [4, 0]]),
                np.array([[1.0, 1], [1, 1], [1, 1]])):
        assert T.min_area_rect(pts) == J.min_area_rect(pts)
    flat = np.array([[0.0, 0], [5, 0], [5, 0], [0, 0]])
    assert T.polygon_area_perimeter(flat) == J.polygon_area_perimeter(flat)
    assert T.offset_polygon(flat, 0.0) is None or np.array_equal(
        T.offset_polygon(flat, 0.0), J.offset_polygon(flat, 0.0))
    n, _, stats = T.connected_components(np.zeros((5, 5), np.uint8))
    assert n == 0 and stats.shape == (0, 5)


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "geometry.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(T, "SRC", bad)
    monkeypatch.setattr(T, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(T, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for geometry.cpp"):
        T.get_lib()
    assert not list((tmp_path / "build").glob("*.so"))
