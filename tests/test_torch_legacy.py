"""The port's classic-CV detector (kiri_tpu_torch/detect/legacy.py) against
kiri_tpu's on the CPU, cv2 with IPP off:

- live, on the six hard documents of tests/test_legacy_hard_docs.py, the
  small smoke pages and a colour page: the candidate masks, the components
  (same order), lines, words, blocks, characters, the ``detect_all``
  hierarchy and the debug images are identical, also with each of
  ``use_mser``, ``use_gradient`` and ``use_color_channels`` off;
- on a page over 1600 px (scaled down by both);
- the port's line grouping and word split against line-for-line copies of
  kiri_tpu's, on random components with many ties.

The stored answers of all thirteen fixture pages are held in
tests/test_torch_legacy_stored.py."""
from __future__ import annotations

import json
from typing import List

import cv2
import numpy as np
import pytest
from torch_legacy_pages import hard_docs, large_page

from kiri_tpu.detect.legacy import ImageProcessingTextDetector as JDet
from kiri_tpu_torch.detect.legacy import ImageProcessingTextDetector as TDet
from kiri_tpu_torch.smoke import load_smoke_pages


@pytest.fixture(scope="module", autouse=True)
def cv2_without_ipp():
    before = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(before)


@pytest.fixture(scope="module")
def smoke():
    return load_smoke_pages()


def tree(boxes) -> list:
    return [[list(b.bbox), b.level.value, tree(b.children)] for b in boxes]


def _gray_color(img):
    if img.ndim == 3:
        return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY), img
    return img, None


def _live_pages(smoke):
    pages = list(hard_docs().items())
    pages += [(f"page{i}", smoke["pages"][i]["image"]) for i in (0, 3, 4)]
    pages.append(("color", smoke["legacy"]["color_page"]))
    return pages


LIVE = ["normal", "inverted", "low_contrast", "colored", "textured",
        "two_polarities", "page0", "page3", "page4", "color"]


@pytest.mark.parametrize("name", LIVE)
def test_every_level_matches_kiri_tpu(smoke, name):
    img = dict(_live_pages(smoke))[name]
    j, t = JDet(), TDet()
    gray, color = _gray_color(img)
    want = j._binary_candidates(gray, color)
    got = t._binary_candidates(gray, color)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        assert np.array_equal(a, b), n
    assert np.array_equal(t._components(gray, color),
                          j._components(gray, color))
    for level in ("detect_lines", "detect_words", "detect_blocks",
                  "detect_characters"):
        assert getattr(t, level)(img) == getattr(j, level)(img), level
    assert tree(t.detect_all(img)) == tree(j.detect_all(img))
    assert t.is_multiline(img) == j.is_multiline(img)
    dj, dt = j.get_debug_images(), t.get_debug_images()
    assert sorted(dt) == sorted(dj)
    for k in dj:
        assert np.array_equal(dt[k], dj[k]), k


@pytest.mark.parametrize("off", ["use_mser", "use_gradient",
                                 "use_color_channels"])
def test_sources_switched_off_match_kiri_tpu(smoke, off):
    pages = dict(_live_pages(smoke))
    for name in ("colored", "textured", "two_polarities", "page3", "color"):
        img = pages[name]
        j, t = JDet(**{off: False}), TDet(**{off: False})
        gray, color = _gray_color(img)
        assert len(t._binary_candidates(gray, color)) == len(
            j._binary_candidates(gray, color))
        assert np.array_equal(t._components(gray, color),
                              j._components(gray, color)), name
        assert t.detect_lines(img) == j.detect_lines(img), name
        assert t.detect_words(img) == j.detect_words(img), name


def test_page_over_1600_px_matches_kiri_tpu():
    img = large_page()
    assert max(img.shape[:2]) > 1600
    j, t = JDet(), TDet()
    gray, color = _gray_color(img)
    comps = t._components(gray, color)
    assert np.array_equal(comps, j._components(gray, color))
    lines = t._group_into_lines(comps)
    want = j._group_into_lines(comps)
    assert len(lines) == len(want)
    for a, b in zip(lines, want):
        assert np.array_equal(a, b)
    assert t.detect_lines(img) == j.detect_lines(img)


def _group_reference(comps: np.ndarray, ratio: float) -> List[np.ndarray]:
    """kiri_tpu/detect/legacy.py:433-457, line for line."""
    if len(comps) == 0:
        return []
    order = np.argsort(comps[:, 1] + comps[:, 3] / 2)
    comps = comps[order]
    lines: List[List[np.ndarray]] = []
    for c in comps:
        placed = False
        for line in lines:
            arr = np.array(line)
            ly1 = np.median(arr[:, 1])
            ly2 = np.median(arr[:, 1] + arr[:, 3])
            lh = max(1.0, ly2 - ly1)
            ov = min(ly2, c[1] + c[3]) - max(ly1, c[1])
            if ov > ratio * min(lh, c[3]):
                line.append(c)
                placed = True
                break
        if not placed:
            lines.append([c])
    out = [np.array(ln) for ln in lines]
    out.sort(key=lambda ln: float(np.median(ln[:, 1])))
    return out


def _words_reference(line_comps: np.ndarray, ratio: float) -> List[tuple]:
    """kiri_tpu/detect/legacy.py:476-499, line for line (as bboxes)."""
    order = np.argsort(line_comps[:, 0])
    cs = line_comps[order]
    med_h = float(np.median(cs[:, 3]))
    gap_thr = max(2.0, ratio * med_h * 0.5)
    words = [[cs[0]]]
    for c in cs[1:]:
        prev = np.array(words[-1])
        right = (prev[:, 0] + prev[:, 2]).max()
        if c[0] - right > gap_thr:
            words.append([c])
        else:
            words[-1].append(c)
    out = []
    for wgroup in words:
        arr = np.array(wgroup)
        x1, y1 = int(arr[:, 0].min()), int(arr[:, 1].min())
        x2 = int((arr[:, 0] + arr[:, 2]).max())
        y2 = int((arr[:, 1] + arr[:, 3]).max())
        out.append((x1, y1, x2 - x1, y2 - y1))
    return out


def _random_components(seed: int) -> np.ndarray:
    """Glyph-like boxes on text lines, with jitter, noise boxes and many
    equal centres and heights (ties for the unstable sorts)."""
    rng = np.random.default_rng(seed)
    n_lines = int(rng.integers(1, 40))
    rows = []
    for k in range(n_lines):
        base = int(rng.integers(0, 2000))
        height = int(rng.integers(4, 40))
        for _ in range(int(rng.integers(1, 60))):
            h = max(1, height + int(rng.integers(-3, 4)))
            rows.append((int(rng.integers(0, 1500)),
                         base + int(rng.integers(-4, 5)),
                         int(rng.integers(1, 30)), h))
    for _ in range(int(rng.integers(0, 100))):
        rows.append(tuple(int(v) for v in rng.integers(1, 600, 4)))
    return np.asarray(rows, np.int32)


@pytest.mark.parametrize("seed", range(8))
def test_line_grouping_and_word_split_match_the_reference(seed):
    comps = _random_components(seed)
    t = TDet(line_overlap_ratio=[0.5, 0.3, 0.7][seed % 3])
    got = t._group_into_lines(comps)
    want = _group_reference(comps, t.line_overlap_ratio)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for line in got:
        assert ([w.bbox for w in t._split_line_to_words(line)]
                == _words_reference(line, t.word_gap_ratio))
    j = JDet(line_overlap_ratio=t.line_overlap_ratio)
    for a, b in zip(got, j._group_into_lines(comps)):
        assert np.array_equal(a, b)
    assert t._group_into_lines(comps[:0]) == []


def test_path_and_array_give_the_same_boxes(smoke, tmp_path):
    img = smoke["legacy"]["color_page"]
    path = tmp_path / "color.png"
    cv2.imwrite(str(path), img)
    t = TDet()
    assert t.detect_words(str(path)) == t.detect_words(img)
    assert t.detect_lines(str(tmp_path / "missing.png")) == []
    assert json.loads(json.dumps(tree(t.detect_all(str(path))))) == \
        smoke["legacy"]["all"][12]
