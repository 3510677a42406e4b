"""The port's classic-CV detector against kiri_tpu's answers stored in the
smoke fixture (scripts/make_torch_smoke_pages.py) on all thirteen fixture
pages (9 upright, 3 rotated, 1 colour), where kiri_tpu's own line grouping
takes up to 85 s a page: lines, words, blocks, characters and the
``detect_all`` hierarchy identical; and ``TextDetector("legacy",
deskew=True)`` on the rotated pages (angle, boxes, upright boxes)."""
from __future__ import annotations

import time
from typing import List

import cv2
import pytest
from test_torch_legacy import tree

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


def _stored(smoke, level: str, i: int) -> List[tuple]:
    return smoke["legacy"][level][i]


def test_every_fixture_page_matches_the_stored_answers(smoke):
    leg = smoke["legacy"]
    pages = ([p["image"] for p in smoke["pages"]]
             + [p["image"] for p in smoke["rot_pages"]] + [leg["color_page"]])
    assert len(pages) == 13
    t = TDet()
    slowest = 0.0
    for i, img in enumerate(pages):
        t0 = time.perf_counter()
        assert t.detect_lines(img) == _stored(smoke, "lines", i), i
        slowest = max(slowest, time.perf_counter() - t0)
        assert t.detect_words(img) == _stored(smoke, "words", i), i
        assert t.detect_blocks(img) == _stored(smoke, "blocks", i), i
        assert t.detect_characters(img) == _stored(smoke, "chars", i), i
        assert tree(t.detect_all(img)) == leg["all"][i], i
    # kiri_tpu takes 85 s for the lines of the 1280 px page.
    assert slowest < 30


def test_legacy_deskew_matches_the_stored_answers(smoke):
    from kiri_tpu_torch.detect import TextDetector

    td = TextDetector("legacy", deskew=True, device="cpu")
    for page in smoke["rot_pages"]:
        want = page["deskew"]["legacy"]
        boxes = [b.bbox for b in td.detect_lines_objects(page["image"])]
        assert boxes == want["boxes"]
        assert [b.bbox for b in td.last_deskew_boxes] == want["twins"]
        assert td.last_deskew_angle == want["angle"]
