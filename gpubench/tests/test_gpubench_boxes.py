"""The reference's page boxes and crops (``reference/boxes.py``) against two
witnesses it does not import: the program's own detector on the CPU, and
OpenCV's resizes, whose semantics the configuration's host preprocessing
states."""
import json

import numpy as np
import pytest
import torch

from harness import spec
from reference.boxes import crop_lines, page_boxes
from reference.detector import RefDB, page_canvas
from traffic import imgproc, make

CONFIG = json.loads((spec.HERE / "configs" / "kiri-ocr-v13-db.json")
                    .read_text())
DET = CONFIG["detector"]
#: Pages of the pages-batch pool of seed 11: page 11 has a box the column
#: split cuts in two.
SEED, PAGES = 11, (11, 0, 20)


@pytest.fixture(scope="module")
def pages():
    pool = make.pages(make.load_mix("pages-batch"), SEED)["pages"]
    return [pool[i] for i in PAGES]


@pytest.fixture(scope="module")
def maps(pages):
    torch.set_num_threads(2)
    db = RefDB(spec.ROOT / DET["checkpoint"], "cpu")
    return [db.u16_map(p) for p in pages]


def test_boxes_equal_the_programs_detector(pages, maps):
    from kiri_tpu_torch.detect import TextDetector

    program = TextDetector("db", str(spec.ROOT / DET["checkpoint"]),
                           device="cpu")
    split = 0
    for page, pred in zip(pages, maps):
        theirs = program.detect_lines_objects(page)
        ours = page_boxes(pred, page, DET)
        assert [b["box"] for b in ours] == [
            (t.x, t.y, t.width, t.height) for t in theirs]
        assert max(abs(b["score"] - t.confidence)
                   for b, t in zip(ours, theirs)) < 1e-5
        unsplit = page_boxes(pred, page, dict(DET, split_columns=False))
        split += len(ours) - len(unsplit)
    assert split > 0


def test_db_adapter_equals_the_code_it_wraps(pages, maps):
    from reference import detectors

    ours = detectors.load(DET, spec.ROOT, "cpu")
    assert [ours.boxes(p) for p in pages] == [
        page_boxes(m, p, DET) for p, m in zip(pages, maps)]
    low = detectors.load(DET, spec.ROOT, "cpu", control=True)
    tf32 = RefDB(spec.ROOT / DET["checkpoint"], "cpu", tf32=True)
    assert low.net.tf32 and not ours.net.tf32
    assert [low.boxes(p) for p in pages] == [
        page_boxes(tf32.u16_map(p), p, DET) for p in pages]


def test_crops_and_canvas_follow_opencv(pages, maps):
    cv2 = pytest.importorskip("cv2", reason="OpenCV is the witness")
    cfg = CONFIG["model"]
    h, w = cfg["IMG_H"], cfg["IMG_W"]
    before = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        for page, pred in zip(pages, maps):
            canvas, (nh, nw) = page_canvas(page)
            assert np.array_equal(canvas[:nh, :nw], cv2.resize(
                page, (nw, nh), interpolation=cv2.INTER_LINEAR))
            boxes = [b["box"] for b in page_boxes(pred, page, DET)]
            lines, widths, kept = crop_lines(cfg, page, boxes,
                                             DET["crop_padding"])
            assert len(kept) == len(boxes) > 0
            pad = DET["crop_padding"]
            for (x, y, bw, bh), line, cw in zip(boxes, lines, widths):
                roi = page[max(0, y - pad):y + bh + pad,
                           max(0, x - pad):x + bw + pad]
                roi = 255 - roi if roi.mean() < 127 else roi
                scale = h / roi.shape[0]
                nw_ = max(1, int(round(roi.shape[1] * scale)))
                want = np.full((h, w), 128, np.uint8)
                got = cv2.resize(roi, (min(nw_, w), h), interpolation=(
                    cv2.INTER_AREA if scale < 1 else cv2.INTER_CUBIC))
                want[:, :got.shape[1]] = got
                assert np.array_equal(line, want) and cw == min(nw_, w)
    finally:
        cv2.ipp.setUseIPP(before)


def test_resizes_follow_opencv_on_odd_sizes():
    cv2 = pytest.importorskip("cv2", reason="OpenCV is the witness")
    rng = np.random.default_rng(5)
    before = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        for (sh, sw), (dh, dw) in [((1280, 640), (960, 480)),
                                   ((97, 301), (40, 130)),
                                   ((33, 70), (48, 102))]:
            img = rng.integers(0, 256, (sh, sw), np.uint8)
            shrink = dh < sh
            for interp, flag in (("linear", cv2.INTER_LINEAR),
                                 ("area", cv2.INTER_AREA),
                                 ("cubic", cv2.INTER_CUBIC)):
                if interp == "area" and not shrink:
                    continue        # area serves only to shrink
                assert np.array_equal(
                    imgproc.resize_u8(img, dw, dh, interp),
                    cv2.resize(img, (dw, dh), interpolation=flag)), interp
    finally:
        cv2.ipp.setUseIPP(before)
