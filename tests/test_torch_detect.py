"""kiri_tpu_torch's DB detection against kiri_tpu's on the CPU with the
committed detector weights, over the committed docsynth pages
(kiri_tpu_torch/assets/smoke_pages.npz: three layouts, four canvas groups
with a downscaled 1280 px page, an inverted and a noisy page, and a
two-column page with a box that ``_split_column_merges`` splits).

- ``DBNet`` against ``db_forward``: prob within 1e-4 (measured 2.4e-5),
  and within 1e-5 of its own float64 forward (measured 5.5e-6 on the 8
  pages, where kiri_tpu's float32 map is up to 1.5e-4 off the float64
  one);
- ``DBDetector.detect_text`` / ``detect_text_batch``: identical quads,
  scores within 5e-5 (measured 1.59e-5; the maps differ by up to 10 u16
  counts), with ``det_map_downsample`` 1 and 2;
- ``TextDetector.detect_lines_objects`` / ``iter_lines_objects_batch``:
  identical ``TextBox``es, pages yielded in kiri_tpu's order;
- where kiri_tpu falls back to its classic-CV detector, the port raises
  (the CRAFT route's own cases are in tests/test_torch_craft.py); the
  classic-CV levels themselves read as kiri_tpu's (and in full in
  tests/test_torch_legacy.py).

cv2 runs with IPP off (see tests/test_torch_imgproc.py)."""
from __future__ import annotations

from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decoder_layers import few_torch_threads  # noqa: F401
from torch_pages import SCORE_TOL

from kiri_tpu.detect import TextDetector as JTextDetector
from kiri_tpu.detect.db import DBDetector as JDBDetector
from kiri_tpu.detect.db import load_db_checkpoint
from kiri_tpu.detect.db.net import db_forward
from kiri_tpu_torch.checkpoints import read_safetensors
from kiri_tpu_torch.detect import TextDetector
from kiri_tpu_torch.detect.db import DBDetector
from kiri_tpu_torch.detect.db.net import build_db_net, state_dict_from_jax
from kiri_tpu_torch.ops.imgproc import resize_u8
from kiri_tpu_torch.ops.preprocess import invert_if_dark
from kiri_tpu_torch.smoke import load_smoke_pages

DET = str(Path(__file__).resolve().parent.parent / "models"
          / "detector.safetensors")


@pytest.fixture(scope="module", autouse=True)
def cv2_without_ipp():
    before = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(before)


@pytest.fixture(scope="module")
def fixture():
    return load_smoke_pages()


@pytest.fixture(scope="module")
def pages(fixture):
    return [p["image"] for p in fixture["pages"]]


def test_db_checkpoint_loads_strictly_with_flipped_deconvs():
    flat = read_safetensors(DET)
    sd = state_dict_from_jax(flat)
    assert len(flat) == len(sd) == 89
    build_db_net(flat)  # strict
    w = flat["params.prob_d1.w"]
    assert np.array_equal(sd["layers.prob_d1.deconv.weight"].numpy(),
                          w.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
    assert np.array_equal(sd["layers.stem.conv.weight"].numpy(),
                          flat["params.stem.w"].transpose(3, 2, 0, 1))


@pytest.mark.parametrize("hw", [(320, 320), (448, 640)])
def test_dbnet_matches_db_forward(pages, hw):
    """Two page canvases (the two-column and the inverted page): float32
    prob within 1e-4 of kiri_tpu's (measured 2.4e-5 at 448x640)."""
    h, w = hw
    x = np.stack([resize_u8(pages[i], w, h, "linear") for i in (1, 6)])
    xf = (x.astype(np.float32) / 255.0 - 0.5) / 0.5
    want = np.asarray(db_forward(load_db_checkpoint(DET),
                                 jnp.asarray(xf[..., None]))[0])
    with torch.inference_mode():
        got = build_db_net(read_safetensors(DET))(
            torch.from_numpy(xf[:, None])).numpy()
    assert got.shape == want.shape == (2, h, w)
    assert np.abs(got - want).max() < 1e-4
    with torch.inference_mode():
        exact = build_db_net(read_safetensors(DET)).double()(
            torch.from_numpy(xf[:, None]).double()).numpy()
    assert np.abs(got - exact).max() < 1e-5


def _same_detections(ours, ref):
    assert len(ours) == len(ref)
    for (q, s), (jq, js) in zip(ours, ref):
        assert np.array_equal(q, jq)
        assert abs(s - js) < SCORE_TOL


#: det_map_downsample=2 on four pages: three canvas groups and the dark one.
SUBSET = (0, 3, 4, 6)


@pytest.mark.parametrize("ds", [1, 2])
def test_db_detector_matches_kiri_tpu(pages, fixture, ds):
    pages = pages if ds == 1 else [pages[i] for i in SUBSET]
    jdb = JDBDetector(DET, det_map_downsample=ds)
    tdb = DBDetector(DET, det_map_downsample=ds, device="cpu")
    singles = [tdb.detect_text(p) for p in pages]
    for p, ours in zip(pages, singles):
        _same_detections(ours, jdb.detect_text(p))
    order = [i for i, _ in tdb.iter_detect_text(pages)]
    assert order == [i for i, _ in jdb.iter_detect_text(pages)]
    assert order != sorted(order)       # canvas groups, not input order
    for ours, single in zip(tdb.detect_text_batch(pages), singles):
        _same_detections(ours, single)
    if ds == 1:
        for p, ours in zip(fixture["pages"], singles):
            assert np.array_equal(np.asarray([q for q, _ in ours]),
                                  p["det_quads"])


def test_db_map_is_the_stored_map(pages, fixture):
    """The u16 map of the stored page (kiri_tpu's, on the CPU): within 8
    counts, the bound the card run holds it to (measured 5)."""
    tdb = DBDetector(DET, device="cpu")
    page = pages[fixture["prob_page"]]
    canvas, _, _ = tdb._resize_image(invert_if_dark(tdb._to_gray(page)))
    wire = tdb.forward_wire(canvas[None]).numpy()[0]
    assert wire.shape == fixture["prob_u16"].shape
    assert np.abs(wire - fixture["prob_u16"].astype(np.int64)).max() <= 8


def _tb(boxes):
    """TextBoxes as (bbox, level) rows."""
    return [(b.bbox, b.level.value) for b in boxes]


def _same_boxes(ours, ref):
    assert _tb(ours) == _tb(ref)
    for a, b in zip(ours, ref):
        assert abs(a.confidence - b.confidence) < SCORE_TOL


@pytest.mark.parametrize("ds", [1, 2])
def test_text_detector_matches_kiri_tpu(pages, fixture, ds):
    pages = pages if ds == 1 else [pages[i] for i in SUBSET]
    jtd = JTextDetector("db", DET, det_map_downsample=ds)
    ttd = TextDetector("db", DET, device="cpu", det_map_downsample=ds)
    singles = [ttd.detect_lines_objects(p) for p in pages]
    for p, ours in zip(pages, singles):
        _same_boxes(ours, jtd.detect_lines_objects(p))
    ours = list(ttd.iter_lines_objects_batch(pages))
    ref = list(jtd.iter_lines_objects_batch(pages))
    assert [i for i, _ in ours] == [i for i, _ in ref]
    for (_, a), (_, b) in zip(ours, ref):
        _same_boxes(a, b)
    assert ttd.last_batch_state == [(None, None, 0.0)] * len(pages)
    for a, b in zip(ttd.detect_lines_objects_batch(pages), singles):
        _same_boxes(a, b)
    if ds == 1:
        assert [[b.bbox for b in s] for s in singles] == \
            [p["boxes"] for p in fixture["pages"]]


def test_box_rows_sort_and_merge_as_kiri_tpu(fixture):
    """``_process_boxes_objects`` with sorting and merging and a padding
    (the path DB skips), on each page's stored quads in reverse order."""
    jtd = JTextDetector("db", DET, padding=3)
    ttd = TextDetector("db", DET, device="cpu", padding=3)
    n_items = n_merged = 0
    for p in fixture["pages"]:
        items = [(q, float(s)) for q, s in zip(p["det_quads"][::-1],
                                                 p["det_scores"][::-1])]
        for merge in (False, True):
            ours = ttd._process_boxes_objects(items, merge=merge)
            ref = jtd._process_boxes_objects(items, merge=merge)
            assert [(b.bbox, b.confidence) for b in ours] == \
                [(b.bbox, b.confidence) for b in ref]
        n_items, n_merged = n_items + len(items), n_merged + len(ours)
    assert n_merged < n_items          # some rows were merged


def test_column_split_fires_on_the_two_column_page(pages):
    """Without the split the last page (two columns of docsynth's own,
    lines) has a box that bridges the gutter; with it, as in kiri_tpu, the
    box is cut in two."""
    split = TextDetector("db", DET, device="cpu").detect_lines(pages[8])
    raw = TextDetector("db", DET, device="cpu",
                       split_columns=False).detect_lines(pages[8])
    assert len(split) == len(raw) + 1
    assert len(set(raw) - set(split)) == 1          # one box was cut
    assert split == JTextDetector("db", DET).detect_lines(pages[8])


def test_no_fallback_to_another_detector(pages, monkeypatch):
    """kiri_tpu falls back to its classic-CV detector when the DB model is
    missing or DB detection raises; the port raises."""
    assert JTextDetector("db", "missing.safetensors").method == "legacy"
    with pytest.raises(FileNotFoundError):
        TextDetector("db", "missing.safetensors", device="cpu")
    with pytest.raises(FileNotFoundError):
        TextDetector("craft", "missing.safetensors", device="cpu")
    assert (TextDetector("legacy", device="cpu").detect_lines(pages[0])
            == JTextDetector("legacy").detect_lines(pages[0]))
    with pytest.raises(NotImplementedError, match=r"\.onnx|ONNX"):
        DBDetector("detector.onnx", device="cpu")
    ttd = TextDetector("db", DET, device="cpu")
    jtd = JTextDetector("db", DET)
    for name in ("detect_words", "detect_blocks", "detect_characters"):
        assert (getattr(ttd, name)(pages[0])
                == getattr(jtd, name)(pages[0])), name

    def broken(*a, **k):
        raise RuntimeError("detector failed")

    jtd = JTextDetector("db", DET)
    monkeypatch.setattr(jtd.db_detector, "detect_text", broken)
    assert jtd.detect_lines_objects(pages[0])        # classic-CV boxes
    monkeypatch.setattr(ttd.db_detector, "detect_text", broken)
    with pytest.raises(RuntimeError, match="detector failed"):
        ttd.detect_lines_objects(pages[0])
    monkeypatch.setattr(jtd.db_detector, "iter_detect_text", broken)
    assert all(jtd.detect_lines_objects_batch(pages[:2]))
    monkeypatch.setattr(ttd.db_detector, "iter_detect_text", broken)
    with pytest.raises(RuntimeError, match="detector failed"):
        ttd.detect_lines_objects_batch(pages[:2])
