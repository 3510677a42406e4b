"""kiri_tpu_torch's CRAFT detector against kiri_tpu's on the CPU.

- ``CRAFTNet`` with a seeded ``init_craft_net`` carried across by
  ``convert.craft_state_dict_from_jax``: region and affinity logits within
  1e-4 of ``craft_forward`` (measured 1.2e-5 on logits up to 3.5) on square
  and non-square canvases, and within 1e-4 on the committed
  ``models/craft.safetensors``;
- ``resize_aspect_ratio``: the canvas bytes of kiri_tpu's (cv2 with IPP
  off);
- on the committed checkpoint over the committed pages
  (``kiri_tpu_torch/assets/smoke_pages.npz``: 9 upright and 3 rotated
  pages): the float16 region and affinity maps within 1 float16 step of
  kiri_tpu's stored maps (measured: at most 1 step, in under 2% of the
  values), every page's quads equal to the stored quads and their scores
  within 1e-3 (one float16 step of a score near 1), ``TextDetector``'s
  boxes equal to the stored boxes on the single-page and the batched path,
  and the ``poly=True`` outlines of one page equal to kiri_tpu's
  ``get_poly_core`` on the same maps and to the stored outlines;
- no fallback: a missing model or a failing detection raises where
  kiri_tpu falls back to its classic-CV detector.
"""
from __future__ import annotations

from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decoder_layers import few_torch_threads  # noqa: F401

from kiri_tpu.detect import TextDetector as JTextDetector
from kiri_tpu.detect.craft import get_det_boxes as j_get_det_boxes
from kiri_tpu.detect.craft import load_craft_checkpoint
from kiri_tpu.detect.craft import resize_aspect_ratio as j_resize
from kiri_tpu.detect.craft.net import craft_forward, init_craft_net
from kiri_tpu_torch.checkpoints import read_safetensors
from kiri_tpu_torch.convert import craft_state_dict_from_jax
from kiri_tpu_torch.detect import TextDetector
from kiri_tpu_torch.detect.craft import CRAFTDetector, resize_aspect_ratio
from kiri_tpu_torch.detect.craft.net import CRAFTNet, build_craft_net
from kiri_tpu_torch.smoke import load_smoke_pages

CRAFT = str(Path(__file__).resolve().parent.parent / "models"
            / "craft.safetensors")
LOGIT_TOL = 1e-4
SCORE_TOL = 1e-3


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
    """The 12 pages: the 9 upright ones, then the 3 rotated."""
    return ([p["image"] for p in fixture["pages"]]
            + [p["image"] for p in fixture["rot_pages"]])


@pytest.fixture(scope="module")
def detector():
    return CRAFTDetector(CRAFT, device="cpu")


def _logits(net, x):
    with torch.no_grad():
        r, a = net(torch.from_numpy(x)[:, None])
    return r.numpy(), a.numpy()


@pytest.mark.parametrize("hw", [(64, 64), (96, 160), (160, 96)])
def test_craftnet_matches_craft_forward_on_a_seeded_init(hw):
    variables = init_craft_net(jax.random.PRNGKey(hw[0] + hw[1]))
    net = CRAFTNet()
    net.load_state_dict(craft_state_dict_from_jax(variables), strict=True)
    x = np.random.default_rng(hw[0]).uniform(-1, 1, (2,) + hw).astype(
        np.float32)
    want = craft_forward(variables, jnp.asarray(x)[..., None])[:2]
    got = _logits(net.eval(), x)
    for g, w in zip(got, want):
        assert g.shape == (2, hw[0] // 2, hw[1] // 2)
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=LOGIT_TOL)


def test_craftnet_on_the_committed_checkpoint():
    flat = read_safetensors(CRAFT)
    assert len(flat) == 56
    net = build_craft_net(flat)            # strict
    x = np.random.default_rng(1).uniform(-1, 1, (1, 64, 96)).astype(
        np.float32)
    want = craft_forward(load_craft_checkpoint(CRAFT),
                         jnp.asarray(x)[..., None])[:2]
    for g, w in zip(_logits(net, x), want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=LOGIT_TOL)
    with pytest.raises(ValueError, match="multiples of 16"):
        net(torch.zeros(1, 1, 40, 64))


def test_resize_aspect_ratio_matches_kiri_tpu():
    rng = np.random.default_rng(2)
    for h, w in ((640, 640), (641, 479), (37, 700), (1280, 900), (90, 50)):
        img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        for size, mag in ((1280, 1.5), (960, 1.0), (512, 2.0)):
            got, ratio = resize_aspect_ratio(img, size, mag)
            want, jratio = j_resize(img, size, mag)
            assert ratio == jratio
            np.testing.assert_array_equal(got, want)


def _f16_steps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ia = a.astype(np.float16).view(np.int16).astype(np.int32)
    ib = b.astype(np.float16).view(np.int16).astype(np.int32)
    return np.abs(ia - ib)


def test_craft_maps_within_one_float16_step(detector, pages, fixture):
    for i, stored in fixture["craft_maps"].items():
        region, affinity, _ = detector.predict_maps(pages[i])
        for got, want in zip((region, affinity), stored):
            steps = _f16_steps(got, want.astype(np.float32))
            assert got.shape == want.shape
            assert steps.max() <= 1, (i, int(steps.max()))
            assert (steps > 0).mean() < 0.02, (i, float((steps > 0).mean()))


def _same_detections(ours, ref_quads, ref_scores):
    assert len(ours) == len(ref_quads)
    for (q, s), rq, rs in zip(ours, ref_quads, ref_scores):
        np.testing.assert_array_equal(q, rq)
        assert abs(s - rs) <= SCORE_TOL


def test_craft_quads_equal_the_stored_quads(detector, pages, fixture):
    """Batched over the 12 pages, and one page at a time on two."""
    craft = fixture["craft"]
    batch = detector.detect_text_batch(pages)
    for res, ref in zip(batch, craft):
        _same_detections(res, ref["quads"], ref["scores"])
    for i in (5, 11):
        assert [q.tolist() for q, _ in detector.detect_text(pages[i])] == \
            [q.tolist() for q, _ in batch[i]]


def test_craft_polygons(detector, pages, fixture):
    page, stored = fixture["craft_poly"]
    region, affinity, _ = detector.predict_maps(pages[page])
    ours = detector.detect_text(pages[page], poly=True)
    assert len(ours) == len(stored)
    for (pts, _), ref in zip(ours, stored):
        np.testing.assert_array_equal(pts, ref)
    # get_poly_core itself, on identical maps.
    args = (region, affinity, 0.7, 0.4, 0.4)
    from kiri_tpu_torch.detect.craft import get_det_boxes

    boxes, polys = get_det_boxes(*args, poly=True)
    jboxes, jpolys = j_get_det_boxes(*args, poly=True)
    assert sum(p is not None for p in polys) > 0
    for b, jb in zip(boxes, jboxes):
        np.testing.assert_array_equal(b, jb)
    assert [None if p is None else p.tolist() for p in polys] == \
        [None if p is None else p.tolist() for p in jpolys]


def test_text_detector_craft_boxes(pages, fixture):
    """Six pages in three canvas groups, batched, and one page alone."""
    which = (0, 3, 5, 9, 10, 11)
    sub = [pages[i] for i in which]
    ttd = TextDetector("craft", CRAFT, device="cpu")
    got = dict(ttd.iter_lines_objects_batch(sub))
    for k, i in enumerate(which):
        ref = fixture["craft"][i]
        assert [b.bbox for b in got[k]] == ref["boxes"]
        np.testing.assert_allclose([b.confidence for b in got[k]],
                                   ref["box_conf"], rtol=0, atol=SCORE_TOL)
    assert ttd.detect_lines_objects(pages[0]) == got[0]
    # Pages arrive in canvas groups: shapes sorted, then input order.
    shapes = [resize_aspect_ratio(p, 1280, 1.5)[0].shape for p in sub]
    assert list(got) == sorted(range(len(sub)),
                               key=lambda k: (shapes[k], k))


def test_no_fallback_from_craft(pages, monkeypatch):
    """kiri_tpu falls back to its classic-CV detector when the CRAFT model
    is missing or CRAFT detection raises; the port raises (also for blocks,
    which group CRAFT's lines)."""
    assert JTextDetector("craft", "missing.safetensors").method == "legacy"
    with pytest.raises(FileNotFoundError):
        TextDetector("craft", "missing.safetensors", device="cpu")
    with pytest.raises(FileNotFoundError):
        CRAFTDetector("missing.safetensors", device="cpu")
    ttd = TextDetector("craft", CRAFT, device="cpu")

    def broken(*a, **k):
        raise RuntimeError("detector failed")

    monkeypatch.setattr(ttd.craft_detector, "detect_text", broken)
    with pytest.raises(RuntimeError, match="detector failed"):
        ttd.detect_lines_objects(pages[0])
    monkeypatch.setattr(ttd.craft_detector, "iter_detect_text", broken)
    with pytest.raises(RuntimeError, match="detector failed"):
        ttd.detect_lines_objects_batch(pages[:2])
    # The word and character levels are the classic-CV detector's; blocks
    # group CRAFT's own lines, so they raise with it.
    jtd = JTextDetector("craft", CRAFT)
    assert ttd.detect_words(pages[0]) == jtd.detect_words(pages[0])
    assert ttd.detect_characters(pages[0]) == jtd.detect_characters(pages[0])
    with pytest.raises(RuntimeError, match="detector failed"):
        ttd.detect_blocks(pages[0])
