"""kiri_tpu_torch's cv2-free image operations (ops/imgproc.py,
ops/preprocess.py) byte for byte against cv2 and against kiri_tpu's host
preprocessing, which calls cv2.

cv2 is held with IPP off (OpenCV's own code): a cv2 built with IPP computes
``INTER_CUBIC`` of images at least 4 px wide and high in IPP's float code,
which depends on the CPU. With IPP on, the committed smoke lines (made with
it) differ from the port's in 5024 of 1,966,080 pixels, by one grey level,
in 26 of 64 lines, and float32 CTC reads all 64 lines alike."""
from __future__ import annotations

from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from kiri_tpu.ops import preprocess as JP
from kiri_tpu_torch.ops import preprocess as P
from kiri_tpu_torch.ops.imgproc import (bgr_to_gray, resize_f32_linear,
                                        resize_u8)

CKPT = str(Path(__file__).resolve().parent.parent / "models"
           / "model.safetensors")
INTERP = {"linear": cv2.INTER_LINEAR, "cubic": cv2.INTER_CUBIC,
          "area": cv2.INTER_AREA}


@pytest.fixture(autouse=True)
def cv2_without_ipp():
    before = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(before)


def _images(seed=0):
    """Noise and smooth u8 images, heights 8-200, widths 1-1333."""
    rng = np.random.default_rng(seed)
    for ih in (8, 9, 13, 20, 31, 47, 48, 49, 97, 150, 200):
        for iw in (1, 3, 16, 33, 100, 257, 640, 1333):
            yield rng.integers(0, 256, (ih, iw), dtype=np.uint8)
            yield np.clip(np.cumsum(rng.integers(-9, 10, (ih, iw)), 1) + 128,
                          0, 255).astype(np.uint8)


def _targets(img):
    """Output sizes: to height 48 and 32 with the aspect kept and capped at
    640, a fixed narrow width, the same size, integer factors."""
    ih, iw = img.shape
    out = {(ih, iw), (2 * ih, 2 * iw), (3 * ih, iw), (max(1, ih // 2),
                                                      max(1, iw // 2))}
    for h in (48, 32):
        nw = max(1, round(iw * h / ih))
        out |= {(h, nw), (h, min(nw, 640)), (h, 7)}
    return sorted(out)


def test_gray_is_cv2s_on_every_bgr_triple():
    v = np.arange(1 << 24, dtype=np.uint32)
    bgr = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255],
                   -1).astype(np.uint8).reshape(4096, 4096, 3)
    assert np.array_equal(bgr_to_gray(bgr),
                          cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))
    bgra = np.concatenate([bgr[:256], np.full((256, 4096, 1), 9, np.uint8)],
                          -1)
    assert np.array_equal(P.to_gray(bgra), JP.to_gray(bgra))


@pytest.mark.parametrize("interp", ["linear", "cubic", "area"])
def test_resize_is_cv2s(interp):
    n = 0
    for img in _images():
        for h, w in _targets(img):
            if interp == "area" and (h > img.shape[0] or w > img.shape[1]):
                continue
            want = cv2.resize(img, (w, h), interpolation=INTERP[interp])
            assert np.array_equal(resize_u8(img, w, h, interp), want), \
                (img.shape, h, w)
            n += 1
    assert n > 600


@pytest.mark.parametrize("hw", [(960, 960), (640, 480), (512, 704),
                                (1280, 1280)])
def test_detector_canvas_resize_is_cv2s(hw):
    """The DB canvas: pages resized linearly to a /32 size (and 1920 -> 960,
    an exact 2x, which cv2 runs as INTER_AREA)."""
    rng = np.random.default_rng(hw[0])
    for src in ((hw[0] * 4 // 3, hw[1] * 4 // 3), (hw[0] - 17, hw[1] + 9),
                (2 * hw[0], 2 * hw[1])):
        img = rng.integers(0, 256, src, dtype=np.uint8)
        assert np.array_equal(resize_u8(img, hw[1], hw[0], "linear"),
                              cv2.resize(img, (hw[1], hw[0])))


def test_float_map_resize_is_cv2s():
    rng = np.random.default_rng(1)
    for ih, iw in ((160, 160), (224, 320), (7, 9)):
        prob = rng.integers(0, 65536, (ih, iw)).astype(np.float32) / 65535
        for ds in (2, 4):
            want = cv2.resize(prob, (iw * ds, ih * ds),
                              interpolation=cv2.INTER_LINEAR)
            assert np.array_equal(resize_f32_linear(prob, iw * ds, ih * ds),
                                  want)


def test_line_preprocessing_is_kiri_tpus():
    """resize_keep_ratio_pad_np (area down, cubic up, squeezed or padded),
    preprocess_np on gray, BGR and dark input, and preprocess_regions."""
    from kiri_tpu_torch.config import CFG

    cfg = CFG(IMG_H=48, IMG_W=640)
    rng = np.random.default_rng(2)
    for img in _images(3):
        assert np.array_equal(P.resize_keep_ratio_pad_np(img, 48, 640),
                              JP.resize_keep_ratio_pad_np(img, 48, 640))
    for h, w in ((48, 300), (22, 900), (90, 2000), (31, 31)):
        bgr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        assert np.array_equal(P.preprocess_np(cfg, bgr),
                              JP.preprocess_np(cfg, bgr))
        dark = (rng.random((h, w)) * 90).astype(np.uint8)
        assert np.array_equal(P.preprocess_np(cfg, dark),
                              JP.preprocess_np(cfg, dark))
    page = rng.integers(100, 256, (300, 500), dtype=np.uint8)
    boxes = [(10, 10, 200, 30), (0, 280, 500, 40), (600, 600, 10, 10),
             (480, 50, 40, 12)]
    ours, theirs = (M.preprocess_regions(cfg, page, boxes, enhance=True)
                    for M in (P, JP))
    assert ours[1] == theirs[1] == [0, 1, 3]
    assert np.array_equal(ours[0], theirs[0])
    assert np.array_equal(ours[2], theirs[2])


def test_enhance_crop_is_kiri_tpus():
    """The degraded smoke crops (salt and pepper, noise, low contrast, small
    and noisy: linear upscale then blur), with and without sharpen."""
    from kiri_tpu_torch.smoke import load_smoke_lines, noisy_crops

    d, crops = load_smoke_lines()
    noisy, sharpen = noisy_crops(d)
    for c, sh in zip(noisy + crops[:8], list(sharpen) + [True] * 8):
        assert np.array_equal(P.enhance_crop(c, sharpen=bool(sh)),
                              JP.enhance_crop(c, sharpen=bool(sh)))
    assert P.estimate_noise_sigma(noisy[1]) == JP.estimate_noise_sigma(
        noisy[1])


def test_smoke_crops_preprocess_against_the_committed_lines():
    """The committed ``imgs`` were made by kiri_tpu with IPP on: the port
    (and kiri_tpu with IPP off) differ from them in 5024 pixels by one
    level, and float32 CTC reads every line as from the committed ones."""
    from kiri_tpu_torch.checkpoints import find_vocab_file, load_checkpoint
    from kiri_tpu_torch.engine import RecognizerEngine
    from kiri_tpu_torch.smoke import load_smoke_lines
    from kiri_tpu_torch.tokenizer import CharTokenizer

    d, crops = load_smoke_lines()
    model, cfg, meta = load_checkpoint(CKPT, device="cpu")
    imgs, widths = P.preprocess_crops(cfg, crops)
    assert np.array_equal(imgs, JP.preprocess_crops(cfg, crops)[0])
    assert np.array_equal(widths, d["widths"])
    diff = np.abs(imgs.astype(int) - d["imgs"])
    assert (int((diff > 0).sum()), int(diff.max()),
            int(diff.any(axis=(1, 2)).sum())) == (5024, 1, 26)
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        eng = RecognizerEngine(model, cfg.replace(COMPUTE_DTYPE="float32"),
                               CharTokenizer(find_vocab_file(
                                   meta.get("vocab_path", ""), CKPT), cfg),
                               device="cpu")
        res = eng.recognize_batch(imgs, "ctc", widths)
    finally:
        torch.set_num_threads(before)
    assert [t for t, _ in res] == [str(t) for t in d["batch_texts_f32"]]
    np.testing.assert_allclose([c for _, c in res], d["batch_conf_f32"],
                               atol=5e-4)


#: Angles of the expanded rotation: eval_recognizer's 2-6 degrees either
#: way, and 0.5, 45, 89 and the quarter turns (Pillow's transpose path).
EXPAND_ANGLES = (2.0, -2.0, 3.37, -4.81, 6.0, -6.0, 0.5, 45.0, 89.0, 90.0,
                 -90.0, 180.0)


@pytest.mark.parametrize("hw", [(48, 160), (48, 161), (47, 320), (49, 641),
                                (48, 640), (33, 32), (16, 500)])
def test_rotate_expand_is_pillows(hw):
    """``rotate_bilinear(expand=True)`` against Pillow 12.1's
    ``Image.rotate(angle, BILINEAR, expand=True, fillcolor=fill)``, byte for
    byte and size for size, on odd and even line strips, both fills of the
    evals, and the rotation back that eval_recognizer's --degrade makes."""
    from PIL import Image

    from kiri_tpu_torch.ops.imgproc import rotate_bilinear

    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    img = rng.integers(0, 256, hw, dtype=np.uint8)
    img[:, : hw[1] // 3] = 255
    for angle in EXPAND_ANGLES + tuple(rng.uniform(-6, 6, 3)):
        for fill in (255, 0):
            want = np.asarray(Image.fromarray(img).rotate(
                angle, resample=Image.BILINEAR, expand=True, fillcolor=fill))
            got = rotate_bilinear(img, angle, fill, expand=True)
            assert got.shape == want.shape, (angle, fill)
            np.testing.assert_array_equal(got, want)
            back = np.asarray(Image.fromarray(want).rotate(
                -angle, resample=Image.BILINEAR, expand=True, fillcolor=fill))
            np.testing.assert_array_equal(
                rotate_bilinear(got, -angle, fill, expand=True), back)
