"""kiri_tpu_torch's device crop cleanup (``kernels/resize.enhance_lines``,
``post_blur_masked``) against kiri_tpu's on the CPU, on the crops of
tests/test_enhance.py rebuilt here from a seed (clean, salt and pepper,
gaussian noise, low contrast, small and noisy under 36 px, a per-crop
sharpen mask): u8 output and small-noisy flags identical, the blur within
1e-6; and ``recognize_crops(..., enhance=True, sharpen=mask)`` on the small
random model against kiri_tpu's engine live (texts equal, confidences
within 1e-4)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw, ImageFont
from test_torch_decoder_layers import few_torch_threads, make_small_model  # noqa: F401

from kiri_tpu.engine import RecognizerEngine as JEngine
from kiri_tpu.kernels import resize as JR
from kiri_tpu_torch.engine import RecognizerEngine
from kiri_tpu_torch.kernels import resize as R

FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"


def _line(text: str, w: int = 320, h: int = 48, size: int = 30):
    img = Image.new("L", (w, h), 255)
    ImageDraw.Draw(img).text((8, (h - size) // 2 - 3), text,
                             font=ImageFont.truetype(FONT, size), fill=0)
    return np.asarray(img, np.uint8)


def _noisy(img, sigma, rng):
    return np.clip(img.astype(np.float32) + rng.normal(0, sigma, img.shape),
                   0, 255).astype(np.uint8)


def _low_contrast(img, lo=90, hi=180):
    return np.clip(img.astype(np.float32) / 255.0 * (hi - lo) + lo,
                   0, 255).astype(np.uint8)


def _small(img, w=150, h=22):
    return np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))


def crops_of_test_enhance(seed: int = 11):
    """The conditions of tests/test_enhance.py, and a sharpen mask."""
    rng = np.random.default_rng(seed)
    clean = _line("hello world")
    other = _line("kiri 2026", w=260, h=56, size=36)
    sp = clean.copy()
    sp[(rng.random(sp.shape) < 0.004) & (sp > 200)] = 0
    sp[(rng.random(sp.shape) < 0.002) & (sp < 60)] = 255
    small = _small(clean)
    crops = [clean, _noisy(clean, 20, rng), _low_contrast(clean), small,
             _noisy(small, 20, rng), _low_contrast(small), sp,
             _noisy(_low_contrast(clean), 16, rng), other,
             _noisy(other, 8, rng), _noisy(_small(other, 120, 30), 14, rng),
             255 - _low_contrast(clean, 40, 200)]
    return crops, np.arange(len(crops)) % 3 == 0


@pytest.fixture(scope="module")
def packed():
    crops, mask = crops_of_test_enhance()
    buf, sizes = R.pack_crops(crops)
    return crops, mask, buf, sizes


@pytest.mark.parametrize("sharpen", ["mask", True, False])
def test_enhance_lines_matches_kiri_tpu(packed, sharpen):
    crops, mask, buf, sizes = packed
    sh = mask if sharpen == "mask" else sharpen
    want, want_sn = JR.enhance_lines(jnp.asarray(buf), jnp.asarray(sizes),
                                     sharpen=jnp.asarray(sh))
    got, got_sn = R.enhance_lines(torch.from_numpy(buf),
                                  torch.from_numpy(sizes), torch.tensor(sh))
    assert got.dtype == torch.uint8 and got.shape == buf.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_sn.numpy(), np.asarray(want_sn))
    # Every condition does something: the noisy small crops are flagged,
    # the stretch and the blur change pixels, padding is kept.
    assert got_sn.numpy().tolist() == [False, False, False, False, True,
                                       False, False, False, False, False,
                                       True, False]
    changed = [(got[i].numpy() != buf[i]).sum() for i in range(len(crops))]
    assert changed[2] > 1000 and changed[1] > 1000 and changed[6] > 0
    for i, (h, w) in enumerate(sizes):
        np.testing.assert_array_equal(got[i, h:].numpy(), buf[i, h:])
        np.testing.assert_array_equal(got[i, :, w:].numpy(), buf[i, :, w:])


def test_sharpen_mask_sharpens_only_its_crops(packed):
    _, mask, buf, sizes = packed
    on, _ = R.enhance_lines(torch.from_numpy(buf), torch.from_numpy(sizes),
                            True)
    off, _ = R.enhance_lines(torch.from_numpy(buf), torch.from_numpy(sizes))
    some, _ = R.enhance_lines(torch.from_numpy(buf), torch.from_numpy(sizes),
                              torch.from_numpy(mask))
    for i, m in enumerate(mask):
        assert torch.equal(some[i], (on if m else off)[i])
    assert not torch.equal(on[0], off[0])


def test_post_blur_masked_matches_kiri_tpu():
    rng = np.random.default_rng(3)
    norm = rng.uniform(-1, 1, (6, 48, 96)).astype(np.float32)
    mask = np.asarray([True, False, True, True, False, True])
    want = np.asarray(JR.post_blur_masked(jnp.asarray(norm),
                                          jnp.asarray(mask)))
    got = R.post_blur_masked(torch.from_numpy(norm),
                             torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[~mask], norm[~mask])
    assert np.abs(got[mask] - norm[mask]).max() > 0.1


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    variables, jcfg, jtok, model, cfg, tok = make_small_model(
        tmp_path_factory.mktemp("small"))
    return (JEngine(variables, jcfg, jtok),
            RecognizerEngine(model, cfg, tok, device="cpu"))


@pytest.mark.parametrize("method", ["ctc", "decoder"])
def test_recognize_crops_enhanced_matches_kiri_tpu(small, packed, method):
    jeng, eng = small
    crops, mask, _, _ = packed
    ours = eng.recognize_crops(crops[:7], method, enhance=True,
                               sharpen=mask[:7])
    ref = jeng.recognize_crops(crops[:7], method, enhance=True,
                               sharpen=mask[:7])
    assert [t for t, _ in ours] == [t for t, _ in ref]
    np.testing.assert_allclose([c for _, c in ours], [c for _, c in ref],
                               atol=1e-4)
    # Enhancement reaches the model: the low-contrast crop reads otherwise.
    plain = eng.recognize_crops(crops[:7], method)
    assert ours != plain
