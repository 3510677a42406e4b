"""The port's pseudo-glyph font (kiri_tpu_torch/data/pseudofont.py, drawn
with ops/draw.py instead of Pillow) against kiri_tpu's on the CPU, byte for
byte: every character of the full charset in every style at sizes 18-44
through ``render``, coeng clusters, pre-base vowels, stray marks, the
metrics, and a size no fixture holds."""
from __future__ import annotations

import random

import numpy as np
import pytest

from kiri_tpu.data import pseudofont as J
from kiri_tpu.data.synth import sample_khmer_text
from kiri_tpu.tokenizer import full_charset
from kiri_tpu_torch.data import pseudofont as T

CHARSET = full_charset(include_khmer=True)


def _pair(size: int, style: int):
    return J.PseudoGlyphFont(size, style), T.PseudoGlyphFont(size, style)


@pytest.mark.parametrize("size", range(18, 45))
def test_every_character_every_style(size):
    for style in range(J.N_STYLES):
        ref, ours = _pair(size, style)
        for ch in CHARSET:
            assert np.array_equal(ours.render(ch), ref.render(ch)), (
                size, style, hex(ord(ch)))
            assert ours.getbbox(ch) == ref.getbbox(ch)
            assert ours.getlength(ch) == ref.getlength(ch)


def test_clusters_and_stray_marks():
    """Sampled Khmer lines (coeng stacks, two-part and pre-base vowels,
    mixed English), text starting with marks, dangling coeng and a size no
    fixture holds."""
    rng = random.Random(5)
    texts = [sample_khmer_text(rng, 1, 6, vowel_p=0.75, sign_p=0.5)
             for _ in range(60)]
    texts += ["ិុ ក", "ក្", "េកើ", "ក្ស្តោ",
              "ាំ x", "ក឴឵ខ", "ស្ត្រី", " ", ""]
    for i, text in enumerate(texts):
        for size in (20, 33, 57):
            ref, ours = _pair(size, i % J.N_STYLES)
            assert np.array_equal(ours.render(text), ref.render(text)), text
            assert ours.getbbox(text) == ref.getbbox(text)


def test_paths_and_pillow_mask():
    assert T.pseudo_font_paths() == J.pseudo_font_paths()
    assert T.is_pseudo_path("pseudo://khmer/2") and not T.is_pseudo_path(1)
    font = T.load_pseudo_font("pseudo://khmer/3", 21)
    assert (font.size, font.style) == (21, 3)
    ref = J.load_pseudo_font("pseudo://khmer/3", 21)
    for mode in ("L", "1"):
        a, b = font.getmask("ក្ខ", mode), ref.getmask("ក្ខ", mode)
        assert a.size == b.size and a.histogram() == b.histogram()
        assert all(a.getpixel((x, y)) == b.getpixel((x, y))
                   for x in range(a.size[0]) for y in range(a.size[1]))
