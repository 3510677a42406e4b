"""Frozen copy of ``DocumentGenerator`` of kiri_tpu_torch/data/docsynth.py at
commit 0bc739aac3bff3542a3b3238ea9226e557ccfdbd: synthetic pages in six
layouts, drawn with the pseudo-glyph pool of ``synth.FontManager``. The
draws are the original's, in its order.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .synth import FontManager, draw_text, sample_khmer_text, sample_text

LAYOUTS = ("single_column", "two_column", "title_paragraph", "sparse",
           "dense", "mixed_sizes")
_LAYOUT_WEIGHTS = (0.3, 0.15, 0.2, 0.1, 0.15, 0.1)

DOC_FONT_SIZES = (18, 22, 26, 30, 34)


class DocumentGenerator:
    """Renders synthetic documents and their detection ground truth."""

    def __init__(self, width: int = 640, height: int = 640,
                 fonts: Optional[FontManager] = None, seed: int = 42,
                 augment: bool = True, khmer_ratio: float = 0.0,
                 texts: Optional[Sequence[str]] = None):
        self.width = width
        self.height = height
        self.fonts = fonts or FontManager(sizes=DOC_FONT_SIZES)
        self.rng = random.Random(seed)
        self.augment = augment
        self.khmer_ratio = khmer_ratio if self.fonts.khmer_fonts else 0.0
        #: Optional source corpus: when set, document lines are drawn from
        #: this pool instead of the random word sampler.
        self.texts = list(texts) if texts else None

    # ------------------------------------------------------------ rendering
    def generate(self, layout: Optional[str] = None) -> Dict[str, object]:
        """One document: {image u8 [H,W], lines: [(x,y,w,h)], texts: [str],
        chars: [[(x,y,w,h) per char] per line], layout: str}.
        ``layout`` forces a specific LAYOUTS entry (None = weighted random)."""
        if layout is None:
            layout = self.rng.choices(LAYOUTS, weights=_LAYOUT_WEIGHTS)[0]
        bg = self.rng.randint(240, 255) if self.augment else 255
        img = np.full((self.height, self.width), bg, np.uint8)
        lines: List[Tuple[int, int, int, int]] = []
        texts: List[str] = []
        chars: List[List[Tuple[int, int, int, int]]] = []

        regions = self._layout_regions(layout)
        for (rx, ry, rw, rh, size) in regions:
            y = ry
            while y + size * 2 < ry + rh:
                if self.texts:
                    text = self.rng.choice(self.texts)
                elif self.rng.random() < self.khmer_ratio:
                    text = sample_khmer_text(self.rng, 1,
                                             max(1, rw // (2 * size)))
                else:
                    text = sample_text(self.rng, 2, max(2, rw // (size)))
                ok = self._draw_line(img, text, rx, y, rw, size,
                                     lines, texts, chars)
                y += int(size * self.rng.uniform(1.6, 2.4))
                if not ok:
                    continue
        arr = img
        if self.augment:
            arr = self._augment(arr)
        return {"image": arr, "lines": lines, "texts": texts,
                "chars": chars, "layout": layout}

    def _layout_regions(self, layout: str):
        """Text regions (x, y, w, h, font_size) per layout."""
        W, H = self.width, self.height
        m = self.rng.randint(20, 50)
        size = self.rng.choice(self.fonts.sizes)
        if layout == "single_column":
            return [(m, m, W - 2 * m, H - 2 * m, size)]
        if layout == "two_column":
            cw = (W - 3 * m) // 2
            return [(m, m, cw, H - 2 * m, size),
                    (2 * m + cw, m, cw, H - 2 * m, size)]
        if layout == "title_paragraph":
            title = max(self.fonts.sizes)
            return [(m, m, W - 2 * m, title * 3, title + 6),
                    (m, m + title * 3 + 20, W - 2 * m,
                     H - 2 * m - title * 3 - 20, size)]
        if layout == "sparse":
            return [(m, self.rng.randint(m, H // 2), W - 2 * m,
                     H // 3, size)]
        if layout == "dense":
            small = min(self.fonts.sizes)
            return [(m, m, W - 2 * m, H - 2 * m, small)]
        # mixed_sizes
        h1 = (H - 3 * m) // 2
        return [(m, m, W - 2 * m, h1, max(self.fonts.sizes)),
                (m, 2 * m + h1, W - 2 * m, h1, min(self.fonts.sizes))]

    def _draw_line(self, canvas, text, x, y, max_w, size,
                   lines, texts, chars) -> bool:
        picked = self.fonts.pick(text, self.rng)
        if picked is None:
            return False
        path, _ = picked
        try:
            font = self.fonts.get(path, size)
        except Exception:
            return False
        # Trim text to fit the region width.
        while text and font.getbbox(text)[2] > max_w:
            cut = text.rfind(" ")
            text = text[:cut] if cut > 0 else text[:-1]
        if not text.strip():
            return False
        bbox = font.getbbox(text)
        fg = self.rng.randint(0, 50) if self.augment else 0
        draw_text(canvas, (x - bbox[0], y - bbox[1]), text, fg, font)
        w, h = bbox[2] - bbox[0], bbox[3] - bbox[1]
        lines.append((x, y, w, h))
        texts.append(text)
        # Per-character boxes via incremental advance widths.
        cboxes = []
        for i, ch in enumerate(text):
            if ch == " ":
                continue
            pre = font.getbbox(text[:i]) if i else (0, 0, 0, 0)
            cur = font.getbbox(text[: i + 1])
            cb = font.getbbox(ch)
            cx = x + pre[2] - bbox[0]
            cw = max(1, cur[2] - pre[2])
            cy = y + cb[1] - bbox[1]
            chh = max(1, cb[3] - cb[1])
            cboxes.append((cx, cy, cw, chh))
        chars.append(cboxes)
        return True

    def _augment(self, arr: np.ndarray) -> np.ndarray:
        nprng = np.random.default_rng(self.rng.getrandbits(32))
        if self.rng.random() < 0.5:
            arr = np.clip(arr.astype(np.float32)
                          + nprng.normal(0, self.rng.uniform(2, 8), arr.shape),
                          0, 255).astype(np.uint8)
        return arr
