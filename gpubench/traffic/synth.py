"""Frozen copy of the line generator of kiri_tpu_torch/data/synth.py at commit
0bc739aac3bff3542a3b3238ea9226e557ccfdbd, cut to the procedural pseudo-glyph
font pool: the same seed gives the same lines on every machine (no TrueType
file, no Pillow). The draws are the original's, in its order; output
directories and font discovery are left out.
"""
from __future__ import annotations

import random
import string
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .draw import Draw
from .imgproc import gaussian_blur_u8, morph_2x2, resize_u8
from .pseudofont import load_pseudo_font, pseudo_font_paths

_KHMER_RANGE = (0x1780, 0x17FF)


def _is_khmer(text: str) -> bool:
    return any(_KHMER_RANGE[0] <= ord(c) <= _KHMER_RANGE[1] for c in text)



def draw_text(canvas: np.ndarray, xy, text: str, fill: int, font) -> None:
    """``ImageDraw.Draw(img).text(xy, text, fill=fill, font=font)`` of a
    pseudo-glyph font on the u8 [H, W] ``canvas``, in place."""
    Draw(canvas).text(xy, text, fill, font)


class FontManager:
    """The original's ``FontManager(font_dirs=[])``: every text goes to the
    pseudo-glyph pool (no English-capable font, so English falls back to the
    whole pool, as there)."""

    def __init__(self, sizes: Sequence[int] = (24, 28, 32, 36, 40, 44)):
        self.sizes = list(sizes)
        self.english_fonts: List[str] = []
        self.khmer_fonts = pseudo_font_paths()
        self.font_paths = list(self.khmer_fonts)
        self._cache: Dict[Tuple[str, int], object] = {}

    def get(self, path: str, size: int):
        key = (path, size)
        if key not in self._cache:
            self._cache[key] = load_pseudo_font(path, size)
        return self._cache[key]

    def pick(self, text: str, rng: random.Random) -> Optional[Tuple[str, int]]:
        pool = self.khmer_fonts if _is_khmer(text) else self.english_fonts
        if not pool:
            pool = self.font_paths
        if not pool:
            return None
        return rng.choice(pool), rng.choice(self.sizes)


class ImageRenderer:
    """Renders one text line to a uint8 grayscale image with augmentation."""

    def __init__(self, height: int = 48, pad: int = 8, augment: bool = True):
        self.height = height
        self.pad = pad
        self.augment = augment

    def render(self, text: str, font, rng: random.Random) -> np.ndarray:
        bbox = font.getbbox(text)
        tw = max(1, bbox[2] - bbox[0])
        th = max(1, bbox[3] - bbox[1])
        # Per-side margin jitter: detector crops have variable margins.
        if self.augment:
            pl, pr = rng.randint(1, 2 * self.pad), rng.randint(1, 2 * self.pad)
            pt, pb = rng.randint(1, 2 * self.pad), rng.randint(1, 2 * self.pad)
        else:
            pl = pr = pt = pb = self.pad
        w = tw + pl + pr
        h = th + pt + pb
        bg = rng.randint(235, 255) if self.augment else 255
        fg = rng.randint(0, 40) if self.augment else 0
        arr = np.full((h, w), bg, np.uint8)
        draw_text(arr, (pl - bbox[0], pt - bbox[1]), text, fg, font)
        # Edge artifacts: fragments of neighbouring lines clipped at the
        # top/bottom border, as real detector crops contain.
        if self.augment and rng.random() < 0.35:
            frag = text[: rng.randint(2, max(3, len(text) // 2))]
            if rng.random() < 0.5:
                fy = -th + rng.randint(2, max(3, pt // 2) + 2)  # top edge
            else:
                fy = h - rng.randint(2, max(3, pb // 2) + 2)    # bottom edge
            draw_text(arr, (rng.randint(0, max(1, w // 3)), fy), frag, fg,
                      font)
        if self.augment:
            arr = self._augment(arr, rng)
        # Scale to target height keeping aspect (cv2's area or linear).
        scale = self.height / arr.shape[0]
        nw = max(1, int(round(arr.shape[1] * scale)))
        return resize_u8(arr, nw, self.height,
                         "area" if scale < 1 else "linear")

    def _augment(self, arr: np.ndarray, rng: random.Random) -> np.ndarray:
        """Noise, blur, morphology, brightness: the JAX package's draws and
        numpy expressions, with cv2's blur and morphology in numpy."""
        nprng = np.random.default_rng(rng.getrandbits(32))
        if rng.random() < 0.5:
            sigma = rng.uniform(2, 10)
            arr = np.clip(arr.astype(np.float32)
                          + nprng.normal(0, sigma, arr.shape), 0, 255)
            arr = arr.astype(np.uint8)
        if rng.random() < 0.3:
            arr = gaussian_blur_u8(arr, rng.choice([3, 5]))
        if rng.random() < 0.2:
            arr = morph_2x2(arr, "erode" if rng.random() < 0.5 else "dilate")
        if rng.random() < 0.4:
            alpha = rng.uniform(0.85, 1.15)
            beta = rng.uniform(-15, 15)
            arr = np.clip(arr.astype(np.float32) * alpha + beta, 0, 255)
            arr = arr.astype(np.uint8)
        return arr


_EN_WORDS = ("the quick brown fox jumps over lazy dog a and to of in is it "
             "you that he was for on are with as his they be at one have "
             "this from or had by hot word but what some we can out other "
             "were all there when up use your how said an each she").split()

# Every non-space printable ASCII char, for the occasional "soup" word.
_ASCII_SOUP = string.digits + string.ascii_letters + string.punctuation


def sample_text(rng: random.Random, min_words: int = 1, max_words: int = 8,
                charset: Optional[str] = None) -> str:
    """Random English-ish line; mixes words, digits, punctuation, and rare
    random-ASCII 'soup' words so every printable char appears in training."""
    n = rng.randint(min_words, max_words)
    words = []
    for _ in range(n):
        r = rng.random()
        if r < 0.70:
            w = rng.choice(_EN_WORDS)
            if rng.random() < 0.2:
                w = w.capitalize()
            elif rng.random() < 0.06:
                w = w.upper()
        elif r < 0.85:
            w = "".join(rng.choice(string.digits)
                        for _ in range(rng.randint(1, 5)))
        elif r < 0.93:
            w = rng.choice(_EN_WORDS) + rng.choice(".,!?:;")
        else:
            w = "".join(rng.choice(_ASCII_SOUP)
                        for _ in range(rng.randint(2, 6)))
        words.append(w)
    text = " ".join(words)
    if charset is not None:
        text = "".join(c for c in text if c in charset) or "a"
    return text


_KHMER_CONS = [chr(c) for c in range(0x1780, 0x17A3)]
_KHMER_INDEP = [chr(c) for c in range(0x17A5, 0x17B4)]
_KHMER_VOWELS = [chr(c) for c in range(0x17B6, 0x17C6)]
_KHMER_SIGNS = [chr(c) for c in (0x17C6, 0x17C7, 0x17C9, 0x17CA, 0x17CB,
                                 0x17CC, 0x17CD, 0x17D0)]
_KHMER_DIGITS = [chr(c) for c in range(0x17E0, 0x17EA)]


def sample_khmer_word(rng: random.Random, vowel_p: float = 0.55,
                      sign_p: float = 0.18) -> str:
    """One Khmer 'word': consonant clusters with dependent vowels/signs,
    occasionally digits or an independent vowel; ``vowel_p``/``sign_p`` are
    the per-cluster probabilities of a dependent vowel and a sign."""
    r = rng.random()
    if r < 0.06:
        return "".join(rng.choice(_KHMER_DIGITS)
                       for _ in range(rng.randint(1, 4)))
    chars = []
    if r < 0.12:
        chars.append(rng.choice(_KHMER_INDEP))
    for _ in range(rng.randint(1, 5)):
        chars.append(rng.choice(_KHMER_CONS))
        if rng.random() < 0.15:  # coeng stack: subscript consonant
            chars.append("្")
            chars.append(rng.choice(_KHMER_CONS))
        if rng.random() < vowel_p:
            chars.append(rng.choice(_KHMER_VOWELS))
        if rng.random() < sign_p:
            chars.append(rng.choice(_KHMER_SIGNS))
    return "".join(chars)


def sample_khmer_text(rng: random.Random, min_words: int = 1,
                      max_words: int = 6, mixed_ratio: float = 0.15,
                      vowel_p: float = 0.55, sign_p: float = 0.18) -> str:
    """Khmer line; with probability `mixed_ratio` per word, an English word
    is interleaved (mixed-script lines, as bilingual documents contain)."""
    words = []
    for _ in range(rng.randint(min_words, max_words)):
        if rng.random() < mixed_ratio:
            words.append(rng.choice(_EN_WORDS))
        else:
            words.append(sample_khmer_word(rng, vowel_p, sign_p))
    return " ".join(words)



class DatasetGenerator:
    """In-memory line samples (the original's ``generate_one`` and
    ``generate_samples``, without an output directory or width cap)."""

    def __init__(self, height: int = 48, augment: bool = True,
                 seed: int = 42):
        self.fonts = FontManager()
        self.renderer = ImageRenderer(height=height, augment=augment)
        self.rng = random.Random(seed)

    def generate_one(self, text: str) -> Optional[np.ndarray]:
        picked = self.fonts.pick(text, self.rng)
        if picked is None:
            return None
        path, size = picked
        try:
            font = self.fonts.get(path, size)
            img = self.renderer.render(text, font, self.rng)
        except Exception:
            return None
        return img
    def generate_samples(self, texts: Sequence[str]
                         ) -> List[Dict[str, object]]:
        """[{image u8 [H, W'], text}] of the given texts (the original's
        ``generate_samples(len(texts), texts=texts)``: a text whose render
        fails is left out)."""
        out = []
        for text in texts:
            img = self.generate_one(text)
            if img is not None:
                out.append({"image": img, "text": text})
        return out
