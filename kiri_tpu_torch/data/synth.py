"""Synthetic text-line images for recognizer training: the port of
``kiri_tpu/data/synth.py``.

Font pools with per-script routing and tofu detection, random font sizes,
the augmentations (noise, blur, morphology, brightness, crop jitter, edge
fragments), ``labels.txt`` output with append, and the multilingual text
samplers. Every random draw is made in the JAX package's order, so the same
seed gives the same lines, labels and pixels.

Text is drawn without Pillow where the font is the procedural pseudo-glyph
pool (``pseudofont.py`` over ``ops/draw.py``), and the augmentations and
resizes are cv2's and Pillow's arithmetic in numpy (``ops/imgproc.py``).
A TrueType font needs Pillow's FreeType rasterizer, imported when such a
font is loaded:

- without Pillow, the TTFs found on the system are left out (a warning
  says how many), as a font that fails to load is left out; the pool is
  then the pseudo-glyph one;
- font directories named by the caller, or a font file, raise without
  Pillow.
"""
from __future__ import annotations

import importlib
import random
import string
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.draw import Draw
from ..ops.imgproc import (gaussian_blur_u8, morph_2x2, pil_resize_bilinear,
                           resize_u8)
from ..utils.imageio import imwrite_png
from .pseudofont import (PseudoGlyphFont, is_pseudo_path, load_pseudo_font,
                         pseudo_font_paths)

_FONT_DIRS = [
    "/usr/share/fonts/truetype",
    "/usr/share/fonts",
    "/usr/local/share/fonts",
]
_KHMER_RANGE = (0x1780, 0x17FF)


def _is_khmer(text: str) -> bool:
    return any(_KHMER_RANGE[0] <= ord(c) <= _KHMER_RANGE[1] for c in text)


def pillow_modules():
    """(PIL.Image, PIL.ImageDraw, PIL.ImageFont), or None where Pillow
    cannot be imported."""
    try:
        return tuple(importlib.import_module(f"PIL.{m}")
                     for m in ("Image", "ImageDraw", "ImageFont"))
    except ImportError:
        return None


def require_pillow(what: str):
    """Pillow's modules, or an error saying that ``what`` needs them."""
    mods = pillow_modules()
    if mods is None:
        raise RuntimeError(
            f"{what} needs Pillow's TrueType rasterizer, and Pillow cannot "
            "be imported here; without it the generators draw with the "
            "procedural pseudo-glyph fonts only (leave out the font options)")
    return mods


def draw_text(canvas: np.ndarray, xy, text: str, fill: int, font) -> None:
    """``ImageDraw.Draw(img).text(xy, text, fill=fill, font=font)`` on the
    u8 [H, W] ``canvas`` in place: in numpy for a pseudo-glyph font,
    through Pillow for a TrueType one."""
    if isinstance(font, PseudoGlyphFont):
        Draw(canvas).text(xy, text, fill, font)
        return
    image, image_draw, _ = require_pillow("drawing a TrueType font")
    img = image.fromarray(canvas)
    image_draw.Draw(img).text(xy, text, fill=fill, font=font)
    canvas[...] = np.asarray(img)


class FontManager:
    """Discovers system fonts and routes text to fonts that can render it.

    A font is accepted for a script only if rendering a probe string gives
    non-blank, distinct glyphs (the tofu check). With no Khmer-capable font,
    Khmer goes to the pseudo-glyph pool (``allow_pseudo``);
    ``font_dirs=[]`` means no discovery, so every text goes there.
    """

    def __init__(self, font_dirs: Optional[Sequence[str]] = None,
                 sizes: Sequence[int] = (24, 28, 32, 36, 40, 44),
                 allow_pseudo: bool = True):
        self.sizes = list(sizes)
        found = self._discover(font_dirs if font_dirs is not None
                               else _FONT_DIRS)
        if found and pillow_modules() is None:
            if font_dirs is not None:
                require_pillow(f"the fonts under {list(font_dirs)}")
            warnings.warn(f"{len(found)} TrueType font(s) left out: loading "
                          "them needs Pillow, which cannot be imported here")
            found = []
        self.font_paths = found
        self._cache: Dict[Tuple[str, int], object] = {}
        self.english_fonts = [p for p in self.font_paths
                              if self._supports(p, "Ag1")]
        self.khmer_fonts = [p for p in self.font_paths
                            if self._supports(p, "កខ")]
        if allow_pseudo and not self.khmer_fonts:
            self.khmer_fonts = pseudo_font_paths()
            self.font_paths = self.font_paths + self.khmer_fonts

    @staticmethod
    def _discover(dirs: Sequence[str]) -> List[str]:
        out = []
        for d in dirs:
            p = Path(d)
            if p.exists():
                out.extend(str(f) for f in p.rglob("*.ttf"))
                out.extend(str(f) for f in p.rglob("*.otf"))
        return sorted(set(out))

    def get(self, path: str, size: int):
        key = (path, size)
        if key not in self._cache:
            if is_pseudo_path(path):
                self._cache[key] = load_pseudo_font(path, size)
            else:
                _, _, image_font = require_pillow(f"the font {path}")
                self._cache[key] = image_font.truetype(path, size)
        return self._cache[key]

    def _supports(self, path: str, probe: str) -> bool:
        """Tofu check: each probe char must render non-blank and differ from
        the .notdef box (detected as identical renders for distinct chars)."""
        try:
            font = self.get(path, 32)
        except Exception:
            return False
        renders = []
        for ch in probe:
            arr = np.zeros((64, 64), np.uint8)
            draw_text(arr, (4, 4), ch, 255, font)
            if arr.max() == 0:
                return False
            renders.append(arr)
        for i in range(len(renders) - 1):
            if np.array_equal(renders[i], renders[i + 1]):
                return False
        return True

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
    """Generates (image, label) pairs to an output directory with labels.txt;
    ``append`` continues the numbering of an existing labels file."""

    def __init__(self, output_dir: str, height: int = 48, augment: bool = True,
                 fonts: Optional[FontManager] = None, seed: int = 42,
                 fonts_dir: Optional[str] = None,
                 max_width: Optional[int] = None):
        self.out = Path(output_dir)
        (self.out / "images").mkdir(parents=True, exist_ok=True)
        if fonts is None and fonts_dir:
            require_pillow(f"--fonts-dir {fonts_dir}")
            fonts = FontManager(font_dirs=[fonts_dir] + list(_FONT_DIRS))
        self.fonts = fonts or FontManager()
        self.renderer = ImageRenderer(height=height, augment=augment)
        self.rng = random.Random(seed)
        #: Canvas-width cap: renders wider than this are aspect-resized down.
        self.max_width = max_width

    def _sample_line(self, min_words: int = 1, max_words: int = 8) -> str:
        """Text sampler hook; subclasses override for other scripts."""
        return sample_text(self.rng, min_words, max_words)

    def generate_dataset(self, num_samples: int,
                         texts: Optional[Sequence[str]] = None,
                         append: bool = False) -> str:
        labels_path = self.out / "labels.txt"
        existing = 0
        mode = "w"
        if append and labels_path.exists():
            existing = sum(1 for _ in labels_path.open(encoding="utf-8"))
            mode = "a"
        with labels_path.open(mode, encoding="utf-8") as f:
            for i in range(num_samples):
                text = (texts[i % len(texts)] if texts
                        else self._sample_line())
                sample = self.generate_one(text)
                if sample is None:
                    continue
                name = f"img_{existing + i:06d}.png"
                imwrite_png(self.out / "images" / name, sample)
                f.write(f"{name}\t{text}\n")
        return str(labels_path)

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
        return self._cap_width(img)

    def _cap_width(self, img: Optional[np.ndarray]) -> Optional[np.ndarray]:
        """Aspect-resize renders wider than ``max_width`` down to fit
        (Pillow's bilinear resize)."""
        if self.max_width and img is not None and img.shape[1] > self.max_width:
            h = max(1, int(img.shape[0] * self.max_width / img.shape[1]))
            img = pil_resize_bilinear(img, self.max_width, h)
        return img

    def generate_from_files(self, train_file, val_file=None,
                            train_augment: int = 1, val_augment: int = 1,
                            font_mode: str = "random",
                            random_augment: bool = False,
                            val_ratio: float = 0.1) -> str:
        """``<out>/train/{images,labels.txt}`` and ``<out>/val/...``, each
        source line rendered ``augment`` times. ``font_mode='all'`` renders
        every capable font per line instead of a random pick;
        ``random_augment`` re-rolls whether each copy is augmented. Without
        ``val_file`` the first ``val_ratio`` of the shuffled lines become
        the validation set."""
        lines = [l.strip() for l in
                 Path(train_file).read_text(encoding="utf-8").splitlines()
                 if l.strip()]
        if val_file:
            if not Path(val_file).exists():
                raise FileNotFoundError(f"val_file not found: {val_file}")
            val_lines = [l.strip() for l in
                         Path(val_file).read_text(encoding="utf-8").splitlines()
                         if l.strip()]
        else:
            shuffled = list(lines)
            self.rng.shuffle(shuffled)
            n_val = max(1, int(len(shuffled) * val_ratio))
            val_lines, lines = shuffled[:n_val], shuffled[n_val:]
        self._generate_split(self.out / "train", lines, train_augment,
                             font_mode, random_augment)
        self._generate_split(self.out / "val", val_lines, val_augment,
                             font_mode, random_augment)
        return str(self.out)

    def _generate_split(self, out_dir: Path, lines: Sequence[str],
                        augment_factor: int, font_mode: str,
                        random_augment: bool) -> None:
        (out_dir / "images").mkdir(parents=True, exist_ok=True)
        base_augment = self.renderer.augment
        i = 0
        try:
            with (out_dir / "labels.txt").open("w", encoding="utf-8") as f:
                for text in lines:
                    if font_mode == "all":
                        pool = ((self.fonts.khmer_fonts if _is_khmer(text)
                                 else self.fonts.english_fonts)
                                or self.fonts.font_paths)
                    else:
                        pool = [None]  # random pick per copy via generate_one
                    for _ in range(max(1, augment_factor)):
                        for fpath in pool:
                            if random_augment:
                                self.renderer.augment = self.rng.random() < 0.5
                            if fpath is None:
                                img = self.generate_one(text)
                            else:
                                try:
                                    font = self.fonts.get(
                                        fpath,
                                        self.rng.choice(self.fonts.sizes))
                                    img = self._cap_width(
                                        self.renderer.render(text, font,
                                                             self.rng))
                                except Exception:
                                    img = None
                            if img is None:
                                continue
                            name = f"img_{i:06d}.png"
                            imwrite_png(out_dir / "images" / name, img)
                            f.write(f"{name}\t{text}\n")
                            i += 1
        finally:
            self.renderer.augment = base_augment

    def generate_samples(self, num_samples: int,
                         texts: Optional[Sequence[str]] = None,
                         min_words: int = 1, max_words: int = 14,
                         max_width: Optional[int] = None
                         ) -> List[Dict[str, object]]:
        """In-memory samples for the trainer: [{image u8 [H, W'], text}].

        With ``max_width``, sampled lines whose render is wider are
        resampled (up to 6 tries) with a word budget cut by a third each
        time; if all are too wide the narrowest is kept. Caller-provided
        ``texts`` are never resampled.
        """
        out = []
        for i in range(num_samples):
            img = None
            text = ""
            best: Optional[Dict[str, object]] = None  # narrowest over-wide try
            budget = max_words
            for _ in range(6):
                text = (texts[i % len(texts)] if texts
                        else self._sample_line(min_words, budget))
                img = self.generate_one(text)
                if img is None:
                    break
                if (texts is not None or max_width is None
                        or img.shape[1] <= max_width):
                    break
                if best is None or img.shape[1] < best["image"].shape[1]:
                    best = {"image": img, "text": text}
                budget = max(min_words, budget * 2 // 3)
                img = None
            if img is not None:
                out.append({"image": img, "text": text})
            elif best is not None:
                out.append(best)
        return out


class MultilingualDatasetGenerator(DatasetGenerator):
    """Khmer + English mix. Khmer lines are produced only where the font
    pool holds a Khmer-capable font (the pseudo-glyph pool counts);
    otherwise output is English only, with a warning."""

    def __init__(self, *args, khmer_ratio: float = 0.5,
                 sign_boost: float = 0.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.khmer_ratio = khmer_ratio if self.fonts.khmer_fonts else 0.0
        #: Fraction of Khmer lines sampled diacritic-dense (vowel_p=0.75,
        #: sign_p=0.50), oversampling the above-base marks.
        self.sign_boost = sign_boost
        if khmer_ratio > 0 and not self.fonts.khmer_fonts:
            print("⚠ No Khmer-capable fonts found; generating English only.")

    def _sample_line(self, min_words: int = 1, max_words: int = 8) -> str:
        if self.rng.random() < self.khmer_ratio:
            if self.sign_boost and self.rng.random() < self.sign_boost:
                return sample_khmer_text(self.rng, min_words,
                                         max(2, max_words // 2),
                                         vowel_p=0.75, sign_p=0.50)
            return sample_khmer_text(self.rng, min_words,
                                     max(2, max_words // 2))
        return sample_text(self.rng, min_words, max_words)
