# Frozen copy of kiri_tpu_torch/data/pseudofont.py at commit
# 0bc739aac3bff3542a3b3238ea9226e557ccfdbd, for the benchmark's traffic and
# reference; later changes to the program do not reach it.
"""Procedural pseudo-glyph font: the port of ``kiri_tpu/data/pseudofont.py``.

Every codepoint gets a distinct, reproducible glyph (random-walk strokes on
a 5x5 lattice seeded by the codepoint and style; 16 structured templates for
the combining marks), and Khmer clusters are laid out as the script shapes
them: pre-base vowels before the base, coeng subscripts below it, marks
above, below and after. The generators draw Khmer with it where no Khmer
font is installed, and everything where no font is found at all.

The glyphs are drawn with ``ops/draw.py`` (Pillow's ``ImageDraw`` in numpy)
and the subscripts resized with Pillow's bilinear filter in numpy, so each
mask equals the JAX package's byte for byte without Pillow. ``render`` gives
the u8 mask of a text; ``getmask`` hands it to Pillow's ``ImageDraw.text``
(the result renderer) and needs Pillow.
"""
from __future__ import annotations

import importlib
import random
from typing import Dict, List, Tuple

import numpy as np

from .draw import Draw
from .imgproc import pil_resize_bilinear

PSEUDO_SCHEME = "pseudo://khmer/"
N_STYLES = 4

_KH = 0x1780
# Khmer block classification (U+1780..U+17FF):
_CONS_END = 0x17A2          # consonants 1780..17A2 -> full base glyphs
_INDEP_END = 0x17B3         # independent vowels 17A3..17B3 -> base glyphs
_INVISIBLE = {0x17B4, 0x17B5}   # KIV AQ/AA: invisible combining, skip
_RIGHT_MARKS = {0x17B6, 0x17C7, 0x17C8}          # spacing right vowels/signs
_ABOVE_MARKS = ({0x17B7, 0x17B8, 0x17B9, 0x17BA, 0x17C6} |
                set(range(0x17C9, 0x17D2)) | {0x17D3, 0x17DD})
_BELOW_MARKS = {0x17BB, 0x17BC, 0x17BD, 0x17D2}  # incl. coeng as below mark
_TWO_PART = set(range(0x17BE, 0x17C6))           # e/ae/ai/o/au etc. -> right
_COENG = 0x17D2
# Real Khmer shaping behaviors: the vowels E/AE/AI render
# entirely BEFORE their base consonant (visual reordering), and the other
# two-part vowels render a shared e-like left part before the base plus a
# second part above or after it (matching how real fonts decompose them).
_PREBASE_FULL = {0x17C1, 0x17C2, 0x17C3}         # e, ae, ai
_PREBASE_SPLIT = {0x17BE: "above",               # oe  = e + above part
                  0x17BF: "right",               # ya  = e + right part
                  0x17C0: "right",               # ie  = e + right part
                  0x17C4: "right",               # o   = e + right part
                  0x17C5: "right"}               # au  = e + right part
# Marks that extend a cluster during layout scanning (dependent vowels,
# signs, the invisible combiners) — everything between a base and the next
# base/space except COENG, which is handled explicitly.
_CLUSTER_EXTEND = set(range(0x17B4, 0x17D2)) | {0x17D3, 0x17DD}


def _khmer_class(cp: int) -> str:
    """'base' | 'above' | 'below' | 'right' | 'skip' for Khmer codepoints,
    'base' for everything else printable."""
    if cp in _INVISIBLE:
        return "skip"
    if cp in _ABOVE_MARKS:
        return "above"
    if cp in _BELOW_MARKS:
        return "below"
    if cp in _RIGHT_MARKS or cp in _TWO_PART:
        return "right"
    return "base"


class PseudoGlyphFont:
    """Deterministic procedural font. One instance per (style, size)."""

    def __init__(self, size: int, style: int = 0):
        self.size = int(size)
        self.style = int(style) % N_STYLES
        s = self.size
        # Vertical metrics (all relative to the line origin at y=0).
        self._above_y = 0
        self._body_y = round(0.26 * s)
        self._body_h = round(0.72 * s)
        self._below_y = self._body_y + self._body_h + max(1, round(0.03 * s))
        self._height = self._below_y + round(0.26 * s)
        self._adv_base = round(0.68 * s)
        self._adv_right = round(0.42 * s)
        self._adv_space = round(0.52 * s)
        self._glyphs: Dict[Tuple[int, str], np.ndarray] = {}

    # ------------------------------------------------------------- metrics
    def _advances(self, text: str) -> List[int]:
        """Per-codepoint advance widths (shaping-aware: a consonant after
        COENG is a zero-advance subscript; pre-base/two-part vowels carry
        the advance of their visible parts)."""
        out = []
        prev_coeng = False
        for ch in text:
            cp = ord(ch)
            if ch == " " or ch == " ":
                out.append(self._adv_space)
                prev_coeng = False
                continue
            if cp == _COENG:
                out.append(0)
                prev_coeng = True
                continue
            cls = _khmer_class(cp)
            if cls == "base":
                out.append(0 if prev_coeng else self._adv_base)
            elif cp in _PREBASE_FULL:
                out.append(self._adv_right)
            elif cp in _PREBASE_SPLIT:
                out.append(self._adv_right * 2
                           if _PREBASE_SPLIT[cp] == "right"
                           else self._adv_right)
            elif cls == "right":
                out.append(self._adv_right)
            else:  # above/below/skip: zero-advance combining
                out.append(0)
            prev_coeng = False
        return out

    def getlength(self, text: str, *args, **kwargs) -> int:
        return sum(self._advances(text))

    def getbbox(self, text: str, *args, **kwargs):
        """(left, top, right, bottom) with origin at the layout top-left,
        mirroring FreeTypeFont.getbbox usage in the generators."""
        return (0, 0, self.getlength(text), self._height)

    # ------------------------------------------------------------- glyphs
    def _glyph(self, cp: int, cls: str) -> np.ndarray:
        """White-on-black uint8 mask for one codepoint, cached."""
        key = (cp, cls)
        got = self._glyphs.get(key)
        if got is not None:
            return got
        s = self.size
        if cls == "base":
            w, h = max(3, round(0.60 * s)), self._body_h
            n_seg = 6
        elif cls == "right":
            w, h = max(2, round(0.34 * s)), self._body_h
            n_seg = 5
        else:  # above / below diacritics
            w, h = max(4, round(0.50 * s)), max(3, round(0.30 * s))
            n_seg = 3
        rng = random.Random((cp << 4) | self.style)
        stroke = max(1, round(s * (0.055 + 0.012 * self.style)))
        if cls in ("above", "below"):
            # Marks are too small for random-walk strokes to stay visually
            # distinct — each mark codepoint gets a unique structured template instead.
            arr = self._mark_template(cp, cls, w, h, stroke)
            self._glyphs[key] = arr
            return arr
        arr = np.zeros((h, w), np.uint8)
        draw = Draw(arr)
        # Random walk over a 5x5 lattice: connected strokes, distinct and
        # reproducible per codepoint.
        lat = [(round(x * (w - 1) / 4), round(y * (h - 1) / 4))
               for y in range(5) for x in range(5)]
        pt = rng.choice(lat)
        for _ in range(n_seg + rng.randint(0, 2)):
            nxt = rng.choice(lat)
            while nxt == pt:
                nxt = rng.choice(lat)
            draw.line([pt, nxt], fill=255, width=stroke)
            pt = nxt
        # Khmer glyphs are loopy: add a deterministic ellipse element.
        if cls == "base" and rng.random() < 0.6:
            cx, cy = rng.randint(0, max(0, w - 4)), rng.randint(0, max(0, h - 4))
            rw = rng.randint(3, max(4, w // 2))
            rh = rng.randint(3, max(4, h // 2))
            draw.ellipse([cx, cy, min(w - 1, cx + rw), min(h - 1, cy + rh)],
                         outline=255, width=stroke)
        # Slant shear per style (cheap italic-like variety).
        if self.style >= 2 and h > 2:
            shift = (np.arange(h) * (0.12 * (self.style - 1)) *
                     (s / max(1, h))).astype(int)
            sheared = np.zeros((h, w + int(shift.max()) + 1), np.uint8)
            for row in range(h):
                sheared[row, shift[row]:shift[row] + w] = arr[row]
            arr = sheared[:, :w] if sheared.shape[1] > w else sheared
        self._glyphs[key] = arr
        return arr

    def _mark_template(self, cp: int, cls: str, w: int, h: int,
                       stroke: int) -> np.ndarray:
        """Distinct structured glyph for a combining mark: the codepoint's
        rank within its class picks one of 16 templates (dot, bars, arcs,
        zigzag, cross, ...), so every mark differs by *shape*, not by the
        luck of a random walk."""
        order = sorted(_ABOVE_MARKS if cls == "above" else _BELOW_MARKS)
        idx = order.index(cp) if cp in order else cp % 16
        arr = np.zeros((h, w), np.uint8)
        d = Draw(arr)
        x1, y1 = w - 1, h - 1
        cx, cy = w // 2, h // 2
        r = max(1, min(w, h) // 3)
        t = idx % 16
        if t == 0:      # filled dot
            d.ellipse([cx - r, cy - r, cx + r, cy + r], fill=255)
        elif t == 1:    # two dots horizontal
            rr = max(1, r - 1)
            d.ellipse([2, cy - rr, 2 + 2 * rr, cy + rr], fill=255)
            d.ellipse([x1 - 2 - 2 * rr, cy - rr, x1 - 2, cy + rr], fill=255)
        elif t == 2:    # horizontal bar
            d.line([0, cy, x1, cy], fill=255, width=stroke)
        elif t == 3:    # vertical bar
            d.line([cx, 0, cx, y1], fill=255, width=stroke)
        elif t == 4:    # circle outline
            d.ellipse([cx - r, cy - r, cx + r, cy + r], outline=255,
                      width=max(1, stroke - 1))
        elif t == 5:    # zigzag
            d.line([0, y1, w // 3, 0, 2 * w // 3, y1, x1, 0], fill=255,
                   width=stroke)
        elif t == 6:    # arc opening down
            d.arc([0, 0, x1, 2 * h], 180, 360, fill=255, width=stroke)
        elif t == 7:    # arc opening up
            d.arc([0, -h, x1, y1], 0, 180, fill=255, width=stroke)
        elif t == 8:    # triangle outline
            d.polygon([cx, 0, x1, y1, 0, y1], outline=255)
        elif t == 9:    # X cross
            d.line([0, 0, x1, y1], fill=255, width=stroke)
            d.line([0, y1, x1, 0], fill=255, width=stroke)
        elif t == 10:   # plus
            d.line([cx, 0, cx, y1], fill=255, width=stroke)
            d.line([0, cy, x1, cy], fill=255, width=stroke)
        elif t == 11:   # tilde wave
            d.line([0, cy, w // 4, 0, 3 * w // 4, y1, x1, cy], fill=255,
                   width=stroke)
        elif t == 12:   # filled square
            d.rectangle([cx - r, cy - r, cx + r, cy + r], fill=255)
        elif t == 13:   # two dots vertical
            rr = max(1, r - 1)
            d.ellipse([cx - rr, 0, cx + rr, 2 * rr], fill=255)
            d.ellipse([cx - rr, y1 - 2 * rr, cx + rr, y1], fill=255)
        elif t == 14:   # L corner
            d.line([0, 0, 0, y1], fill=255, width=stroke)
            d.line([0, y1, x1, y1], fill=255, width=stroke)
        else:           # hook: slash + dot
            d.line([0, y1, x1, 0], fill=255, width=stroke)
            d.ellipse([x1 - 2 * r, y1 - 2 * r, x1, y1], fill=255)
        return arr

    def _subscript_glyph(self, cp: int) -> np.ndarray:
        """Coeng form of a consonant: its base glyph scaled into the
        below-base slot (real Khmer renders COENG + consonant as a smaller
        subscript hanging under the base, not as a second full letter)."""
        key = (cp, "sub")
        got = self._glyphs.get(key)
        if got is not None:
            return got
        g = self._glyph(cp, "base")
        h = max(3, self._height - self._below_y - 1)
        w = max(3, round(g.shape[1] * 0.55))
        img = pil_resize_bilinear(g, w, h)
        arr = ((img.astype(np.float32) > 48) * 255).astype(np.uint8)
        self._glyphs[key] = arr
        return arr

    def _layout_cluster(self, cluster: str, pen: int):
        """Place one orthographic cluster starting at x=``pen``.

        Order of operations mirrors real shaping: pre-base vowel parts
        first (E/AE/AI fully pre-base; other two-part vowels contribute a
        shared e-like left part), then the base, subscript (coeng)
        consonants below, above/below marks, and post-base parts.
        Returns (new_pen, placements, (base_x, base_adv)).
        """
        base_cp = ord(cluster[0])
        subs: List[int] = []
        above: List[int] = []
        below: List[int] = []
        right: List[int] = []
        prebase: List[int] = []
        k = 1
        while k < len(cluster):
            cp = ord(cluster[k])
            if cp == _COENG:
                if (k + 1 < len(cluster)
                        and _khmer_class(ord(cluster[k + 1])) == "base"):
                    subs.append(ord(cluster[k + 1]))
                    k += 2
                    continue
                below.append(cp)  # dangling coeng: legacy mark form
            elif cp in _PREBASE_FULL:
                prebase.append(cp)
            elif cp in _PREBASE_SPLIT:
                prebase.append(0x17C1)  # shared e-like left part
                if _PREBASE_SPLIT[cp] == "above":
                    above.append(cp)
                else:
                    right.append(cp)
            else:
                cls = _khmer_class(cp)
                if cls == "above":
                    above.append(cp)
                elif cls == "below":
                    below.append(cp)
                elif cls == "right":
                    right.append(cp)
                # skip-class: invisible
            k += 1
        placements: List[Tuple[np.ndarray, int, int]] = []
        for cp in prebase:
            g = self._glyph(cp, "right")
            placements.append((g, pen + 1, self._body_y))
            pen += self._adv_right
        bx = pen
        g = self._glyph(base_cp, "base")
        placements.append(
            (g, pen + max(0, (self._adv_base - g.shape[1]) // 2),
             self._body_y))
        pen += self._adv_base
        n_below = 0
        for cp in subs:
            g = self._subscript_glyph(cp)
            x = (bx + max(0, (self._adv_base - g.shape[1]) // 2)
                 + n_below * (g.shape[1] // 2))
            placements.append((g, x, self._below_y))
            n_below += 1
        for cp in below:
            g = self._glyph(cp, "below")
            x = (bx + max(0, (self._adv_base - g.shape[1]) // 2)
                 + n_below * (g.shape[1] // 3))
            placements.append((g, x, self._below_y))
            n_below += 1
        n_above = 0
        for cp in above:
            g = self._glyph(cp, "above")
            x = (bx + max(0, (self._adv_base - g.shape[1]) // 2)
                 + n_above * (g.shape[1] // 3))
            placements.append((g, x, self._above_y))
            n_above += 1
        for cp in right:
            g = self._glyph(cp, "right")
            placements.append((g, pen + 1, self._body_y))
            pen += self._adv_right
        return pen, placements, (bx, self._adv_base)

    # ------------------------------------------------------------ rendering
    def render(self, text: str) -> np.ndarray:
        """Render to a white-on-black uint8 [H, W] mask with cluster layout
        (coeng subscripts below the base, pre-base vowels reordered to the
        left of it — the two real-font shaping behaviors the recognizer
        must learn)."""
        placements: List[Tuple[np.ndarray, int, int]] = []
        pen = 0
        last_base = (0, self._adv_base)  # (x, w) of last base glyph
        n_above = n_below = 0
        i, n = 0, len(text)
        while i < n:
            ch = text[i]
            cp = ord(ch)
            if ch in (" ", " "):
                pen += self._adv_space
                last_base = (pen, self._adv_base)
                n_above = n_below = 0
                i += 1
                continue
            cls = _khmer_class(cp)
            if cls == "skip":
                i += 1
                continue
            if cls == "base":
                # Scan the full orthographic cluster and lay it out.
                j = i + 1
                while j < n:
                    cpj = ord(text[j])
                    if (cpj == _COENG and j + 1 < n
                            and _khmer_class(ord(text[j + 1])) == "base"):
                        j += 2
                    elif cpj == _COENG or cpj in _CLUSTER_EXTEND:
                        j += 1
                    else:
                        break
                pen, pls, last_base = self._layout_cluster(text[i:j], pen)
                placements.extend(pls)
                n_above = n_below = 0
                i = j
                continue
            # Stray combining mark with no preceding base in this run
            # (malformed text): legacy placement against the last base slot.
            g = self._glyph(cp, cls)
            gh, gw = g.shape
            if cls == "right":
                x, y = pen + 1, self._body_y
                pen += self._adv_right
            elif cls == "above":
                bx, bw = last_base
                x = bx + max(0, (bw - gw) // 2) + n_above * (gw // 3)
                y = self._above_y
                n_above += 1
            else:  # below
                bx, bw = last_base
                x = bx + max(0, (bw - gw) // 2) + n_below * (gw // 3)
                y = self._below_y
                n_below += 1
            placements.append((g, x, y))
            i += 1
        # Canvas covers the full advance width plus any overhanging mark
        # (an isolated combining mark has zero advance but visible ink).
        width = max(1, self.getlength(text),
                    *(x + g.shape[1] for g, x, _ in placements or
                      [(np.zeros((1, 1), np.uint8), 0, 0)]))
        canvas = np.zeros((self._height, width), np.uint8)
        for g, x, y in placements:
            gh, gw = g.shape
            x0, y0 = max(0, x), max(0, y)
            x1 = min(width, x + gw)
            y1 = min(self._height, y + gh)
            if x1 > x0 and y1 > y0:
                np.maximum(canvas[y0:y1, x0:x1],
                           g[: y1 - y0, : x1 - x0],
                           out=canvas[y0:y1, x0:x1])
        return canvas

    def getmask(self, text: str, mode: str = "", *args, **kwargs):
        """``ImageDraw.text``'s protocol: the mask as Pillow's core image
        (Pillow is imported here, for the callers that draw with it)."""
        image = importlib.import_module("PIL.Image")
        arr = self.render(text)
        img = image.fromarray(arr, "L")
        if mode == "1":
            img = img.point(lambda v: 255 if v >= 128 else 0)
        return img.im


def is_pseudo_path(path: str) -> bool:
    return isinstance(path, str) and path.startswith(PSEUDO_SCHEME)


def pseudo_font_paths() -> List[str]:
    """Virtual 'font file paths' for the pseudo-Khmer style pool."""
    return [f"{PSEUDO_SCHEME}{k}" for k in range(N_STYLES)]


def load_pseudo_font(path: str, size: int) -> PseudoGlyphFont:
    style = int(path[len(PSEUDO_SCHEME):] or 0)
    return PseudoGlyphFont(size, style)
