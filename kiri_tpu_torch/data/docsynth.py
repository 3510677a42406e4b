"""Synthetic multi-line documents with detection ground truth: the port of
``kiri_tpu/data/docsynth.py``.

``DocumentGenerator`` renders documents in six layouts with per-line and
per-character boxes; ``apply_condition`` degrades one (rotated, noisy,
inverted, textured, low contrast) with its boxes moved alike; ``rescale_doc``
resizes one; ``db_ground_truth`` (shrunk probability mask and threshold
band) and ``craft_ground_truth`` (Gaussian region and affinity maps) are
the detectors' targets; ``generate_detector_dataset`` writes a
``generate-detector`` directory (``images/*.png``, ``gt/*.npy``,
``annotations.json``) and ``load_detector_batches`` reads one back.

Every random draw and numpy expression is the JAX package's, in its order,
so the same seed gives the same documents byte for byte; text is drawn as
``synth.draw_text`` draws it, the rotation and resize are Pillow's in numpy
(``ops/imgproc.py``).
"""
from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.imgproc import pil_resize_bilinear, rotate_bilinear
from ..utils.imageio import imread_gray, imwrite_png
from .synth import FontManager, draw_text, sample_khmer_text, sample_text

LAYOUTS = ("single_column", "two_column", "title_paragraph", "sparse",
           "dense", "mixed_sizes")
_LAYOUT_WEIGHTS = (0.3, 0.15, 0.2, 0.1, 0.15, 0.1)


CONDITIONS = ("clean", "rotated", "noisy", "inverted", "textured",
              "low_contrast")


def apply_condition(doc: Dict[str, object], condition: str,
                    rng: random.Random) -> Dict[str, object]:
    """Degrade a generated document for robustness evaluation.

    Returns a new doc dict with the image and (for "rotated") the line and
    character boxes transformed alike. ``rng`` gives ``getrandbits(32)``
    (the numpy generator's seed) before the condition is chosen, then the
    condition's own draws, in the JAX package's order and numpy dtypes.
    """
    img = np.asarray(doc["image"], np.uint8)
    lines = list(doc["lines"])
    chars = [list(c) for c in doc["chars"]]
    nprng = np.random.default_rng(rng.getrandbits(32))

    if condition == "clean":
        pass
    elif condition == "rotated":
        angle = rng.uniform(2.0, 6.0) * (1 if rng.random() < 0.5 else -1)
        bg = int(np.median(img))
        img = rotate_bilinear(img, angle, bg)
        h, w = img.shape
        # Pillow's rotate(+a) moves content about the centre, y down, as
        # p' = (x cos a + y sin a, -x sin a + y cos a).
        th = np.deg2rad(angle)
        c, s = np.cos(th), np.sin(th)
        cx, cy = (w - 1) / 2, (h - 1) / 2

        def rot_box(b):
            x, y, bw, bh = b
            pts = np.array([[x, y], [x + bw, y], [x, y + bh],
                            [x + bw, y + bh]], float) - (cx, cy)
            pts = pts @ np.array([[c, -s], [s, c]]) + (cx, cy)
            x0, y0 = pts.min(0)
            x1, y1 = pts.max(0)
            return (int(round(x0)), int(round(y0)),
                    int(round(x1 - x0)), int(round(y1 - y0)))

        lines = [rot_box(b) for b in lines]
        chars = [[rot_box(b) for b in row] for row in chars]
    elif condition == "noisy":
        sigma = rng.uniform(14, 26)
        noisy = img.astype(np.float32) + nprng.normal(0, sigma, img.shape)
        # salt & pepper speckle
        mask = nprng.random(img.shape)
        noisy[mask < 0.002] = 0
        noisy[mask > 0.998] = 255
        img = np.clip(noisy, 0, 255).astype(np.uint8)
    elif condition == "inverted":
        img = (255 - img).astype(np.uint8)
    elif condition == "textured":
        h, w = img.shape
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        fx, fy = rng.uniform(1.5, 4.0), rng.uniform(1.5, 4.0)
        ph1, ph2 = rng.uniform(0, 6.28), rng.uniform(0, 6.28)
        tex = (np.sin(xx / w * fx * 6.28 + ph1)
               + np.sin(yy / h * fy * 6.28 + ph2)) * rng.uniform(6, 14)
        grad = (xx / w - 0.5) * rng.uniform(-30, 30)
        out = img.astype(np.float32) + tex + grad
        for _ in range(rng.randint(2, 5)):  # light blotches
            bx, by = rng.randint(0, w - 1), rng.randint(0, h - 1)
            r = rng.randint(40, 120)
            d2 = (xx - bx) ** 2 + (yy - by) ** 2
            out -= np.exp(-d2 / (2 * r * r)) * rng.uniform(10, 25)
        img = np.clip(out, 0, 255).astype(np.uint8)
    elif condition == "low_contrast":
        lo, hi = rng.uniform(70, 110), rng.uniform(170, 210)
        img = (img.astype(np.float32) / 255.0 * (hi - lo) + lo
               ).astype(np.uint8)
    else:
        raise ValueError(f"unknown condition {condition!r}")

    out_doc = dict(doc)
    out_doc.update(image=img, lines=lines, chars=chars,
                   condition=condition)
    return out_doc


def rescale_doc(doc: Dict[str, object], target_h: int,
                target_w: int) -> Dict[str, object]:
    """Rescale a document (Pillow's bilinear resize) and its line and
    character boxes: multi-scale detector training, text at the scales a
    magnifying serving path presents."""
    img = np.asarray(doc["image"], np.uint8)
    h, w = img.shape[:2]
    if (h, w) == (target_h, target_w):
        return dict(doc)
    fy, fx = target_h / h, target_w / w

    def scale_box(b):
        x, y, bw, bh = b
        return (int(round(x * fx)), int(round(y * fy)),
                max(1, int(round(bw * fx))), max(1, int(round(bh * fy))))

    out = dict(doc)
    out.update(image=pil_resize_bilinear(img, target_w, target_h),
               lines=[scale_box(b) for b in doc["lines"]],
               chars=[[scale_box(b) for b in row] for row in doc["chars"]])
    return out


class DocumentGenerator:
    """Renders synthetic documents and their detection ground truth."""

    def __init__(self, width: int = 640, height: int = 640,
                 fonts: Optional[FontManager] = None, seed: int = 42,
                 augment: bool = True, khmer_ratio: float = 0.0,
                 texts: Optional[Sequence[str]] = None):
        self.width = width
        self.height = height
        self.fonts = fonts or FontManager(sizes=(18, 22, 26, 30, 34))
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


def db_ground_truth(shape: Tuple[int, int],
                    boxes: Sequence[Tuple[int, int, int, int]],
                    shrink_ratio: float = 0.6
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (prob_gt [H,W] f32 0/1, thresh_gt [H,W] f32, thresh_mask).

    prob_gt: text boxes shrunk by the DB offset d = area(1-r^2)/perimeter.
    thresh_gt: normalized distance-to-box-edge inside the [shrunk, expanded]
    border band (standard DB formulation).

    r = 0.6, gentler than canonical DB's 0.4, as in the JAX package (small
    text would shrink to strips the detector's size filter drops).
    """
    h, w = shape
    prob = np.zeros((h, w), np.float32)
    thresh = np.zeros((h, w), np.float32)
    tmask = np.zeros((h, w), np.float32)
    for (x, y, bw, bh) in boxes:
        if bw < 2 or bh < 2:
            continue
        area = bw * bh
        perim = 2 * (bw + bh)
        d = area * (1 - shrink_ratio ** 2) / perim
        d = min(d, bw / 2 - 1, bh / 2 - 1)
        d = max(d, 0.0)
        # Shrunk rectangle -> positive prob region.
        sx0 = int(round(x + d))
        sy0 = int(round(y + d))
        sx1 = int(round(x + bw - d))
        sy1 = int(round(y + bh - d))
        sx0, sy0 = max(0, sx0), max(0, sy0)
        sx1, sy1 = min(w, sx1), min(h, sy1)
        if sx1 > sx0 and sy1 > sy0:
            prob[sy0:sy1, sx0:sx1] = 1.0
        # Threshold band: [x-d, x+bw+d] minus the shrunk box; value =
        # 1 - dist_to_original_edge / d.
        ex0 = max(0, int(np.floor(x - d)))
        ey0 = max(0, int(np.floor(y - d)))
        ex1 = min(w, int(np.ceil(x + bw + d)))
        ey1 = min(h, int(np.ceil(y + bh + d)))
        if ex1 <= ex0 or ey1 <= ey0 or d <= 0:
            continue
        ys = np.arange(ey0, ey1)[:, None]
        xs = np.arange(ex0, ex1)[None, :]
        # Signed distance to the original rectangle boundary (positive
        # outside, negative inside).
        dx = np.maximum(np.maximum(x - xs, xs - (x + bw)), 0)
        dy = np.maximum(np.maximum(y - ys, ys - (y + bh)), 0)
        outside = np.hypot(dx, dy)
        inside = np.minimum(np.minimum(xs - x, (x + bw) - xs),
                            np.minimum(ys - y, (y + bh) - ys))
        dist = np.where(outside > 0, outside, -np.maximum(inside, 0))
        val = np.clip(1.0 - np.abs(dist) / d, 0.0, 1.0)
        region = thresh[ey0:ey1, ex0:ex1]
        np.maximum(region, val, out=region)
        tmask[ey0:ey1, ex0:ex1] = 1.0
    return prob, thresh, tmask


# ---------------------------------------------------------------------------
# CRAFT ground truth: Gaussian region + affinity maps
# ---------------------------------------------------------------------------
def _gaussian_patch(h: int, w: int) -> np.ndarray:
    """2D Gaussian peaking at the center, sigma 0.5 over [-1, 1]."""
    if h < 1 or w < 1:
        return np.zeros((max(h, 1), max(w, 1)), np.float32)
    ys = np.linspace(-1.0, 1.0, h)[:, None]
    xs = np.linspace(-1.0, 1.0, w)[None, :]
    sigma = 0.5
    return np.exp(-(xs ** 2 + ys ** 2) / (2 * sigma ** 2)).astype(np.float32)


def craft_ground_truth(shape: Tuple[int, int],
                       char_boxes: Sequence[Sequence[Tuple[int, int, int, int]]]
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (region_map, affinity_map), each [H, W] f32 in [0, 1].

    region: a Gaussian per character box; affinity: a Gaussian over the gap
    between the centres of adjacent characters of a line.
    """
    h, w = shape
    region = np.zeros((h, w), np.float32)
    affinity = np.zeros((h, w), np.float32)

    def stamp(target, x, y, bw, bh):
        x0, y0 = max(0, int(x)), max(0, int(y))
        x1, y1 = min(w, int(x + bw)), min(h, int(y + bh))
        if x1 <= x0 or y1 <= y0:
            return
        g = _gaussian_patch(y1 - y0, x1 - x0)
        np.maximum(target[y0:y1, x0:x1], g, out=target[y0:y1, x0:x1])

    for line in char_boxes:
        for (x, y, bw, bh) in line:
            stamp(region, x, y, bw, bh)
        for a, b in zip(line, line[1:]):
            ax, ay, aw, ah = a
            bx, by, bw2, bh2 = b
            # Affinity box spans the gap between consecutive char centers.
            x0 = ax + aw / 2
            x1 = bx + bw2 / 2
            y0 = min(ay, by)
            y1 = max(ay + ah, by + bh2)
            if x1 > x0:
                stamp(affinity, x0, y0, x1 - x0, y1 - y0)
    return region, affinity


def generate_detector_dataset(output_dir: str, num_samples: int,
                              width: int = 640, height: int = 640,
                              seed: int = 42, kind: str = "both",
                              khmer_ratio: float = 0.0,
                              texts: Optional[Sequence[str]] = None,
                              min_lines: Optional[int] = None,
                              max_lines: Optional[int] = None,
                              augment: bool = True,
                              fonts: Optional[FontManager] = None) -> str:
    """Writes images/, annotations.json with line + char boxes, and .npy GT
    maps for the requested detector kind ('db' | 'craft' | 'both').

    Lines come from ``texts`` when given, and a document is regenerated (up
    to 8 times, dense when too sparse, else sparse) until its line count
    falls within [min_lines, max_lines]."""
    out = Path(output_dir)
    (out / "images").mkdir(parents=True, exist_ok=True)
    (out / "gt").mkdir(exist_ok=True)
    gen = DocumentGenerator(width, height, seed=seed, khmer_ratio=khmer_ratio,
                            texts=texts, augment=augment, fonts=fonts)
    annotations = []
    for i in range(num_samples):
        doc = gen.generate()
        for _ in range(8):
            n = len(doc["lines"])
            if ((min_lines is None or n >= min_lines)
                    and (max_lines is None or n <= max_lines)):
                break
            # Too sparse -> force the dense layout; too crowded -> sparse.
            doc = gen.generate(layout="dense" if (min_lines and n < min_lines)
                               else "sparse")
        name = f"doc_{i:05d}.png"
        imwrite_png(out / "images" / name, doc["image"])
        annotations.append({"image": name, "lines": doc["lines"],
                            "texts": doc["texts"], "chars": doc["chars"],
                            "layout": doc["layout"]})
        if kind in ("db", "both"):
            prob, thr, tm = db_ground_truth(doc["image"].shape, doc["lines"])
            np.save(out / "gt" / f"{name}.db_prob.npy", prob)
            np.save(out / "gt" / f"{name}.db_thresh.npy", thr)
            np.save(out / "gt" / f"{name}.db_tmask.npy", tm)
        if kind in ("craft", "both"):
            region, affinity = craft_ground_truth(doc["image"].shape,
                                                  doc["chars"])
            np.save(out / "gt" / f"{name}.region.npy", region)
            np.save(out / "gt" / f"{name}.affinity.npy", affinity)
    (out / "annotations.json").write_text(json.dumps(annotations))
    return str(out / "annotations.json")


def dataset_root(data_dir) -> Path:
    """The directory holding ``annotations.json``: ``data_dir`` (or the
    directory of a ``data.yaml``-style file given instead), else its
    ``train/``."""
    root = Path(data_dir)
    if root.suffix in (".yaml", ".yml", ".json"):
        root = root.parent
    for cand in (root, root / "train"):
        if (cand / "annotations.json").exists():
            return cand
    raise FileNotFoundError(f"no annotations.json under {data_dir}")


def load_detector_batches(data_dir, kind: str,
                          batch_size: int) -> List[Dict[str, np.ndarray]]:
    """Training batches from a ``generate_detector_dataset`` directory.

    ``data_dir`` is the dataset root, a ``data.yaml``-style file inside it,
    or its parent with a ``train/`` directory. Every image and its ``.npy``
    maps are loaded once; the last batch wraps around to the first samples.
    Images are read as Pillow's ``convert("L")`` reads them.
    """
    root = dataset_root(data_dir)
    ann = json.loads((root / "annotations.json").read_text())
    items: List[Dict[str, np.ndarray]] = []
    for rec in ann:
        name = rec["image"]
        img = imread_gray(root / "images" / name).astype(np.float32)
        x = ((img / 255.0 - 0.5) / 0.5)[..., None]
        if kind == "db":
            items.append({
                "image": x,
                "prob_gt": np.load(root / "gt" / f"{name}.db_prob.npy"),
                "thresh_gt": np.load(root / "gt" / f"{name}.db_thresh.npy"),
                "tmask": np.load(root / "gt" / f"{name}.db_tmask.npy")})
        else:
            region = np.load(root / "gt" / f"{name}.region.npy")
            aff = np.load(root / "gt" / f"{name}.affinity.npy")
            # CRAFT supervises at half resolution (craft/train.py:95-97).
            items.append({"image": x, "region_gt": region[::2, ::2],
                          "affinity_gt": aff[::2, ::2]})
    if not items:
        raise ValueError(f"empty detector dataset at {data_dir}")
    batches = []
    for s in range(0, len(items), batch_size):
        chunk = items[s: s + batch_size]
        while len(chunk) < batch_size:  # wrap remainder
            chunk.append(items[(s + len(chunk)) % len(items)])
        batches.append({k: np.stack([it[k] for it in chunk])
                        for k in chunk[0]})
    return batches
