"""Detector training data that needs no text rasterizer: the parts of
``kiri_tpu/data/docsynth.py`` that are numpy.

``db_ground_truth`` (shrunk probability mask and threshold band),
``craft_ground_truth`` (Gaussian region and affinity maps) and
``load_detector_batches``, which reads a ``generate-detector`` directory
(``images/*.png``, ``gt/*.npy``, ``annotations.json``). The document
generator itself draws text with PIL and waits for the generators item of
``ROADMAP.md``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..utils.imageio import imread_gray


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
