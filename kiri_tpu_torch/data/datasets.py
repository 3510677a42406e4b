"""Line datasets for training: ``labels.txt`` directories (the port of
``LineSampleSet`` and ``load_local_dataset`` of
``kiri_tpu/data/datasets.py``).

``labels.txt`` rows are ``<image name>\\t<text>``; an image is looked up in
``<dir>/images/`` and then ``<dir>/``. A sample is {"image": u8 [IMG_H,
IMG_W], "text"}: the line read as Pillow's ``convert("L")`` reads it
(``utils/imageio.imread_gray``), with ``augment`` stretched in width by a
factor in [0.75, 1.25] drawn from ``random.Random(seed)`` and resized with
Pillow's bilinear filter (``ops/imgproc.pil_resize_width_bilinear``), then
resize-padded to the model's input. Every step gives the JAX package's
bytes. HuggingFace datasets (``load_hf_dataset``) are not ported: they need
the ``datasets`` package and the network (ROADMAP.md, the tail).
"""
from __future__ import annotations

import random
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.imgproc import pil_gray, pil_resize_width_bilinear
from ..ops.preprocess import resize_keep_ratio_pad_np
from ..utils.imageio import imread_gray


class LineSampleSet:
    """Lazy list-like samples, loaded and preprocessed on access."""

    def __init__(self, records: Sequence[Tuple[object, str]], img_h: int = 48,
                 img_w: int = 640, augment: bool = False, seed: int = 42):
        self.records = list(records)
        self.img_h = img_h
        self.img_w = img_w
        self.augment = augment
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.records)

    def canonicalize(self, tok, verbose: bool = True) -> int:
        """Replace each label by ``tok.canonical_text`` once; returns (and
        prints, where the tokenizer reorders Khmer) how many changed."""
        changed = 0
        for i, (src, text) in enumerate(self.records):
            canon = tok.canonical_text(text)
            if canon != text:
                self.records[i] = (src, canon)
                changed += 1
        if verbose and tok.visual_order:
            print(f"🔤 {changed} of {len(self.records)} labels replaced by "
                  "their canonical cluster order")
        return changed

    @staticmethod
    def _load_gray(src) -> Optional[np.ndarray]:
        try:
            if isinstance(src, np.ndarray):
                if src.ndim == 3:
                    if src.shape[2] not in (3, 4):
                        raise ValueError(f"cannot read a line of shape "
                                         f"{src.shape}")
                    return pil_gray(src.astype(np.uint8))
                return src.astype(np.uint8)
            return imread_gray(src)
        except Exception as e:  # a blank sample on a read error, as kiri_tpu
            print(f"Error loading sample: {e}")
            return None

    def __getitem__(self, idx: int) -> Dict[str, object]:
        src, text = self.records[idx]
        img = self._load_gray(src)
        if img is None:
            return {"image": np.zeros((self.img_h, self.img_w), np.uint8),
                    "text": ""}
        if self.augment and img.shape[1] > 2:
            scale = self.rng.uniform(0.75, 1.25)
            img = pil_resize_width_bilinear(
                img, max(1, int(img.shape[1] * scale)))
        return {"image": resize_keep_ratio_pad_np(img, self.img_h, self.img_w),
                "text": text}


def load_local_dataset(labels_file, img_h: int = 48, img_w: int = 640,
                       augment: bool = False, tok=None) -> LineSampleSet:
    """The samples a ``labels.txt`` names; with ``tok``, the labels are
    canonicalized at load (``LineSampleSet.canonicalize``)."""
    labels_path = Path(labels_file)
    img_dirs = [labels_path.parent / "images", labels_path.parent]
    records: List[Tuple[object, str]] = []
    with open(labels_path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            name, text = parts[0], parts[1]
            for d in img_dirs:
                p = d / name
                if p.exists():
                    records.append((str(p), text))
                    break
    samples = LineSampleSet(records, img_h, img_w, augment)
    if tok is not None:
        samples.canonicalize(tok)
    return samples
