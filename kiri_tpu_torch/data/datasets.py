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
bytes.

HuggingFace datasets (``load_hf_dataset``): a hub id or a local directory
through ``datasets.load_dataset`` (imported inside, so the package imports
without it). The image column is read undecoded (``datasets.Image(decode=
False)``) and its bytes go through the port's own PNG reader, other
formats through PIL where it imports: the same grey bytes as the JAX
package's Pillow ``convert("L")``.
"""
from __future__ import annotations

import random
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.imgproc import pil_gray, pil_resize_width_bilinear
from ..ops.preprocess import resize_keep_ratio_pad_np
from ..utils.imageio import decode_gray, imread_gray


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
            if isinstance(src, dict):           # an undecoded HF image
                if src.get("bytes") is not None:
                    return decode_gray(src["bytes"], str(src.get("path")))
                return imread_gray(src["path"])
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


def load_hf_dataset(names: Sequence[str], image_col: str = "image",
                    text_col: str = "text", img_h: int = 48, img_w: int = 640,
                    augment: bool = False, val_ratio: float = 0.05,
                    seed: int = 42, subset: Optional[str] = None,
                    train_split: str = "train",
                    val_split: Optional[str] = None,
                    streaming: bool = False
                    ) -> Tuple[LineSampleSet, LineSampleSet]:
    """(train, val) sample sets of HF datasets, concatenated, with the JAX
    package's choices: the validation split is ``val_split``, else
    "validation", "val" or "test", the first that loads; without one, a
    seeded split of the train split (``train_test_split(test_size=
    val_ratio, seed=seed)``, or with ``streaming`` the stream drained into
    a list and cut by a ``random.Random(seed)`` shuffle). ``streaming``
    loads with ``streaming=True`` and drains each stream into records."""
    from datasets import Image, concatenate_datasets, load_dataset

    def _load(name, split):
        ds = load_dataset(name, subset, split=split, streaming=streaming)
        features = getattr(ds, "features", None) or {}
        if isinstance(features.get(image_col), Image):
            ds = ds.cast_column(image_col, Image(decode=False))
        if streaming:
            # Batching needs random access and a length: drain the stream.
            return [dict(row) for row in ds]
        return ds

    trains, vals = [], []
    for name in names:
        trains.append(_load(name, train_split))
        val = None
        for split in (val_split, "validation", "val", "test"):
            if not split:
                continue
            try:
                val = _load(name, split)
                break
            except Exception as e:
                if split == val_split:
                    print(f"⚠ val split '{val_split}' of {name} failed "
                          f"({type(e).__name__}: {e}); trying fallbacks")
                continue
        if val is None:
            if streaming:
                tr = trains[-1]
                rng = random.Random(seed)
                idx = list(range(len(tr)))
                rng.shuffle(idx)
                n_val = max(1, int(len(tr) * val_ratio))
                val = [tr[i] for i in idx[:n_val]]
                trains[-1] = [tr[i] for i in idx[n_val:]]
            else:
                split = trains[-1].train_test_split(test_size=val_ratio,
                                                    seed=seed)
                trains[-1] = split["train"]
                val = split["test"]
        vals.append(val)

    if streaming:
        train_ds = [r for ds in trains for r in ds]
        val_ds = [r for ds in vals for r in ds]
    else:
        train_ds = (concatenate_datasets(trains) if len(trains) > 1
                    else trains[0])
        val_ds = concatenate_datasets(vals) if len(vals) > 1 else vals[0]
    return (LineSampleSet(_HFRecords(train_ds, image_col, text_col), img_h,
                          img_w, augment, seed),
            LineSampleSet(_HFRecords(val_ds, image_col, text_col), img_h,
                          img_w, False, seed))


class _HFRecords:
    """An HF dataset (or a drained stream) as a sequence of (image, text)."""

    def __init__(self, ds, image_col: str, text_col: str):
        self.ds = ds
        self.image_col = image_col
        self.text_col = text_col

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return [self[i] for i in range(*idx.indices(len(self)))]
        item = self.ds[int(idx)]
        return (item[self.image_col], item[self.text_col])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
