"""The flagship recognizer's training recipe: the port of
``scripts/train_recognizer.py``, which wrote ``models/model.safetensors``.

``build_samples(args)`` makes the (train, val) lines with every random draw
in the JAX script's order:

1. ``MultilingualDatasetGenerator`` (augmented, seed 42) lines for all but
   the small renders and the document crops;
2. small renders at heights 16, 19, 22, 26 and 30 (generator seed
   ``1000 + i``), each with probability ``small_resample`` rotated by 2-6
   degrees and back after a vertical pad of 6% of its width + 2 rows of its
   median (``random.Random(500 + i)``);
3. ``doc_crop_samples``: lines cut out of synthetic documents with padding
   jitter, a share of the documents degraded first; then the whole list
   shuffled with ``random.Random(13)``;
4. with ``enhance_ratio``, that share (``random.Random(77)``) through
   ``invert_if_dark`` and ``enhance_crop``;
5. the first max(64, N / 50) lines for validation.

``main`` writes ``vocab.json`` (``build_full_vocab`` over the labels), and
trains with ``train_loop`` into ``--out-dir``. ``--device`` picks the torch
device (the card by default); ``--no-fonts`` draws with the pseudo-glyph
pool only.
"""
from __future__ import annotations

import argparse
import random
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: Heights of the small renders.
SMALL_HEIGHTS = (16, 19, 22, 26, 30)
#: Conditions of the degraded document crops ("resample" is a rotation by
#: the page's angle and back, what a deskewed page feeds recognition).
CROP_CONDITIONS = ("noisy", "low_contrast", "textured", "resample")


def _double_resample(img: np.ndarray, a: float) -> np.ndarray:
    from ..detect.deskew import rotate_image

    return rotate_image(rotate_image(img, a), -a)


def doc_crop_samples(n: int, khmer_ratio: float, seed: int = 7000,
                     aug_conditions: float = 0.0,
                     resample_weight: float = 0.25,
                     font_dirs: Optional[Sequence[str]] = None
                     ) -> List[Dict[str, object]]:
    """``n`` lines cut from 640 x 640 documents (seeds ``seed``, ``seed +
    1``, ...), each box grown by 2-12 px across and 2-10 px down, as the
    detector's padding and the pipeline's crop margin do. With
    ``aug_conditions``, that share of the documents is first degraded:
    "resample" with probability ``resample_weight``, else one of the other
    ``CROP_CONDITIONS``."""
    from ..data.docsynth import (DOC_FONT_SIZES, DocumentGenerator,
                                 apply_condition)
    from ..data.synth import FontManager

    fonts = FontManager(font_dirs=font_dirs, sizes=DOC_FONT_SIZES)
    r = random.Random(seed)
    out: List[Dict[str, object]] = []
    doc_seed = seed
    while len(out) < n:
        doc = DocumentGenerator(640, 640, seed=doc_seed,
                                khmer_ratio=khmer_ratio,
                                fonts=fonts).generate()
        if aug_conditions and r.random() < aug_conditions:
            if r.random() < resample_weight:
                cond = "resample"
            else:
                cond = r.choice([c for c in CROP_CONDITIONS
                                 if c != "resample"])
            if cond == "resample":
                a = r.uniform(2.0, 6.0) * (1 if r.random() < 0.5 else -1)
                doc = dict(doc, image=_double_resample(
                    np.asarray(doc["image"], np.uint8), a))
            else:
                doc = apply_condition(doc, cond, r)
        img = doc["image"]
        for (x, y, w, h), text in zip(doc["lines"], doc["texts"]):
            if not text.strip() or w < 4 or h < 4:
                continue
            px, py = r.randint(2, 12), r.randint(2, 10)
            x0, y0 = max(0, x - px), max(0, y - py)
            x1 = min(img.shape[1], x + w + px)
            y1 = min(img.shape[0], y + h + py)
            crop = img[y0:y1, x0:x1]
            if crop.size == 0:
                continue
            out.append({"image": np.ascontiguousarray(crop), "text": text})
            if len(out) >= n:
                break
        doc_seed += 1
    return out


def _small_renders(args, cfg, cache: str, fonts, n_small: int) -> List[Dict]:
    from ..data.synth import MultilingualDatasetGenerator

    out = []
    for hi, h in enumerate(SMALL_HEIGHTS):
        gen = MultilingualDatasetGenerator(
            cache, height=h, augment=True, khmer_ratio=args.khmer_ratio,
            sign_boost=args.sign_boost, seed=1000 + hi, fonts=fonts)
        batch = gen.generate_samples(n_small // len(SMALL_HEIGHTS),
                                     max_width=round(cfg.IMG_W * h
                                                     / cfg.IMG_H),
                                     max_words=args.max_words)
        if args.small_resample:
            rr = random.Random(500 + hi)
            for s in batch:
                if rr.random() < args.small_resample:
                    a = rr.uniform(2.0, 6.0) * (1 if rr.random() < 0.5
                                                else -1)
                    img = np.asarray(s["image"], np.uint8)
                    # Rotating a wide strip in place sweeps its ends out of
                    # frame ((w/2) sin 6 deg exceeds the height): pad first.
                    pad = int(img.shape[1] * 0.06) + 2
                    img = np.pad(img, ((pad, pad), (0, 0)),
                                 constant_values=int(np.median(img)))
                    s["image"] = _double_resample(img, a)[pad:-pad]
        out += batch
    return out


def recipe_cfg(args):
    """The recipe's model configuration."""
    from ..config import CFG

    return CFG(IMG_W=args.img_w, ENC_DIM=args.enc_dim,
               KHMER_VISUAL_ORDER=args.visual_order)


def build_samples(args) -> Tuple[List[Dict], List[Dict]]:
    """(train, val) lines of the recipe (the module's docstring); the
    generators' cache goes under ``args.out_dir``."""
    from ..data.synth import FontManager, MultilingualDatasetGenerator
    from ..ops.preprocess import enhance_crop, invert_if_dark

    cfg = recipe_cfg(args)
    font_dirs = [] if args.no_fonts else None
    fonts = FontManager(font_dirs=font_dirs)
    cache = str(Path(args.out_dir) / "_gen_cache")
    t0 = time.time()
    print(f"Generating {args.samples} synthetic lines...")
    gen = MultilingualDatasetGenerator(cache, height=cfg.IMG_H, augment=True,
                                       khmer_ratio=args.khmer_ratio,
                                       sign_boost=args.sign_boost,
                                       fonts=fonts)
    n_doc = int(args.samples * args.doc_crop_ratio)
    n_small = int(args.samples * args.small_render_ratio)
    samples = gen.generate_samples(args.samples - n_doc - n_small,
                                   max_width=cfg.IMG_W,
                                   max_words=args.max_words)
    if n_small:
        print(f"  + {n_small} small renders at heights {SMALL_HEIGHTS}")
        samples += _small_renders(args, cfg, cache, fonts, n_small)
    if n_doc:
        print(f"  + {n_doc} detector-style document crops"
              + (f" ({args.aug_conditions:.0%} degraded)"
                 if args.aug_conditions else ""))
        samples = samples + doc_crop_samples(
            n_doc, args.khmer_ratio, aug_conditions=args.aug_conditions,
            resample_weight=args.resample_weight, font_dirs=font_dirs)
        random.Random(13).shuffle(samples)
    if args.enhance_ratio:
        er = random.Random(77)
        n_enh = 0
        for s in samples:
            if er.random() < args.enhance_ratio:
                s["image"] = enhance_crop(
                    invert_if_dark(np.asarray(s["image"], np.uint8)))
                n_enh += 1
        print(f"  + {n_enh} samples passed through the serving enhance_crop")
    n_val = max(64, len(samples) // 50)
    val, train = samples[:n_val], samples[n_val:]
    print(f"  {len(train)} train / {len(val)} val in {time.time() - t0:.0f}s")
    return train, val


def parser() -> argparse.ArgumentParser:
    """The JAX script's flags and defaults, with ``--device`` and
    ``--no-fonts``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--samples", type=int, default=20000)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--out-dir", default="models")
    ap.add_argument("--img-w", type=int, default=640)
    ap.add_argument("--enc-dim", type=int, default=256)
    ap.add_argument("--khmer-ratio", type=float, default=0.3)
    ap.add_argument("--max-words", type=int, default=14,
                    help="word budget per sampled line")
    ap.add_argument("--small-render-ratio", type=float, default=0.0,
                    help="fraction of lines rendered at 16-30 px heights")
    ap.add_argument("--doc-crop-ratio", type=float, default=0.0,
                    help="fraction of samples cut out of synthetic "
                         "documents")
    ap.add_argument("--resample-weight", type=float, default=0.25,
                    help="within --aug-conditions, the probability of the "
                         "double-resample condition")
    ap.add_argument("--small-resample", type=float, default=0.0,
                    help="fraction of small renders rotated and back")
    ap.add_argument("--aug-conditions", type=float, default=0.0,
                    help="fraction of the crops' documents degraded first")
    ap.add_argument("--enhance-ratio", type=float, default=0.0,
                    help="fraction of samples passed through enhance_crop")
    ap.add_argument("--sign-boost", type=float, default=0.0,
                    help="fraction of Khmer lines sampled diacritic-dense")
    ap.add_argument("--ctc-weight", type=float, default=0.5)
    ap.add_argument("--dec-weight", type=float, default=0.5)
    ap.add_argument("--from-model", default=None,
                    help="warm-start weights (ignored when out-dir has a "
                         "latest.safetensors to resume)")
    ap.add_argument("--select-metric", default="ctc",
                    choices=("ctc", "ar", "mean"))
    ap.add_argument("--train-only", default=None, choices=("decoder",))
    ap.add_argument("--visual-order", action="store_true",
                    help="train on visual-order Khmer labels")
    ap.add_argument("--dec-input-noise", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--no-fonts", action="store_true",
                    help="draw with the pseudo-glyph pool only")
    return ap


def main(argv: Optional[Sequence[str]] = None):
    """Build the samples and the vocab, then train; returns the trainer."""
    from ..tokenizer import CharTokenizer, build_full_vocab
    from .trainer import TrainConfig, train_loop

    from ..evaluate import font_note

    args = parser().parse_args(argv)
    print(font_note([] if args.no_fonts else None))
    cfg = recipe_cfg(args)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    train, val = build_samples(args)
    vocab_path = str(out / "vocab.json")
    build_full_vocab(vocab_path, include_khmer=True,
                     extra_texts=(s["text"] for s in val + train))
    tok = CharTokenizer(vocab_path, cfg)
    print(f"  vocab: {tok.vocab_size} chars")
    tc = TrainConfig(epochs=args.epochs, batch_size=args.batch_size,
                     lr=args.lr, out_dir=str(out), log_every=100,
                     save_steps=0, ctc_weight=args.ctc_weight,
                     dec_weight=args.dec_weight,
                     select_metric=args.select_metric,
                     train_only=args.train_only,
                     dec_input_noise=args.dec_input_noise)
    trainer = train_loop(cfg, tok, tc, train, val, vocab_path=vocab_path,
                         from_model=args.from_model, device=args.device)
    print(f"Best val CTC exact-match: {trainer.best_val_acc * 100:.2f}%")
    return trainer
