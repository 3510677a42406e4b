"""Accuracy of the recognizer, the detector and the whole pipeline on
synthetic data: the ports of ``scripts/eval_recognizer.py``,
``scripts/eval_detector.py`` and ``scripts/eval_pipeline.py``, with their
metric definitions, seeds and JSON lines.

- ``eval_recognizer`` renders held-out lines, optionally degrades
  (``degrade_lines``) and enhances them, recognizes them with each decode
  method and reports CER, cluster CER and exact match by script (and by
  condition under ``degrade``), truth and hypothesis NFC-normalized;
- ``eval_detector`` reports line recall and precision of a ``TextDetector``
  over eight rows of 640 x 640 documents: English, mixed, five robustness
  conditions and two columns. A ground-truth line is recalled when a
  detected box covers its centre and half its area (``_covers``);
- ``eval_pipeline`` runs ``evalpage.eval_condition`` per condition.

``font_dirs`` is where the generators look for TrueType fonts: None for
the system's, ``[]`` for the procedural pseudo-glyph pool only. The
``*_main`` functions are the command lines (``scripts/eval_torch_*.py``).
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import tempfile
import time
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from .evalpage import eval_condition, levenshtein

__all__ = ["levenshtein", "script_of", "line_samples", "degrade_lines",
           "eval_recognizer", "detector_rows", "eval_detector",
           "eval_pipeline", "font_note", "recognizer_main", "detector_main",
           "pipeline_main"]

#: Line conditions of ``degrade_lines``, in the order of their draw.
LINE_CONDITIONS = ("noisy", "low_contrast", "rot_resample")
#: Recognition batch of ``eval_recognizer``.
BATCH = 64


def _nfc(s: str) -> str:
    return unicodedata.normalize("NFC", s)


def script_of(text: str) -> str:
    """"khmer", "english" or "mixed" (Khmer letters and ASCII
    alphanumerics both)."""
    has_kh = any(0x1780 <= ord(c) <= 0x17FF for c in text)
    has_en = any(c.isascii() and c.isalnum() for c in text)
    if has_kh and has_en:
        return "mixed"
    return "khmer" if has_kh else "english"


# --------------------------------------------------------------- recognizer
def degrade_lines(samples: List[Dict], seed: int) -> List[str]:
    """Degrade each sample's u8 image in place with one condition of
    ``LINE_CONDITIONS``, drawn from ``np.random.default_rng(seed)``; returns
    the conditions. "noisy": gaussian noise of a sigma in [14, 26) and 0.2%
    salt and pepper each; "low_contrast": the range squeezed to [lo, hi];
    "rot_resample": rotated by 2-6 degrees either way and back, both with
    ``expand`` and a white fill (a deskewed page's double resample), then
    the centre cut back to the original size."""
    from .ops.imgproc import rotate_bilinear

    rng = np.random.default_rng(seed)
    conditions = []
    for s in samples:
        img = s["image"].astype(np.float32)
        kind = LINE_CONDITIONS[int(rng.integers(0, len(LINE_CONDITIONS)))]
        conditions.append(kind)
        if kind == "noisy":
            img = img + rng.normal(0, rng.uniform(14, 26), img.shape)
            mask = rng.random(img.shape)
            img[mask < 0.002] = 0
            img[mask > 0.998] = 255
        elif kind == "low_contrast":
            lo = rng.uniform(70, 110)
            hi = rng.uniform(170, 210)
            img = img / 255.0 * (hi - lo) + lo
        else:
            a = float(rng.uniform(2, 6)) * (1 if rng.random() < 0.5 else -1)
            big = rotate_bilinear(s["image"], a, 255, expand=True)
            arr = rotate_bilinear(big, -a, 255, expand=True).astype(
                np.float32)
            h, w = s["image"].shape
            y0, x0 = (arr.shape[0] - h) // 2, (arr.shape[1] - w) // 2
            img = arr[y0:y0 + h, x0:x0 + w]
        s["image"] = np.clip(img, 0, 255).astype(np.uint8)
    return conditions


def line_samples(cfg, n: int, khmer_ratio: float = 0.5, seed: int = 777,
                 degrade: bool = False, render_height: Optional[int] = None,
                 enhance: bool = False,
                 font_dirs: Optional[Sequence[str]] = None):
    """(samples [{image u8, text}], conditions): ``n`` unaugmented lines of
    ``MultilingualDatasetGenerator(seed=seed)`` at ``render_height`` (the
    model's height by default, widths up to the model's width scaled
    alike), degraded and enhanced as asked; a condition is None where the
    line was not degraded."""
    from .data.synth import FontManager, MultilingualDatasetGenerator
    from .ops.preprocess import enhance_crop

    render_h = render_height or cfg.IMG_H
    max_w = round(cfg.IMG_W * render_h / cfg.IMG_H)
    with tempfile.TemporaryDirectory(prefix="kiri_eval_") as tmp:
        gen = MultilingualDatasetGenerator(
            tmp, height=render_h, augment=False, khmer_ratio=khmer_ratio,
            seed=seed, fonts=FontManager(font_dirs=font_dirs))
        samples = gen.generate_samples(n, max_width=max_w)
    conditions: List[Optional[str]] = [None] * len(samples)
    if degrade:
        conditions = degrade_lines(samples, seed)
    if enhance:
        for s, c in zip(samples, conditions):
            s["image"] = enhance_crop(s["image"], sharpen=c == "rot_resample")
    return samples, conditions


def _score(texts, hyps, labels) -> Dict[str, Dict]:
    """Scores of each group of ``labels`` ({group: label per line}): the
    lines labelled with the group's name, or every line for "all"."""
    from .utils.khmer import cluster_cer

    per = {}
    for grp in labels:
        idx = [i for i, s in enumerate(labels[grp]) if grp in ("all", s)]
        if not idx:
            continue
        cers = [levenshtein(texts[i], _nfc(hyps[i])) / max(1, len(texts[i]))
                for i in idx]
        ccers = [cluster_cer(texts[i], hyps[i]) for i in idx]
        exact = [_nfc(hyps[i]) == texts[i] for i in idx]
        per[grp] = {"n": len(idx),
                    "cer": round(float(np.mean(cers)), 4),
                    "cluster_cer": round(float(np.mean(ccers)), 4),
                    "exact": round(float(np.mean(exact)), 4)}
    return per


def _dump_errors(dump_dir: Path, method: str, samples, texts, scripts,
                 outs) -> None:
    from .utils.imageio import imwrite_png

    dump_dir.mkdir(parents=True, exist_ok=True)
    errs = []
    for i, t in enumerate(texts):
        hyp = _nfc(outs[i][0])
        if hyp == t:
            continue
        errs.append({"idx": i, "script": scripts[i], "truth": t, "hyp": hyp,
                     "cer": round(levenshtein(t, hyp) / max(1, len(t)), 4),
                     "conf": round(float(outs[i][1]), 4)})
        imwrite_png(dump_dir / f"err_{method}_{i:04d}.png",
                    samples[i]["image"])
    (dump_dir / f"errors_{method}.json").write_text(
        json.dumps(errs, ensure_ascii=False, indent=1))
    print(f"  {len(errs)} mismatches -> {dump_dir}/errors_{method}.json")


def eval_recognizer(ocr, n: int = 300, khmer_ratio: float = 0.5,
                    seed: int = 777,
                    methods: Sequence[str] = ("fast", "accurate", "beam"),
                    degrade: bool = False,
                    render_height: Optional[int] = None,
                    enhance: bool = False, dump_errors: Optional[str] = None,
                    font_dirs: Optional[Sequence[str]] = None,
                    outputs: Optional[Dict] = None,
                    verbose: bool = True) -> Dict[str, Dict]:
    """{method: {group: {n, cer, cluster_cer, exact}}} of ``ocr``'s engine
    over ``line_samples``' lines, in batches of 64 through
    ``recognize_batch``. Groups: english, khmer, mixed, all and, under
    ``degrade``, each line condition; an empty group is left out.
    ``outputs``, when given, receives each method's (text, confidence)
    per line and ``"samples"``, the lines as recognized."""
    from .ops.preprocess import content_width, resize_keep_ratio_pad_np

    cfg = ocr.cfg
    samples, conditions = line_samples(cfg, n, khmer_ratio, seed, degrade,
                                       render_height, enhance, font_dirs)
    texts = [_nfc(s["text"]) for s in samples]
    widths = np.asarray([content_width(s["image"].shape, cfg.IMG_H,
                                       cfg.IMG_W) for s in samples], np.int32)
    imgs = np.stack([resize_keep_ratio_pad_np(s["image"], cfg.IMG_H,
                                              cfg.IMG_W) for s in samples])
    scripts = [script_of(t) for t in texts]
    labels = {g: scripts for g in ("english", "khmer", "mixed", "all")}
    if degrade:
        labels.update({k: conditions for k in LINE_CONDITIONS})
    if outputs is not None:
        outputs["samples"] = samples

    report = {}
    for method in methods:
        method = method.strip()
        m = ocr._normalize_decode_method(method)
        outs = []
        for i in range(0, len(imgs), BATCH):
            outs.extend(ocr.engine.recognize_batch(
                imgs[i:i + BATCH], m, widths=widths[i:i + BATCH]))
        report[method] = _score(texts, [o[0] for o in outs], labels)
        if outputs is not None:
            outputs[method] = outs
        if verbose:
            print(method, json.dumps(report[method]))
        if dump_errors:
            _dump_errors(Path(dump_errors), method, samples, texts, scripts,
                         outs)
    return report


# ----------------------------------------------------------------- detector
def _rect_of(points: np.ndarray):
    x0, y0 = points[:, 0].min(), points[:, 1].min()
    x1, y1 = points[:, 0].max(), points[:, 1].max()
    return float(x0), float(y0), float(x1), float(y1)


def _covers(det, gt) -> bool:
    """``det`` (x0, y0, x1, y1) covers the centre of ``gt`` (x, y, w, h)
    and at least half its area."""
    dx0, dy0, dx1, dy1 = det
    gx, gy, gw, gh = gt
    cx, cy = gx + gw / 2, gy + gh / 2
    if not (dx0 <= cx <= dx1 and dy0 <= cy <= dy1):
        return False
    ix = max(0.0, min(dx1, gx + gw) - max(dx0, gx))
    iy = max(0.0, min(dy1, gy + gh) - max(dy0, gy))
    return ix * iy >= 0.5 * gw * gh


def detector_rows(n: int, seed: int = 5000,
                  font_dirs: Optional[Sequence[str]] = None):
    """(row name, documents) of ``eval_detector``'s eight rows, each made
    when its row is reached: documents ``seed + i`` English-only and mixed
    (Khmer ratio 0.4); for each condition but "clean", ``seed + 373 i + 7``
    degraded with one ``random.Random(seed + 991 (1 + index))`` a row; two
    columns at ``seed + 119 i``."""
    from .data.docsynth import (CONDITIONS, DOC_FONT_SIZES, DocumentGenerator,
                                apply_condition)
    from .data.synth import FontManager

    fonts = FontManager(font_dirs=font_dirs, sizes=DOC_FONT_SIZES)

    def gen(s, ratio):
        return DocumentGenerator(640, 640, seed=s, khmer_ratio=ratio,
                                 fonts=fonts)

    for ratio, key in ((0.0, "english"), (0.4, "mixed")):
        yield key, (gen(seed + i, ratio).generate() for i in range(n))
    for cond in CONDITIONS[1:]:
        rng = random.Random(seed + 991 * (1 + CONDITIONS.index(cond)))
        yield cond, (apply_condition(gen(seed + 373 * i + 7, 0.4).generate(),
                                     cond, rng) for i in range(n))
    yield "multi_column", (gen(seed + 119 * i, 0.4).generate(
        layout="two_column") for i in range(n))


def eval_detector(det, n: int = 24, seed: int = 5000,
                  font_dirs: Optional[Sequence[str]] = None,
                  boxes: Optional[Dict[str, List]] = None,
                  verbose: bool = True) -> Dict:
    """Line recall and precision of ``det.detect_lines_objects`` over
    ``detector_rows``: {detector, deskew, total_docs, worst_condition,
    report: {row: {n_docs, gt_lines, recall, precision, detections}}}.
    ``boxes``, when given, receives each row's pages' (x0, y0, x1, y1)."""
    report = {}
    for key, docs in detector_rows(n, seed, font_dirs):
        hits = total = tps = dets = n_docs = 0
        for doc in docs:
            n_docs += 1
            rects = [_rect_of(np.asarray([[b.x, b.y],
                                          [b.x + b.width, b.y + b.height]]))
                     for b in det.detect_lines_objects(doc["image"])]
            if boxes is not None:
                boxes.setdefault(key, []).append(rects)
            gt = doc["lines"]
            total += len(gt)
            dets += len(rects)
            hits += sum(any(_covers(r, g) for r in rects) for g in gt)
            tps += sum(any(_covers(r, g) for g in gt) for r in rects)
        report[key] = {"n_docs": n_docs, "gt_lines": total,
                       "recall": round(hits / max(1, total), 4),
                       "precision": round(tps / max(1, dets), 4),
                       "detections": dets}
        if verbose:
            print(key, json.dumps(report[key]))
    worst = min(report.items(), key=lambda kv: kv[1]["recall"])
    return {"detector": det.method, "deskew": det.deskew,
            "total_docs": sum(v["n_docs"] for v in report.values()),
            "worst_condition": {worst[0]: worst[1]["recall"]},
            "report": report}


# ----------------------------------------------------------------- pipeline
def eval_pipeline(ocr, conditions: Sequence[str] = ("clean", "rotated"),
                  n: int = 6, seed: int = 7000, khmer_ratio: float = 0.4,
                  font_dirs: Optional[Sequence[str]] = None,
                  verbose: bool = True) -> Dict[str, Dict]:
    """{condition: ``eval_condition`` row} over ``n`` pages a condition,
    each row printed as a JSON line."""
    summary = {}
    for cond in conditions:
        cond = cond.strip()
        row = eval_condition(ocr, cond, n, seed=seed,
                             khmer_ratio=khmer_ratio, font_dirs=font_dirs)
        summary[cond] = row
        if verbose:
            print(json.dumps(row))
    return summary


# ------------------------------------------------------------ command lines
def font_note(font_dirs: Optional[Sequence[str]]) -> str:
    """How many TrueType files the generators find under ``font_dirs``
    (None: the system's directories) and how many they draw with: without
    Pillow, none."""
    from .data import synth

    found = synth.FontManager._discover(
        synth._FONT_DIRS if font_dirs is None else font_dirs)
    pool = synth.FontManager(font_dirs=font_dirs).font_paths
    used = [p for p in pool if p in found]
    return (f"fonts: {len(found)} TrueType file(s) found, {len(used)} in "
            f"use, {len(pool) - len(used)} pseudo-glyph (Pillow "
            f"{'present' if synth.pillow_modules() else 'absent'})")


def _run(main_body, no_fonts: bool):
    """Run a command line's body; its font pool and wall time go to
    stderr, so that stdout holds the JSON lines alone."""
    print(font_note([] if no_fonts else None), file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    out = main_body()
    print(f"wall: {time.perf_counter() - t0:.1f} s", file=sys.stderr,
          flush=True)
    print(json.dumps(out))
    return out


def _add_port_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--no-fonts", action="store_true",
                    help="draw with the pseudo-glyph pool only (no system "
                         "TrueType fonts)")


def recognizer_main(argv: Optional[Sequence[str]] = None) -> Dict:
    """``scripts/eval_torch_recognizer.py``: the flags, defaults and
    printed lines of ``scripts/eval_recognizer.py``."""
    ap = argparse.ArgumentParser(description=eval_recognizer.__doc__)
    ap.add_argument("--model", default="models/model.safetensors")
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--khmer-ratio", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=777)
    ap.add_argument("--methods", default="fast,accurate,beam")
    ap.add_argument("--dump-errors", default=None, metavar="DIR",
                    help="write per-method mismatch reports (JSON + line "
                         "images) into DIR")
    ap.add_argument("--degrade", action="store_true",
                    help="degrade the line crops before recognition (noise "
                         "+ salt and pepper, contrast compression, "
                         "rotate-resample; per-condition CER is reported)")
    ap.add_argument("--render-height", type=int, default=None,
                    help="render lines at this height instead of the model "
                         "height (e.g. 22 = document-scale glyphs)")
    ap.add_argument("--enhance", action="store_true",
                    help="run enhance_crop on each line before recognition")
    _add_port_flags(ap)
    args = ap.parse_args(argv)

    from .pipeline import OCR

    def body():
        ocr = OCR(args.model, device=args.device)
        report = eval_recognizer(
            ocr, args.n, args.khmer_ratio, args.seed,
            args.methods.split(","), args.degrade, args.render_height,
            args.enhance, args.dump_errors, [] if args.no_fonts else None)
        return {"model": args.model, "n": args.n,
                "khmer_ratio": args.khmer_ratio, "report": report}

    return _run(body, args.no_fonts)


def detector_main(argv: Optional[Sequence[str]] = None) -> Dict:
    """``scripts/eval_torch_detector.py``: the flags, defaults and printed
    lines of ``scripts/eval_detector.py``."""
    ap = argparse.ArgumentParser(description=eval_detector.__doc__)
    ap.add_argument("--detector", default="db", choices=("db", "craft"))
    ap.add_argument("--model", default=None)
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--seed", type=int, default=5000)
    ap.add_argument("--deskew", action="store_true",
                    help="enable the facade's projection-profile deskew")
    ap.add_argument("--map-downsample", type=int, default=1,
                    help="DB det_map_downsample serving knob")
    _add_port_flags(ap)
    args = ap.parse_args(argv)

    from .detect import TextDetector

    default_model = ("models/detector.safetensors" if args.detector == "db"
                     else "models/craft.safetensors")

    def body():
        det = TextDetector(method=args.detector,
                           model_path=args.model or default_model,
                           deskew=args.deskew,
                           det_map_downsample=args.map_downsample,
                           device=args.device)
        return eval_detector(det, args.n, args.seed,
                             [] if args.no_fonts else None)

    return _run(body, args.no_fonts)


def pipeline_main(argv: Optional[Sequence[str]] = None) -> Dict:
    """``scripts/eval_torch_pipeline.py``: the flags, defaults and printed
    lines of ``scripts/eval_pipeline.py``."""
    ap = argparse.ArgumentParser(description=eval_pipeline.__doc__)
    ap.add_argument("--n", type=int, default=6, help="docs per condition")
    ap.add_argument("--conditions", default="clean,rotated",
                    help="comma list from docsynth CONDITIONS")
    ap.add_argument("--decode", default="fast",
                    choices=("fast", "accurate", "beam", "auto"))
    ap.add_argument("--deskew", action="store_true")
    ap.add_argument("--enhance", action="store_true",
                    help="adaptive crop cleanup before recognition")
    ap.add_argument("--model", default="models/model.safetensors")
    ap.add_argument("--det-model", default=None)
    ap.add_argument("--detector", default="db",
                    choices=("db", "craft", "legacy"))
    ap.add_argument("--khmer-ratio", type=float, default=0.4)
    ap.add_argument("--seed", type=int, default=7000)
    ap.add_argument("--upload-bits", type=int, choices=(4, 8), default=8,
                    help="4: packed recognition uploads")
    ap.add_argument("--map-downsample", type=int, default=1,
                    help="DB det_map_downsample serving knob")
    ap.add_argument("--two-step-deskew", action="store_true",
                    help="crop deskewed lines from the rotated page")
    _add_port_flags(ap)
    args = ap.parse_args(argv)

    from .pipeline import OCR

    def body():
        ocr = OCR(model_path=args.model, det_model_path=args.det_model,
                  det_method=args.detector, decode_method=args.decode,
                  deskew=args.deskew, enhance=args.enhance,
                  upload_bits=args.upload_bits,
                  deskew_single_resample=not args.two_step_deskew,
                  det_kwargs=({"det_map_downsample": args.map_downsample}
                              if args.map_downsample > 1 else None),
                  device=args.device)
        summary = eval_pipeline(ocr, args.conditions.split(","), args.n,
                                args.seed, args.khmer_ratio,
                                [] if args.no_fonts else None)
        return {"decode": args.decode, "detector": args.detector,
                "deskew": args.deskew, "enhance": args.enhance,
                "summary": summary}

    return _run(body, args.no_fonts)
