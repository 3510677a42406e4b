"""Render the page fixture that `kiri_tpu_torch`'s page pipeline checks
itself against.

The GPU machine has no text renderer (no PIL, no cv2), so the pages and the
reference package's answers are made here once and committed:

    python scripts/make_torch_smoke_pages.py

writes ``kiri_tpu_torch/assets/smoke_pages.npz`` with 9 bilingual docsynth
pages: 640x640 in the single-column, two-column and title-paragraph
layouts, 480x640 and 512x512 (other canvas groups), one 1280x1280 page
(downscaled to ``max_side_len`` 960), one inverted and one noisy 640x640
page (``data/docsynth.apply_condition``), and a two-column page whose lines
reach the gutter, where ``TextDetector._split_column_merges`` cuts a box
that bridges it.

The first eight pages draw their lines from a pool of 2-5-word texts, 40%
Khmer, as the smoke lines do (``make_torch_smoke_lines.py``); the last uses
docsynth's own sampler (``khmer_ratio=0.4``), which fills the region's
width. On a single-column page that gives lines of up to 150 characters,
which the recognizer's resize squeezes (up to 2.6x on a 1280 px page) into
its 640 columns: there both packages read lines at CER 0.35 (Khmer 0.43,
English 0.28), which says nothing about the port.

The file holds:

* ``pages_flat`` / ``page_shapes``: the u8 pages, concatenated row-major;
  ``page_specs``: a JSON string of each page's (width, height, layout,
  condition, seed, lines from the pool);
* ``gt_lines`` [n, 4] / ``gt_texts`` / ``gt_counts``: ground-truth line
  boxes (x, y, w, h) and texts, ``gt_counts[i]`` of them on page i;
* ``det_quads`` [k, 4, 2] / ``det_scores`` / ``det_counts``: ``kiri_tpu``'s
  ``DBDetector.detect_text`` quads and scores;
* ``facade_boxes`` [m, 4] / ``facade_conf`` / ``facade_counts``:
  ``TextDetector.detect_lines_objects`` boxes (x, y, w, h);
* ``prob_page`` / ``prob_u16``: the detector's u16 map (the whole canvas)
  of one page;
* ``results``: a JSON string ``{run: [result dicts of each page]}`` of
  ``kiri_tpu.OCR.process_document`` with the committed checkpoints, for
  runs ``{fast,accurate}_{f32,bf16}`` (host preprocessing),
  ``fast_f32_device`` (``preprocess="device"``) and ``fast_f32_enhance``
  (``enhance=True``, the noisy page only; the other pages' lists are
  empty).

cv2 is run with IPP off (``cv2.ipp.setUseIPP(False)``): with IPP, cv2's
cubic resize depends on the CPU's instruction set, and the port follows
OpenCV's own code (``kiri_tpu_torch/ops/imgproc.py``). The arrays the file
already holds are kept as they are: the script fails if a regenerated one
differs from the committed one. After a change of the renderer or a
checkpoint, delete the file first.
"""
from __future__ import annotations

import json
import random
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

OUT = REPO / "kiri_tpu_torch" / "assets" / "smoke_pages.npz"
SEED = 20261017
#: (width, height, layout, condition, lines from the pool)
PAGES = ((640, 640, "single_column", "clean", True),
         (640, 640, "two_column", "clean", True),
         (640, 640, "title_paragraph", "clean", True),
         (480, 640, "single_column", "clean", True),
         (512, 512, "two_column", "clean", True),
         (1280, 1280, "single_column", "clean", True),
         (640, 640, "single_column", "inverted", True),
         (640, 640, "single_column", "noisy", True),
         (640, 640, "two_column", "clean", False))
KHMER_RATIO = 0.4
PROB_PAGE = 1
NOISY_PAGE = 7


def text_pool(charset: str, n: int = 600):
    """Short bilingual lines, every fifth two of them Khmer."""
    from kiri_tpu.data.synth import sample_khmer_text, sample_text

    rng = random.Random(SEED)
    return [sample_khmer_text(rng, 2, 4) if i % 5 < 2
            else sample_text(rng, 2, 5, charset) for i in range(n)]


def render_pages(charset: str):
    from kiri_tpu.data.docsynth import DocumentGenerator, apply_condition

    pool = text_pool(charset)
    docs, specs = [], []
    for i, (w, h, layout, cond, from_pool) in enumerate(PAGES):
        seed = SEED + 101 * i
        doc = DocumentGenerator(w, h, seed=seed, khmer_ratio=KHMER_RATIO,
                                texts=pool if from_pool else None
                                ).generate(layout)
        if cond != "clean":
            doc = apply_condition(doc, cond, random.Random(seed))
        docs.append(doc)
        specs.append((w, h, layout, cond, seed, from_pool))
    return docs, specs


def main() -> None:
    import cv2
    import jax

    jax.config.update("jax_platforms", "cpu")
    cv2.ipp.setUseIPP(False)
    from kiri_tpu.detect import TextDetector
    from kiri_tpu.detect.db import DBDetector
    from kiri_tpu.ops.preprocess import invert_if_dark
    from kiri_tpu.pipeline import OCR
    from kiri_tpu.tokenizer import CharTokenizer
    from kiri_tpu.train.checkpoints import find_vocab_file, load_checkpoint

    ckpt = str(REPO / "models" / "model.safetensors")
    det_path = str(REPO / "models" / "detector.safetensors")
    _, cfg, meta = load_checkpoint(ckpt)
    tok = CharTokenizer(find_vocab_file(meta.get("vocab_path", ""), ckpt), cfg)
    docs, specs = render_pages("".join(
        t for t in tok.token_to_id
        if len(t) == 1 and t.isascii() and t.isprintable()))
    pages = [np.ascontiguousarray(d["image"], np.uint8) for d in docs]
    out = {
        "pages_flat": np.concatenate([p.ravel() for p in pages]),
        "page_shapes": np.asarray([p.shape for p in pages], np.int32),
        "page_specs": np.asarray(json.dumps(specs)),
        "gt_lines": np.asarray([b for d in docs for b in d["lines"]],
                               np.int32),
        "gt_texts": np.asarray([t for d in docs for t in d["texts"]]),
        "gt_counts": np.asarray([len(d["texts"]) for d in docs], np.int32),
    }
    db = DBDetector(det_path)
    dets = [db.detect_text(p) for p in pages]
    out.update({
        "det_quads": np.asarray([q for d in dets for q, _ in d], np.int32),
        "det_scores": np.asarray([s for d in dets for _, s in d], np.float64),
        "det_counts": np.asarray([len(d) for d in dets], np.int32),
    })
    facade = TextDetector("db", det_path)
    boxes = [facade.detect_lines_objects(p) for p in pages]
    out.update({
        "facade_boxes": np.asarray([b.bbox for bs in boxes for b in bs],
                                   np.int32),
        "facade_conf": np.asarray([b.confidence for bs in boxes for b in bs],
                                  np.float64),
        "facade_counts": np.asarray([len(bs) for bs in boxes], np.int32),
    })
    canvas, _, _ = db._resize_image(invert_if_dark(db._to_gray(
        pages[PROB_PAGE])))
    out["prob_page"] = np.asarray(PROB_PAGE, np.int32)
    out["prob_u16"] = np.asarray(db._fwd(db.variables, canvas))

    results = {}
    runs = [(f"{m}_{tag}", dict(decode_method=m, use_fp16=tag == "bf16"),
             range(len(pages)))
            for m in ("fast", "accurate") for tag in ("f32", "bf16")]
    runs += [("fast_f32_device", dict(decode_method="fast", use_fp16=False,
                                      preprocess="device"), range(len(pages))),
             ("fast_f32_enhance", dict(decode_method="fast", use_fp16=False,
                                       enhance=True), (NOISY_PAGE,))]
    for name, kw, which in runs:
        t0 = time.perf_counter()
        OCR._model_cache.clear()   # the cache ignores use_fp16
        ocr = OCR(ckpt, det_model_path=det_path, **kw)
        results[name] = [ocr.process_document(p) if i in which else []
                         for i, p in enumerate(pages)]
        print(f"{name}: {sum(map(len, results[name]))} lines in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    out["results"] = np.asarray(json.dumps(results, ensure_ascii=False))

    if OUT.exists():
        with np.load(OUT) as old:
            changed = [k for k in old.files
                       if k in out and not np.array_equal(old[k], out[k])]
        if changed:
            raise SystemExit(f"regenerated arrays differ from the committed "
                             f"fixture: {changed}")
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes): pages "
          f"{[p.shape for p in pages]}, gt lines {out['gt_counts'].tolist()}, "
          f"detected {out['det_counts'].tolist()}, boxes "
          f"{out['facade_counts'].tolist()}")
    gts = np.split(out["gt_texts"], np.cumsum(out["gt_counts"])[:-1])
    for name, res in results.items():
        exact = sum(r["text"] in set(g) for rs, g in zip(res, gts) for r in rs)
        print(f"  {name}: {exact} of {sum(map(len, res))} texts equal a "
              f"ground-truth line")


if __name__ == "__main__":
    main()
