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

Three rotated 640x640 pages follow (docsynth's "rotated" condition, 2-6
degrees: a single-column and a title-paragraph page, and a single-column
page rotated and then made noisy, where ``OCR(enhance=True)`` despikes the
page before its warps), with CRAFT (``models/craft.safetensors``) over all
twelve pages (the nine above, then the three rotated):

* ``rot_pages_flat`` / ``rot_page_shapes`` / ``rot_page_specs``,
  ``rot_gt_lines`` / ``rot_gt_upright`` (the boxes before the rotation) /
  ``rot_gt_texts`` / ``rot_gt_counts``: the rotated pages and their ground
  truth;
* ``skew_angles`` [12]: ``estimate_skew`` of every page;
* ``deskew_{db,craft}_angle`` [3], ``deskew_{db,craft}_boxes`` /
  ``_conf`` / ``_twins`` (the upright boxes) / ``_counts``:
  ``TextDetector(method, deskew=True).detect_lines_objects`` of the
  rotated pages;
* ``craft_quads`` [k, 4, 2] float32 / ``craft_scores`` / ``craft_counts``:
  ``CRAFTDetector.detect_text`` of every page; ``craft_boxes`` /
  ``craft_conf`` / ``craft_box_counts``: ``TextDetector("craft")``'s
  boxes;
* ``craft_map_pages`` [2] and ``craft_maps_<i>`` float16 [2, h, w]: the
  region and affinity maps of two pages; ``craft_poly_page``,
  ``craft_poly_pts`` / ``craft_poly_sizes``: ``detect_text(poly=True)`` of
  one page;
* ``results_rot``: a JSON string ``{run: [result dicts of each of the
  twelve pages]}`` for the runs of ``ROT_RUNS`` (pages a run skips have
  empty lists).

The classic-CV detector (``kiri_tpu/detect/legacy.py``) over thirteen pages
(the twelve above, then ``color_page``, page 0 tinted by
``kiri_tpu_torch.smoke.tint`` so that the RGB, HSV and LAB candidates run):

* ``color_page`` u8 [640, 640, 3] (BGR);
* ``legacy_{lines,words,blocks,chars}`` [n, 4] with
  ``legacy_{lines,words,blocks,chars}_counts`` [13]:
  ``ImageProcessingTextDetector().detect_{lines,words,blocks,characters}``;
  ``legacy_all``: a JSON string of each page's ``detect_all`` hierarchy
  (``[[x, y, w, h], level, children]``);
* ``legacy_deskew_angle`` [3], ``legacy_deskew_boxes`` / ``_twins`` /
  ``_counts``: ``TextDetector("legacy", deskew=True)`` of the rotated
  pages;
* ``db_blocks`` / ``db_blocks_counts`` [12]: ``TextDetector("db")
  .detect_blocks`` (blocks of the DB lines);
* ``results_legacy``: a JSON string ``{run: [result dicts of each of the
  thirteen pages]}`` for the runs of ``LEGACY_RUNS``.

The JAX package's line grouping rescans every line for every component
(85 s on the 1280 px page), so the script caches its ``_components`` and
``_group_into_lines`` by input: the answers are those of its own calls.
``python scripts/make_torch_smoke_pages.py --add`` computes only the arrays
the committed file lacks (the pages are read from it) and keeps the rest.

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
#: (layout, condition): rotated pages, indices 9-11 of the twelve.
ROT_PAGES = (("single_column", "rotated"), ("title_paragraph", "rotated"),
             ("single_column", "rotated+noisy"))
ROT_NOISY = 11
#: Pages whose CRAFT maps are stored; the page of the poly=True boxes.
CRAFT_MAP_PAGES = (3, 9)
CRAFT_POLY_PAGE = 0
ALL = range(12)
ROT = range(9, 12)
#: The page tinted into ``color_page``.
COLOR_FROM = 0
#: (run, OCR arguments, process_document mode) of ``results_legacy``.
LEGACY_RUNS = (
    ("legacy_fast_f32", dict(det_method="legacy", decode_method="fast",
                             use_fp16=False), "lines"),
    ("legacy_fast_bf16", dict(det_method="legacy", decode_method="fast",
                              use_fp16=True), "lines"),
    ("words_fast_f32", dict(decode_method="fast", use_fp16=False), "words"))
LEGACY_KEYS = ("color_page", "legacy_lines", "legacy_lines_counts",
               "legacy_words", "legacy_words_counts", "legacy_blocks",
               "legacy_blocks_counts", "legacy_chars", "legacy_chars_counts",
               "legacy_all", "legacy_deskew_angle", "legacy_deskew_boxes",
               "legacy_deskew_twins", "legacy_deskew_counts", "db_blocks",
               "db_blocks_counts", "results_legacy")
#: (run, OCR arguments, pages) of ``results_rot``.
ROT_RUNS = tuple(
    [(f"db_deskew_{m}_{t}", dict(decode_method=m, use_fp16=t == "bf16",
                                 deskew=True), ROT)
     for m in ("fast", "accurate") for t in ("f32", "bf16")]
    + [(f"db_deskew_{m}_f32_twostep",
        dict(decode_method=m, use_fp16=False, deskew=True,
             deskew_single_resample=False), ROT)
       for m in ("fast", "accurate")]
    + [("db_deskew_fast_f32_device", dict(decode_method="fast",
                                          use_fp16=False, deskew=True,
                                          preprocess="device"), ROT),
       ("db_deskew_fast_f32_enhance", dict(decode_method="fast",
                                           use_fp16=False, deskew=True,
                                           enhance=True), (ROT_NOISY,)),
       ("db_fast_bf16", dict(decode_method="fast", use_fp16=True), ROT)]
    + [(f"craft_{m}_{t}", dict(det_method="craft", decode_method=m,
                               use_fp16=t == "bf16"), ALL)
       for m in ("fast", "accurate") for t in ("f32", "bf16")]
    + [(f"craft_deskew_fast_f32{sfx}",
        dict(det_method="craft", decode_method="fast", use_fp16=False,
             deskew=True, deskew_single_resample=sr), ROT)
       for sfx, sr in (("", True), ("_twostep", False))])


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


def render_rotated(charset: str):
    from kiri_tpu.data.docsynth import DocumentGenerator, apply_condition

    pool = text_pool(charset)
    docs, uprights, specs = [], [], []
    for j, (layout, cond) in enumerate(ROT_PAGES):
        seed = SEED + 101 * (len(PAGES) + j)
        doc = DocumentGenerator(640, 640, seed=seed, khmer_ratio=KHMER_RATIO,
                                texts=pool).generate(layout)
        uprights.append(list(doc["lines"]))
        doc = apply_condition(doc, "rotated", random.Random(seed))
        if cond.endswith("+noisy"):
            doc = apply_condition(doc, "noisy", random.Random(seed + 1))
        docs.append(doc)
        specs.append((640, 640, layout, cond, seed, True))
    return docs, uprights, specs


def craft_and_deskew(pages, rot_docs, rot_uprights, rot_specs, ckpt,
                     det_path, craft_path):
    """The arrays of the rotated pages, CRAFT and deskew, and
    ``results_rot``."""
    from kiri_tpu.detect import TextDetector
    from kiri_tpu.detect.craft import CRAFTDetector
    from kiri_tpu.detect.deskew import estimate_skew
    from kiri_tpu.pipeline import OCR

    rot = [np.ascontiguousarray(d["image"], np.uint8) for d in rot_docs]
    every = pages + rot
    out = {
        "rot_pages_flat": np.concatenate([p.ravel() for p in rot]),
        "rot_page_shapes": np.asarray([p.shape for p in rot], np.int32),
        "rot_page_specs": np.asarray(json.dumps(rot_specs)),
        "rot_gt_lines": np.asarray([b for d in rot_docs for b in d["lines"]],
                                   np.int32),
        "rot_gt_upright": np.asarray([b for u in rot_uprights for b in u],
                                     np.int32),
        "rot_gt_texts": np.asarray([t for d in rot_docs for t in d["texts"]]),
        "rot_gt_counts": np.asarray([len(d["texts"]) for d in rot_docs],
                                    np.int32),
        "skew_angles": np.asarray([estimate_skew(p) for p in every],
                                  np.float64),
    }
    for method, path in (("db", det_path), ("craft", craft_path)):
        td = TextDetector(method, path, deskew=True)
        assert td.method == method, "kiri_tpu fell back to another detector"
        boxes, twins, angles = [], [], []
        for p in rot:
            boxes.append(td.detect_lines_objects(p))
            # Every rotated page must be straightened: the boxes and their
            # upright twins share one count.
            assert td.last_deskew_angle, f"{method}: deskew did not fire"
            twins.append([b.bbox for b in td.last_deskew_boxes])
            angles.append(td.last_deskew_angle)
        out.update({
            f"deskew_{method}_angle": np.asarray(angles, np.float64),
            f"deskew_{method}_boxes": np.asarray(
                [b.bbox for bs in boxes for b in bs], np.int32),
            f"deskew_{method}_conf": np.asarray(
                [b.confidence for bs in boxes for b in bs], np.float64),
            f"deskew_{method}_twins": np.asarray(
                [t for ts in twins for t in ts], np.int32),
            f"deskew_{method}_counts": np.asarray(list(map(len, boxes)),
                                                  np.int32),
        })
    craft = CRAFTDetector(craft_path)
    dets = [craft.detect_text(p) for p in every]
    facade = TextDetector("craft", craft_path)
    assert facade.method == "craft", "kiri_tpu fell back to another detector"
    fboxes = [facade.detect_lines_objects(p) for p in every]
    poly = craft.detect_text(every[CRAFT_POLY_PAGE], poly=True)
    out.update({
        "craft_quads": np.asarray([q for d in dets for q, _ in d],
                                  np.float32),
        "craft_scores": np.asarray([s for d in dets for _, s in d],
                                   np.float64),
        "craft_counts": np.asarray(list(map(len, dets)), np.int32),
        "craft_boxes": np.asarray([b.bbox for bs in fboxes for b in bs],
                                  np.int32),
        "craft_conf": np.asarray([b.confidence for bs in fboxes for b in bs],
                                 np.float64),
        "craft_box_counts": np.asarray(list(map(len, fboxes)), np.int32),
        "craft_map_pages": np.asarray(CRAFT_MAP_PAGES, np.int32),
        "craft_poly_page": np.asarray(CRAFT_POLY_PAGE, np.int32),
        "craft_poly_pts": np.concatenate([q for q, _ in poly]).astype(
            np.float32),
        "craft_poly_sizes": np.asarray([len(q) for q, _ in poly], np.int32),
    })
    for i in CRAFT_MAP_PAGES:
        region, affinity, _ = craft.predict_maps(craft._load_gray(every[i]))
        out[f"craft_maps_{i}"] = np.stack([region, affinity]).astype(
            np.float16)

    results = {}
    for name, kw, which in ROT_RUNS:
        t0 = time.perf_counter()
        OCR._model_cache.clear()
        det = craft_path if kw.get("det_method") == "craft" else det_path
        ocr = OCR(ckpt, det_model_path=det, **kw)
        results[name] = [ocr.process_document(p) if i in which else []
                         for i, p in enumerate(every)]
        assert ocr.detector.method == kw.get("det_method", "db")
        print(f"{name}: {sum(map(len, results[name]))} lines in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    out["results_rot"] = np.asarray(json.dumps(results, ensure_ascii=False))
    return out


def _cache_legacy_stages(cls) -> None:
    """Memoise the classic-CV detector's two costly stages by their input
    (and the detector's settings)."""
    import hashlib

    cache = {}
    components, group = cls._components, cls._group_into_lines

    def key(self, tag, *arrays):
        h = hashlib.sha256(repr(sorted(
            (k, v) for k, v in vars(self).items() if k != "_debug")).encode())
        for a in arrays:
            if a is not None:
                a = np.ascontiguousarray(a)
                h.update(repr((a.shape, a.dtype.str)).encode() + a.tobytes())
        return tag, h.hexdigest()

    def cached_components(self, gray, color=None):
        k = key(self, "c", gray, color)
        if k not in cache:
            cache[k] = components(self, gray, color)
        return cache[k].copy()

    def cached_group(self, comps):
        k = key(self, "g", comps)
        if k not in cache:
            cache[k] = group(self, comps)
        return list(cache[k])

    cls._components = cached_components
    cls._group_into_lines = cached_group


def _tree(boxes):
    return [[list(b.bbox), b.level.value, _tree(b.children)] for b in boxes]


def _flat(per_page, name):
    return {name: np.asarray([b for bs in per_page for b in bs],
                             np.int32).reshape(-1, 4),
            f"{name}_counts": np.asarray(list(map(len, per_page)), np.int32)}


def legacy_answers(pages, rot, ckpt, det_path):
    """The classic-CV detector's arrays and ``results_legacy``."""
    from kiri_tpu.detect import TextDetector
    from kiri_tpu.detect.legacy import ImageProcessingTextDetector
    from kiri_tpu.pipeline import OCR
    from kiri_tpu_torch.smoke import tint

    _cache_legacy_stages(ImageProcessingTextDetector)
    color = tint(pages[COLOR_FROM])
    every = list(pages) + list(rot) + [color]
    det = ImageProcessingTextDetector()
    out = {"color_page": color}
    for name, fn in (("legacy_lines", det.detect_lines),
                     ("legacy_words", det.detect_words),
                     ("legacy_blocks", det.detect_blocks),
                     ("legacy_chars", det.detect_characters)):
        t0 = time.perf_counter()
        out.update(_flat([fn(p) for p in every], name))
        print(f"{name}: {out[name + '_counts'].tolist()} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    out["legacy_all"] = np.asarray(json.dumps(
        [_tree(det.detect_all(p)) for p in every]))
    desk = TextDetector("legacy", deskew=True)
    boxes, twins, angles = [], [], []
    for p in rot:
        boxes.append([b.bbox for b in desk.detect_lines_objects(p)])
        assert desk.last_deskew_angle, "legacy: deskew did not fire"
        twins.append([b.bbox for b in desk.last_deskew_boxes])
        angles.append(desk.last_deskew_angle)
    out.update(_flat(boxes, "legacy_deskew_boxes"))
    out["legacy_deskew_twins"] = _flat(twins, "t")["t"]
    out["legacy_deskew_counts"] = out.pop("legacy_deskew_boxes_counts")
    out["legacy_deskew_angle"] = np.asarray(angles, np.float64)
    db = TextDetector("db", det_path)
    assert db.method == "db", "kiri_tpu fell back to another detector"
    out.update(_flat([db.detect_blocks(p) for p in list(pages) + list(rot)],
                     "db_blocks"))
    results = {}
    for name, kw, mode in LEGACY_RUNS:
        t0 = time.perf_counter()
        OCR._model_cache.clear()
        ocr = OCR(ckpt, det_model_path=det_path, **kw)
        results[name] = [ocr.process_document(p, mode=mode) for p in every]
        print(f"{name}: {sum(map(len, results[name]))} regions in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    out["results_legacy"] = np.asarray(json.dumps(results,
                                                  ensure_ascii=False))
    return out


def add_missing() -> None:
    """``--add``: the arrays of ``LEGACY_KEYS`` the committed file lacks,
    from the committed pages."""
    from kiri_tpu_torch.smoke import load_smoke_pages

    with np.load(OUT) as f:
        old = {k: f[k] for k in f.files}
    if all(k in old for k in LEGACY_KEYS):
        print("nothing to add")
        return
    sp = load_smoke_pages()
    pages = [p["image"] for p in sp["pages"]]
    rot = [p["image"] for p in sp["rot_pages"]]
    models = REPO / "models"
    new = legacy_answers(pages, rot, str(models / "model.safetensors"),
                         str(models / "detector.safetensors"))
    old.update({k: v for k, v in new.items() if k not in old})
    np.savez_compressed(OUT, **old)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


def main() -> None:
    import cv2
    import jax

    jax.config.update("jax_platforms", "cpu")
    cv2.ipp.setUseIPP(False)
    if "--add" in sys.argv[1:]:
        add_missing()
        return
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
    charset = "".join(t for t in tok.token_to_id
                      if len(t) == 1 and t.isascii() and t.isprintable())
    docs, specs = render_pages(charset)
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

    t0 = time.perf_counter()
    rot_docs, rot_uprights, rot_specs = render_rotated(charset)
    out.update(craft_and_deskew(pages, rot_docs, rot_uprights, rot_specs,
                                ckpt, det_path,
                                str(REPO / "models" / "craft.safetensors")))
    print(f"rotated pages, CRAFT and deskew: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    out.update(legacy_answers(
        pages, [np.ascontiguousarray(d["image"], np.uint8) for d in rot_docs],
        ckpt, det_path))

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
