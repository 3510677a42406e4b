"""The committed smoke fixtures, for checks on machines that have no text
renderer:

- ``assets/smoke_lines.npz`` (``scripts/make_torch_smoke_lines.py``): 64
  rendered bilingual line crops, their host-preprocessed images, ground
  truth and the JAX package's answers, and 16 of the crops degraded for the
  enhancement path;
- ``assets/smoke_pages.npz`` (``scripts/make_torch_smoke_pages.py``): 9
  rendered bilingual pages, their ground truth and the JAX package's
  detections and ``process_document`` results; 3 rotated pages with its
  deskew answers, and its CRAFT answers on all 12;
- ``assets/smoke_train.npz`` (``scripts/make_torch_smoke_train.py``): the
  JAX package's float32 step-0 losses of the recognizer on 32 smoke lines
  and of DB and CRAFT on 4 generated documents, which ``write_detector_dataset``
  lays out as a ``generate-detector`` directory;
- ``assets/smoke_gen.npz`` (``scripts/make_torch_smoke_gen.py``): digests
  of the JAX package's generated lines, documents under every condition, a
  ``generate-detector`` directory, the detector trainers' live batches,
  their step-0 losses and its ``eval_condition`` rows, all drawn with the
  pseudo-glyph pool.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

SMOKE_LINES = Path(__file__).resolve().parent / "assets" / "smoke_lines.npz"
SMOKE_PAGES = Path(__file__).resolve().parent / "assets" / "smoke_pages.npz"
SMOKE_TRAIN = Path(__file__).resolve().parent / "assets" / "smoke_train.npz"
SMOKE_GEN = Path(__file__).resolve().parent / "assets" / "smoke_gen.npz"
#: What the generators fixture was made with (scripts/make_torch_smoke_gen.py).
GEN_SEED, GEN_LINES, GEN_DOC_SIZE = 42, 64, 640
GEN_DOC_SIZES = (18, 22, 26, 30, 34)
GEN_RESCALE, GEN_CHAIN = 960, "rotated+noisy"
GEN_POOL, GEN_BATCH, GEN_AUG, GEN_SCALE_AUG = 16, 8, 0.5, 0.5
GEN_GENERATE = 128
GEN_EVAL_CONDITIONS = ("clean", "rotated", "noisy", "textured",
                       "low_contrast", "inverted")
GEN_EVAL_PAGES = 4


def _split(flat: np.ndarray, shapes: np.ndarray) -> List[np.ndarray]:
    """Row-major crops concatenated in ``flat`` -> a list of [h, w]."""
    crops, o = [], 0
    for h, w in shapes:
        crops.append(flat[o: o + h * w].reshape(h, w))
        o += h * w
    return crops


def load_smoke_lines() -> Tuple[Dict[str, np.ndarray], List[np.ndarray]]:
    """(every array of the file, the raw crops as a list of [h, w] u8)."""
    with np.load(SMOKE_LINES) as f:
        data = {k: f[k] for k in f.files}
    return data, _split(data["crops_flat"], data["crop_shapes"])


def noisy_crops(data: Dict[str, np.ndarray]
                ) -> Tuple[List[np.ndarray], np.ndarray]:
    """(the degraded crops as a list of [h, w] u8, their sharpen mask)."""
    return (_split(data["noisy_crops_flat"], data["noisy_crop_shapes"]),
            data["noisy_sharpen"])


def _cut(flat: np.ndarray, counts: np.ndarray) -> List[np.ndarray]:
    """Rows of ``flat`` split into consecutive groups of ``counts``."""
    return np.split(flat, np.cumsum(counts)[:-1])


def load_smoke_pages() -> Dict:
    """The committed upright pages in ``pages``, one dict per page:
    ``image`` (u8 [H, W]),
    ``lines`` and ``texts`` (ground truth), ``spec`` (width, height,
    layout, condition, seed, lines from the short-text pool), ``det_quads`` / ``det_scores`` (the JAX
    package's ``DBDetector.detect_text``), ``boxes`` / ``box_conf`` (its
    ``TextDetector.detect_lines_objects``); with ``results`` ({run: one
    result list per page}), ``prob_page`` and ``prob_u16``; the rotated
    pages and CRAFT answers of ``_rotated_and_craft``; and the classic-CV
    detector's answers of ``_add_legacy``."""
    with np.load(SMOKE_PAGES) as f:
        d = {k: f[k] for k in f.files}
    images = _split(d["pages_flat"], d["page_shapes"])
    specs = json.loads(str(d["page_specs"]))
    pages = []
    for i, (img, lines, texts, quads, scores, boxes, conf) in enumerate(zip(
            images, _cut(d["gt_lines"], d["gt_counts"]),
            _cut(d["gt_texts"], d["gt_counts"]),
            _cut(d["det_quads"], d["det_counts"]),
            _cut(d["det_scores"], d["det_counts"]),
            _cut(d["facade_boxes"], d["facade_counts"]),
            _cut(d["facade_conf"], d["facade_counts"]))):
        pages.append({"image": img, "spec": specs[i],
                      "lines": [tuple(map(int, b)) for b in lines],
                      "texts": [str(t) for t in texts], "det_quads": quads,
                      "det_scores": scores,
                      "boxes": [tuple(map(int, b)) for b in boxes],
                      "box_conf": conf})
    out = {"pages": pages, "results": json.loads(str(d["results"])),
           "prob_page": int(d["prob_page"]), "prob_u16": d["prob_u16"],
           **_rotated_and_craft(d)}
    _add_legacy(d, out)
    return out


def _boxes(rows: np.ndarray) -> List[tuple]:
    return [tuple(map(int, b)) for b in rows]


def _rotated_and_craft(d: Dict[str, np.ndarray]) -> Dict:
    """``rot_pages``: the 3 rotated pages (``image``, ``spec``, ``lines``
    and ``upright_lines`` (ground truth in the page's and in the upright
    frame), ``texts``, and per detector in ``deskew``: ``angle``, ``boxes``,
    ``box_conf``, ``twins`` (the upright boxes)); ``skew_angles`` of the 12
    pages (the 9 upright ones, then the rotated); ``craft``: one dict per
    page of the 12 (``quads``, ``scores``, ``boxes``, ``box_conf``);
    ``craft_maps`` {page: float16 [2, h, w]}; ``craft_poly`` (page, list of
    outlines); ``results_rot`` ({run: one result list per page of the
    12})."""
    rot = []
    counts = d["rot_gt_counts"]
    specs = json.loads(str(d["rot_page_specs"]))
    for j, (img, lines, upright, texts) in enumerate(zip(
            _split(d["rot_pages_flat"], d["rot_page_shapes"]),
            _cut(d["rot_gt_lines"], counts), _cut(d["rot_gt_upright"], counts),
            _cut(d["rot_gt_texts"], counts))):
        rot.append({"image": img, "spec": specs[j], "lines": _boxes(lines),
                    "upright_lines": _boxes(upright),
                    "texts": [str(t) for t in texts], "deskew": {}})
    for m in ("db", "craft"):
        n = d[f"deskew_{m}_counts"]
        for page, angle, boxes, conf, twins in zip(
                rot, d[f"deskew_{m}_angle"], _cut(d[f"deskew_{m}_boxes"], n),
                _cut(d[f"deskew_{m}_conf"], n),
                _cut(d[f"deskew_{m}_twins"], n)):
            page["deskew"][m] = {"angle": float(angle),
                                 "boxes": _boxes(boxes), "box_conf": conf,
                                 "twins": _boxes(twins)}
    craft = [{"quads": q, "scores": s, "boxes": _boxes(b), "box_conf": c}
             for q, s, b, c in zip(
                 _cut(d["craft_quads"], d["craft_counts"]),
                 _cut(d["craft_scores"], d["craft_counts"]),
                 _cut(d["craft_boxes"], d["craft_box_counts"]),
                 _cut(d["craft_conf"], d["craft_box_counts"]))]
    poly = _cut(d["craft_poly_pts"], d["craft_poly_sizes"])
    return {"rot_pages": rot, "skew_angles": d["skew_angles"],
            "craft": craft,
            "craft_maps": {int(i): d[f"craft_maps_{int(i)}"]
                           for i in d["craft_map_pages"]},
            "craft_poly": (int(d["craft_poly_page"]), poly),
            "results_rot": json.loads(str(d["results_rot"]))}


def _add_legacy(d: Dict[str, np.ndarray], out: Dict) -> None:
    """``legacy``: ``color_page`` (u8 BGR) and, one list per page of the 13
    (the 9 upright, the 3 rotated, the colour page), the JAX package's
    classic-CV ``lines``, ``words``, ``blocks``, ``chars`` (boxes) and
    ``all`` (``detect_all`` as ``[[x, y, w, h], level, children]``);
    ``results_legacy`` ({run: one result list per page of the 13}); in each
    rotated page's ``deskew["legacy"]`` the ``TextDetector("legacy",
    deskew=True)`` answers; ``db_blocks``: ``detect_blocks`` over DB lines
    of the 12 pages."""
    if "legacy_lines" not in d:
        return
    leg = {"color_page": d["color_page"],
           "all": json.loads(str(d["legacy_all"]))}
    for level in ("lines", "words", "blocks", "chars"):
        leg[level] = [_boxes(b) for b in _cut(
            d[f"legacy_{level}"], d[f"legacy_{level}_counts"])]
    out["legacy"] = leg
    out["results_legacy"] = json.loads(str(d["results_legacy"]))
    out["db_blocks"] = [_boxes(b) for b in _cut(d["db_blocks"],
                                                 d["db_blocks_counts"])]
    n = d["legacy_deskew_counts"]
    for page, angle, boxes, twins in zip(
            out["rot_pages"], d["legacy_deskew_angle"],
            _cut(d["legacy_deskew_boxes"], n),
            _cut(d["legacy_deskew_twins"], n)):
        page["deskew"]["legacy"] = {"angle": float(angle),
                                    "boxes": _boxes(boxes),
                                    "twins": _boxes(twins)}


def tint(gray: np.ndarray) -> np.ndarray:
    """A fixed tint of a grey page, u8 BGR [H, W, 3]: ink to deep blue,
    paper to cream (the fixture's colour page)."""
    g = gray.astype(np.float64) / 255.0
    ink = np.array([150.0, 40.0, 30.0])
    paper = np.array([200.0, 245.0, 250.0])
    return np.rint(ink + (paper - ink) * g[..., None]).astype(np.uint8)


def load_smoke_train() -> Dict[str, np.ndarray]:
    """Every array of ``smoke_train.npz``; ``det_annotations`` parsed."""
    with np.load(SMOKE_TRAIN) as f:
        data = {k: f[k] for k in f.files}
    data["det_annotations"] = json.loads(str(data["det_annotations"]))
    return data


def write_detector_dataset(root, images: np.ndarray, annotations: List[dict]
                           ) -> str:
    """A ``generate-detector`` directory under ``root`` (``images/*.png``,
    ``gt/*.npy`` of both detectors, ``annotations.json``) for u8 pages
    [N, H, W] and their annotations, the ground truth made by the port's
    ``data/docsynth.py``. Returns ``root``."""
    from .data.docsynth import craft_ground_truth, db_ground_truth
    from .utils.imageio import imwrite_png

    root = Path(root)
    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "gt").mkdir(exist_ok=True)
    for img, rec in zip(images, annotations):
        name = rec["image"]
        imwrite_png(root / "images" / name, img)
        maps = dict(zip(("db_prob", "db_thresh", "db_tmask"),
                        db_ground_truth(img.shape, rec["lines"])))
        maps.update(zip(("region", "affinity"),
                        craft_ground_truth(img.shape, rec["chars"])))
        for kind, arr in maps.items():
            np.save(root / "gt" / f"{name}.{kind}.npy", arr)
    (root / "annotations.json").write_text(json.dumps(annotations))
    return str(root)


def digest(a: np.ndarray) -> str:
    """SHA-256 of an array's dtype, shape and bytes."""
    a = np.ascontiguousarray(a)
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def cond_seed(layout: str, cond: str) -> int:
    """The seed of the conditions' ``random.Random`` for one document."""
    import zlib

    return zlib.crc32(f"{layout}/{cond}".encode())


def tree_digests(root) -> Dict[str, str]:
    """{relative path: digest} of a generated directory: PNGs by their
    decoded pixels, ``.npy`` files by their array, other files by their
    bytes."""
    from .utils.imageio import imread_gray

    out = {}
    root = Path(root)
    for p in sorted(root.rglob("*")):
        if not p.is_file():
            continue
        rel = str(p.relative_to(root))
        if p.suffix == ".png":
            out[rel] = digest(imread_gray(p))
        elif p.suffix == ".npy":
            out[rel] = digest(np.load(p))
        else:
            out[rel] = hashlib.sha256(p.read_bytes()).hexdigest()
    return out


def load_smoke_gen() -> Dict:
    """Every array of ``smoke_gen.npz``, its JSON strings parsed."""
    with np.load(SMOKE_GEN) as f:
        data = {k: f[k] for k in f.files}
    for k in ("versions", "docs", "detector_files", "db_batches",
              "craft_batches", "db_step0", "craft_step0", "eval_rows"):
        data[k] = json.loads(str(data[k]))
    for k in ("lines_labels", "generate_labels", "generate_digest"):
        data[k] = str(data[k])
    data["lines_digests"] = [str(x) for x in data["lines_digests"]]
    return data
