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
  pseudo-glyph pool;
- ``assets/smoke_models.npz`` (``scripts/make_torch_smoke_models.py``): the
  JAX package's answers for four other formats of the committed recognizer
  (F16 ``.safetensors`` with its meta, F32 without one, both ``.pt``
  forms), its ``KiriOCR`` logits and parameter count, its maps, boxes and
  texts with the PP-OCR DB graph that ``build_ppocr_det`` writes, and its
  Khmer cluster CER of the smoke lines;
- ``assets/smoke_q8.npz`` (``scripts/make_torch_smoke_q8.py``): the JAX
  package's int8 fast path (``Q8Encoder``) over the 64 smoke lines for
  three ``parts`` sets, calibrated on lines 0-31: its float32 scales, its
  greedy CTC texts in float32 and bfloat16 and its text CER against its own
  reference path (``q8_scales`` gives a set's scales in its form).

``parallel_rank`` is the body of each of the two ranks of
``chip_smoke.py``'s parallel phase (gloo, both on card 0).

``build_ppocr_det`` writes that graph (MobileNetV3-large x0.5, DBFPN(96),
the DB head) from a seed, byte for byte as the JAX package's test builder
does.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

SMOKE_LINES = Path(__file__).resolve().parent / "assets" / "smoke_lines.npz"
SMOKE_PAGES = Path(__file__).resolve().parent / "assets" / "smoke_pages.npz"
SMOKE_TRAIN = Path(__file__).resolve().parent / "assets" / "smoke_train.npz"
SMOKE_GEN = Path(__file__).resolve().parent / "assets" / "smoke_gen.npz"
SMOKE_Q8 = Path(__file__).resolve().parent / "assets" / "smoke_q8.npz"
SMOKE_MODELS = (Path(__file__).resolve().parent / "assets"
                / "smoke_models.npz")
SMOKE_EVALS = Path(__file__).resolve().parent / "assets" / "smoke_evals.npz"
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


def load_smoke_q8() -> Dict[str, np.ndarray]:
    with np.load(SMOKE_Q8) as f:
        return {k: f[k] for k in f.files}


def q8_scales(stored: Dict[str, np.ndarray], parts) -> Dict:
    """A ``parts`` set's stored scales in ``kiri_tpu``'s form (``{"stem":
    [{"inv", "wq", "ws"}] for convs 1-3, "enc": [...]}``), which
    ``convert.q8_scales_from_jax`` takes."""
    key = "_".join(parts)
    stem = [{n: stored[f"{key}_stem{i}_{n}"] for n in ("inv", "wq", "ws")}
            for i in (1, 2, 3) if f"{key}_stem{i}_inv" in stored]
    return {"stem": stem, "enc": list(stored[f"{key}_enc"])}


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


#: What the model-files fixture was made with
#: (scripts/make_torch_smoke_models.py): the recognizer formats, the lines
#: of the KiriOCR check, and the PP-OCR graph with the pages it ran on.
MODEL_FORMATS = ("f16_meta", "f32_nometa", "pt_config", "pt_bare")
KIRI_LINES, KIRI_WIDTH = 8, 320
ONNX_SEED, ONNX_HEAD_GAIN, ONNX_HEAD_BIAS = 3, 0.25, -7.6
ONNX_PAGES = (0, 3, 5)          # canvases 704 x 704, 704 x 576, 960 x 960
ONNX_OCR_PAGES = (0, 3)
PT_OCR_PAGES = (0, 3)


def load_smoke_models() -> Dict:
    """Every array of ``smoke_models.npz``, with its JSON fields
    (``cfgs``, ``onnx_ocr``, ``pt_ocr``, ``versions``) decoded."""
    with np.load(SMOKE_MODELS) as f:
        d = {k: f[k] for k in f.files}
    for k in ("cfgs", "onnx_ocr", "pt_ocr", "onnx_quads", "versions"):
        d[k] = json.loads(str(d[k]))
    return d


def write_model_formats(src, out_dir) -> Dict[str, str]:
    """The recognizer ``src`` (a ``.safetensors`` with its meta) in four
    other formats, each in a directory of its own under ``out_dir`` with
    ``src``'s ``vocab.json`` beside it: ``f16_meta`` (every float tensor
    F16, the meta copied), ``f32_nometa`` (the F32 tensors, no meta),
    ``pt_config`` (``torch.save`` of the reference's ``{"config", "model",
    "vocab_path", "epoch", "step"}``) and ``pt_bare`` (a bare state dict).
    Returns each format's file."""
    import shutil

    import torch

    from .checkpoints import read_safetensors, write_safetensors

    src = Path(src)
    sd = read_safetensors(src)
    meta = json.loads(Path(str(src)[: -len(".safetensors")]
                           + "_meta.json").read_text())
    out = {}
    for fmt in MODEL_FORMATS:
        d = Path(out_dir) / fmt
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(src.parent / "vocab.json", d / "vocab.json")
        if fmt == "f16_meta":
            out[fmt] = write_safetensors(d / "model.safetensors", {
                k: v.astype(np.float16) if v.dtype == np.float32 else v
                for k, v in sd.items()})
            (d / "model_meta.json").write_text(json.dumps(
                {**meta, "vocab_path": "vocab.json"}, indent=2))
        elif fmt == "f32_nometa":
            out[fmt] = write_safetensors(d / "model.safetensors", sd)
        else:
            state = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
            obj = (state if fmt == "pt_bare" else
                   {"config": meta["config"], "model": state,
                    "vocab_path": "vocab.json", "epoch": meta["epoch"],
                    "step": meta["step"]})
            torch.save(obj, str(d / "model.pt"))
            out[fmt] = str(d / "model.pt")
    return out


# ---------------------------------------------------- PP-OCR DB det graph
def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


#: MobileNetV3-large blocks: (kernel, expansion, out, SE, activation, stride).
_MNV3_LARGE = [
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2), (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1), (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1), (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2), (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]


class _DetGraph:
    """Nodes and initializers of the graph, drawn from one generator."""

    def __init__(self, seed: int, pb, conditioned: bool):
        self.rng = np.random.default_rng(seed)
        self.pb = pb
        self.conditioned = conditioned
        self.nodes: list = []
        self.inits: dict = {}
        self.n = 0

    def name(self, tag: str) -> str:
        self.n += 1
        return f"{tag}_{self.n}"

    def emit(self, op: str, ins, **attrs) -> str:
        out = self.name(op.lower())
        self.nodes.append(self.pb.write_node(op, list(ins), [out], name=out,
                                             **attrs))
        return out

    def weight(self, shape, fan_in: int = 0) -> str:
        """Standard normal draws times 0.25, or times 1 / sqrt(fan_in) for
        a weight of ``fan_in`` inputs when ``conditioned``."""
        name = self.name("w")
        scale = (fan_in ** -0.5 if self.conditioned and fan_in else 0.25)
        self.inits[name] = (self.rng.standard_normal(shape) * scale
                            ).astype(np.float32)
        return name

    def conv_bn(self, x, cin, cout, k, stride, act, groups=1):
        """Conv (no bias) + BatchNormalization + activation."""
        w = self.weight((cout, cin // groups, k, k), cin // groups * k * k)
        y = self.emit("Conv", [x, w], kernel_shape=[k, k],
                      strides=[stride, stride], pads=[(k - 1) // 2] * 4,
                      group=groups)
        names = [self.name(t) for t in ("bn_s", "bn_b", "bn_m", "bn_v")]
        r = self.rng
        self.inits[names[0]] = (np.abs(r.standard_normal(cout)) + 0.5
                                ).astype(np.float32)
        self.inits[names[1]] = r.standard_normal(cout).astype(np.float32)
        self.inits[names[2]] = (r.standard_normal(cout) * 0.1
                                ).astype(np.float32)
        self.inits[names[3]] = (np.abs(r.standard_normal(cout)) + 0.5
                                ).astype(np.float32)
        y = self.emit("BatchNormalization", [y] + names)
        if act == "relu":
            y = self.emit("Relu", [y])
        elif act == "hardswish":
            y = self.emit("HardSwish", [y])
        return y

    def se(self, x, c):
        """Squeeze-excite with Paddle's hard sigmoid (slope 0.2)."""
        mid = _make_divisible(c // 4)
        g = self.emit("GlobalAveragePool", [x])
        w1, b1 = self.weight((mid, c, 1, 1), c), self.weight((mid,))
        s1 = self.emit("Relu", [self.emit("Conv", [g, w1, b1],
                                          kernel_shape=[1, 1])])
        w2, b2 = self.weight((c, mid, 1, 1), mid), self.weight((c,))
        s2 = self.emit("Conv", [s1, w2, b2], kernel_shape=[1, 1])
        gate = self.emit("HardSigmoid", [s2], alpha=0.2, beta=0.5)
        return self.emit("Mul", [x, gate])

    def residual_unit(self, x, cin, mid, cout, k, stride, use_se, act):
        y = self.conv_bn(x, cin, mid, 1, 1, act)
        y = self.conv_bn(y, mid, mid, k, stride, act, groups=mid)
        if use_se:
            y = self.se(y, mid)
        y = self.conv_bn(y, mid, cout, 1, 1, None)
        if stride == 1 and cin == cout:
            y = self.emit("Add", [x, y])
        return y

    def upsample(self, x, factor):
        """Resize nearest + asymmetric, the exporter's FPN upsample."""
        sc, roi = self.name("scales"), self.name("roi")
        self.inits[sc] = np.array([1, 1, factor, factor], np.float32)
        self.inits[roi] = np.zeros((0,), np.float32)
        return self.emit("Resize", [x, roi, sc], mode="nearest",
                         coordinate_transformation_mode="asymmetric",
                         nearest_mode="floor")


def build_ppocr_det(seed: int = 3, scale: float = 0.5, neck_ch: int = 96,
                    head_bias: Optional[float] = None,
                    conditioned: bool = False, head_gain: float = 1.0,
                    pb=None) -> bytes:
    """The PP-OCR DB det graph's ONNX bytes: MobileNetV3-large (``scale``),
    DBFPN(``neck_ch``) and the DB head (conv-BN-ReLU, two stride-2
    ConvTransposes, sigmoid), random weights drawn from ``seed``. With
    ``head_bias`` the last ConvTranspose's bias is that value instead of
    its draw, and ``head_gain`` scales its weights. ``conditioned`` draws
    the convolutions' weights at 1 / sqrt(fan in) instead of 0.25 and makes
    each 2 x 2 kernel of the head's ConvTransposes one value (its first
    draw), so that the maps of the deep random net stay unsaturated and
    hold 4 x 4 blocks, which the DB geometry turns into boxes; the default
    is the JAX package's test graph. ``pb`` is the wire writer (the port's
    ``onnx_pb`` by default; the fixture script passes the JAX
    package's)."""
    if pb is None:
        from .utils import onnx_pb as pb
    b = _DetGraph(seed, pb, conditioned)
    cin = _make_divisible(16 * scale)
    y = b.conv_bn("x", 3, cin, 3, 2, "hardswish")
    feats = []
    for i, (k, exp, out, use_se, act, stride) in enumerate(_MNV3_LARGE):
        mid = _make_divisible(exp * scale)
        cout = _make_divisible(out * scale)
        if stride == 2 and i > 1:       # taps C2..C4 at /4, /8, /16
            feats.append((y, cin))
        y = b.residual_unit(y, cin, mid, cout, k, stride, use_se, act)
        cin = cout
    last = _make_divisible(960 * scale)
    feats.append((b.conv_bn(y, cin, last, 1, 1, "hardswish"), last))

    ins = [b.emit("Conv", [f, b.weight((neck_ch, c, 1, 1), c)],
                  kernel_shape=[1, 1]) for f, c in feats]
    outs = [ins[3]]
    for i in (2, 1, 0):                 # top-down pathway
        outs.append(b.emit("Add", [ins[i], b.upsample(outs[-1], 2)]))
    ps = []
    for j, o in enumerate(outs):        # /32 /16 /8 /4 -> all at /4
        p = b.emit("Conv", [o, b.weight((neck_ch // 4, neck_ch, 3, 3),
                                        9 * neck_ch)],
                   kernel_shape=[3, 3], pads=[1] * 4)
        ps.append(b.upsample(p, 2 ** (3 - j)) if j < 3 else p)
    fuse = b.emit("Concat", ps, axis=1)

    c4 = neck_ch // 4
    y = b.conv_bn(fuse, neck_ch, c4, 3, 1, "relu")
    for stage in range(2):
        cout = 1 if stage == 1 else c4
        wt, bt = b.weight((c4, cout, 2, 2), c4), b.weight((cout,))
        if conditioned:
            b.inits[wt] = np.ascontiguousarray(np.broadcast_to(
                b.inits[wt][:, :, :1, :1], (c4, cout, 2, 2)))
        if stage == 1:
            b.inits[wt] = (b.inits[wt] * np.float32(head_gain)).astype(
                np.float32)
            if head_bias is not None:
                b.inits[bt] = np.full((cout,), head_bias, np.float32)
        y = b.emit("ConvTranspose", [y, wt, bt], kernel_shape=[2, 2],
                   strides=[2, 2])
        if stage == 0:
            names = [b.name(t) for t in ("hbn_s", "hbn_b", "hbn_m", "hbn_v")]
            for nm, v in zip(names, (1.0, 0.0, 0.0, 1.0)):
                b.inits[nm] = np.full(c4, v, np.float32)
            y = b.emit("Relu", [b.emit("BatchNormalization", [y] + names)])
    prob = b.emit("Sigmoid", [y])
    return pb.write_model(b.nodes, b.inits, [("x", [None, 3, None, None])],
                          [(prob, [None, 1, None, None])], opset=13)


MODELS = Path(__file__).resolve().parent.parent / "models"
#: The parallel phase's training runs: DP steps, TP steps, the batch.
PAR_DP_STEPS, PAR_TP_STEPS = 3, 1


def parallel_train_batch(tok, cfg):
    """The recognizer batch of the parallel phase: the 32 lines of
    ``smoke_train.npz``'s ``rec_idx``, full width."""
    from .train.trainer import collate

    d, _ = load_smoke_lines()
    st = load_smoke_train()
    samples = [{"image": d["imgs"][i], "text": str(d["texts"][i])}
               for i in st["rec_idx"]]
    return collate(samples, tok, 512, img_hw=(cfg.IMG_H, cfg.IMG_W))


def parallel_rank(tmp: str, det_dir: str, timed_reps: int = 5) -> Dict:
    """One rank of a model axis of 2 over the ranks (TP = 2), then a data
    axis of 2 (DP = 2), on the committed checkpoint and smoke lines:

    - the TP engine in float32 and bf16: ``recognize_batch`` "ctc" and
      "decoder" with the width buckets, ``recognize_crops`` "ctc" (the
      kernels' launch counts of these runs, and the ms of a timed bf16
      "ctc" batch);
    - ``PAR_DP_STEPS`` float32 steps at DP = 2 and ``PAR_TP_STEPS`` at
      TP = 2 (DROPOUT 0, TF32 off), the metrics and the whole weights;
    - ``save_sharded`` of the TP trainer by every rank, ``restore_sharded``
      onto the mesh (each rank's shards must come back) and whole, and
      ``to_reference`` on rank 0;
    - one data-parallel step of the DB trainer on the fixture's documents.
    """
    import time

    import torch

    from . import parallel as P
    from .checkpoints import find_vocab_file, load_checkpoint
    from .detect.db import load_db_checkpoint
    from .detect.db.net import build_db_net
    from .detect.db.train import DBTrainConfig, train_db
    from .engine import RecognizerEngine
    from .kernels import launch_counts, reset_launch_counts
    from .tokenizer import CharTokenizer
    from .train import sharded_ckpt as S
    from .train import trainer as T

    dev = P.process_device()
    rank, world = P.process_info()
    ckpt = MODELS / "model.safetensors"
    d, crops = load_smoke_lines()
    imgs, widths = d["imgs"], d["widths"]
    model, cfg, meta = load_checkpoint(ckpt, device=dev)
    vocab = find_vocab_file(meta.get("vocab_path", ""), str(ckpt))
    tok = CharTokenizer(vocab, cfg)
    tp = P.make_mesh(world, world)
    out: Dict = {"rank": rank}
    reset_launch_counts()
    for dtype in ("float32", "bfloat16"):
        eng = RecognizerEngine(model, cfg.replace(COMPUTE_DTYPE=dtype), tok,
                               dev, mesh=tp)
        out[dtype] = {
            "batch": eng.recognize_batch(imgs, "ctc", widths),
            "batch_decoder": eng.recognize_batch(imgs, "decoder", widths),
            "crops": eng.recognize_crops(crops, "ctc")}
    out["launches"] = launch_counts()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    eng.recognize_batch(imgs, "ctc", widths)
    sync()
    t0 = time.perf_counter()
    for _ in range(timed_reps):
        eng.recognize_batch(imgs, "ctc", widths)
    sync()
    out["tp_batch_ms"] = (time.perf_counter() - t0) * 1e3 / timed_reps
    del eng

    cfg32 = cfg.replace(COMPUTE_DTYPE="float32", DROPOUT=0.0)
    batch = parallel_train_batch(tok, cfg32)

    def trainer(mp):
        fresh, _, _ = load_checkpoint(ckpt, device=dev)
        return T.Trainer(cfg32, tok, T.TrainConfig(n_devices=world,
                                                   model_parallel=mp),
                         model=fresh, device=dev)

    tr = trainer(1)
    out["dp"] = [tr.run_step(batch) for _ in range(PAR_DP_STEPS)]
    out["dp_state"] = {k: v.detach().cpu().numpy() for k, v in
                       tr.model.state_dict().items()}
    del tr
    tr = trainer(world)
    out["tp"] = [tr.run_step(batch) for _ in range(PAR_TP_STEPS)]
    root = Path(tmp) / "sharded"
    S.save_sharded(root, tr.model, cfg32, vocab_path=vocab,
                   step=PAR_TP_STEPS, opt_state=tr.opt_state(whole=False))
    local, _, _, opt = S.restore_sharded(root, mesh=tr.mesh,
                                         with_opt_state=True, device=dev)
    mine = tr.model.state_dict()
    out["restored_shards_equal"] = all(
        torch.equal(v, mine[k]) for k, v in local.state_dict().items())
    own = tr.opt_state(whole=False)
    out["restored_moments_equal"] = set(opt) == set(own) and all(
        np.array_equal(opt[k].cpu().numpy(), own[k]) for k in own)
    whole = tr.whole_model()
    out["files"] = sorted(p.name for p in (root / "state").iterdir())
    if rank == 0:
        S.to_reference(root, Path(tmp) / "reference.safetensors")
    out["tp_state"] = {k: v.detach().cpu().numpy()
                       for k, v in whole.state_dict().items()}
    del tr, whole, local

    hist: List[Dict[str, float]] = []
    train_db(DBTrainConfig(data_dir=det_dir, steps=1, batch_size=4,
                           n_devices=world, log_every=0,
                           out_dir=str(Path(tmp) / f"db{rank}")),
             verbose=False, net=build_db_net(load_db_checkpoint(
                 str(MODELS / "detector.safetensors"))), device=dev,
             history=hist)
    out["db"] = hist
    return out


#: What the evals fixture was made with (scripts/make_torch_smoke_evals.py):
#: ``eval_recognizer`` lines and methods, documents a row of
#: ``eval_detector``, pages a condition of ``eval_pipeline`` (with deskew
#: and enhance) and the recipe's flags for ``build_samples``.
EVAL_LINES = 64
EVAL_METHODS = ("fast", "accurate", "beam")
EVAL_DET_DOCS = 2
EVAL_PAGES = 2
EVAL_CONDITIONS = ("clean", "rotated", "low_contrast", "noisy",
                   "rotated+noisy")
RECIPE_ARGV = ("--samples", "256", "--doc-crop-ratio", "0.25",
               "--aug-conditions", "0.5", "--small-render-ratio", "0.2",
               "--small-resample", "0.5", "--enhance-ratio", "0.2",
               "--visual-order")


def load_smoke_evals() -> Dict:
    """The evals fixture: one JSON document (see
    ``scripts/make_torch_smoke_evals.py``)."""
    with np.load(SMOKE_EVALS) as f:
        return json.loads(str(f["evals"]))
