"""Store the generators fixture that `kiri_tpu_torch`'s synthetic-data
generators are held to on the card (the GPU machine has no JAX, no Pillow,
no cv2 and no fonts):

    python scripts/make_torch_smoke_gen.py

writes ``kiri_tpu_torch/assets/smoke_gen.npz``, made with ``kiri_tpu`` on the
CPU with font discovery off (``kiri_tpu.data.synth._FONT_DIRS`` emptied in
this process) and cv2's IPP off, so that every document and line is drawn with the
pseudo-glyph pool, as the port draws on a machine without Pillow. Digests
are SHA-256 of an array's dtype, shape and bytes
(``kiri_tpu_torch.smoke.digest``); PNGs are digested as their decoded
pixels. The sizes and seeds are ``kiri_tpu_torch.smoke``'s ``GEN_*``.

* ``versions``: the Pillow, cv2 and numpy the answers were made with;
* (a) ``lines_labels``, ``lines_digests``: ``labels.txt`` and the 64 images of
  ``MultilingualDatasetGenerator(khmer_ratio=0.5, sign_boost=0.3, seed=42,
  fonts=FontManager(font_dirs=[])).generate_dataset(64)``; ``lines_first``:
  the first image;
* (b) ``docs``: a JSON string ``{key: {digest, lines, texts, chars}}`` of one
  ``DocumentGenerator(640, 640, khmer_ratio=0.4)`` document per layout
  (key ``layout``, made in ``LAYOUTS`` order by one generator), each under
  every condition and ``rotated+noisy`` (key ``layout/condition``, the
  conditions' ``random.Random`` seeded by ``cond_seed``), and the first
  through ``rescale_doc`` to 960 x 960 (key ``rescale``); ``doc_first``
  and ``doc_first_rotated``: two whole images;
* (c) ``detector_files``: a JSON string ``{path: digest}`` of every file of
  ``kiri-tpu generate-detector --num-train 8 --num-val 2 --kind both``
  (``annotations.json`` by its bytes);
* (d) ``{db,craft}_batches``: JSON ``[{key: digest}]`` of the two batches of
  the trainers' live pool (``pool_size`` 16, batch 8, ``aug_conditions``
  0.5, CRAFT also ``scale_aug`` 0.5, seed 42, 640 x 640), and
  ``{db,craft}_step0``: JSON of ``kiri_tpu``'s float32 losses from the
  committed detectors on the batch the trainer draws first;
* (e) ``generate_labels`` / ``generate_digest``: ``labels.txt`` and the
  digest of the image digests of ``kiri-tpu generate -n 128``;
* (f) ``eval_rows``: JSON ``{dtype: {condition: {row, texts}}}`` of
  ``evalpage.eval_condition`` over 4 pages of 640 x 640 per condition with
  ``OCR`` on the committed checkpoints, ``f32`` (``use_fp16=False``) and
  ``bf16`` (``use_fp16=True, preprocess="device"``); ``texts`` holds each
  page's (box, text) results.

It runs on the CPU with JAX (about 10 minutes on 8 cores). It refuses to
change an array the committed file already holds: delete the file first when
the generators or the checkpoints change.
"""
from __future__ import annotations

import hashlib
import json
import random
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from kiri_tpu_torch.smoke import (GEN_AUG, GEN_BATCH,  # noqa: E402
                                  GEN_CHAIN, GEN_DOC_SIZE, GEN_DOC_SIZES,
                                  GEN_EVAL_CONDITIONS, GEN_EVAL_PAGES,
                                  GEN_GENERATE, GEN_LINES, GEN_POOL,
                                  GEN_RESCALE, GEN_SCALE_AUG, GEN_SEED,
                                  SMOKE_GEN, cond_seed, digest,
                                  tree_digests)

OUT = SMOKE_GEN
N_LINES, DOC_SIZE, DOC_SIZES = GEN_LINES, GEN_DOC_SIZE, GEN_DOC_SIZES
RESCALE, CHAIN, N_GENERATE = GEN_RESCALE, GEN_CHAIN, GEN_GENERATE
POOL, BATCH, AUG, SCALE_AUG, SEED = (GEN_POOL, GEN_BATCH, GEN_AUG,
                                     GEN_SCALE_AUG, GEN_SEED)
EVAL_CONDITIONS, EVAL_PAGES = GEN_EVAL_CONDITIONS, GEN_EVAL_PAGES


def _doc_entry(doc) -> dict:
    return {"digest": digest(doc["image"]), "lines": doc["lines"],
            "texts": doc["texts"], "chars": doc["chars"]}


def lines_and_docs(out: dict, tmp: Path) -> None:
    from PIL import Image

    from kiri_tpu.data.docsynth import (CONDITIONS, LAYOUTS, DocumentGenerator,
                                        apply_condition, rescale_doc)
    from kiri_tpu.data.synth import FontManager, MultilingualDatasetGenerator

    gen = MultilingualDatasetGenerator(
        str(tmp / "lines"), khmer_ratio=0.5, sign_boost=0.3, seed=SEED,
        fonts=FontManager(font_dirs=[]))
    gen.generate_dataset(N_LINES)
    labels = (tmp / "lines" / "labels.txt").read_text(encoding="utf-8")
    imgs = [np.asarray(Image.open(tmp / "lines" / "images" / row.split("\t")[0]))
            for row in labels.splitlines()]
    out["lines_labels"] = np.asarray(labels)
    out["lines_digests"] = np.asarray([digest(i) for i in imgs])
    out["lines_first"] = imgs[0]

    dg = DocumentGenerator(DOC_SIZE, DOC_SIZE, khmer_ratio=0.4,
                           fonts=FontManager(font_dirs=[], sizes=DOC_SIZES))
    docs = {}
    for layout in LAYOUTS:
        doc = dg.generate(layout)
        docs[layout] = _doc_entry(doc)
        for cond in (*CONDITIONS, CHAIN):
            rng = random.Random(cond_seed(layout, cond))
            d = doc
            for c in cond.split("+"):
                d = apply_condition(d, c, rng)
            docs[f"{layout}/{cond}"] = _doc_entry(d)
            if layout == LAYOUTS[0] and cond == "rotated":
                out["doc_first_rotated"] = d["image"]
        if layout == LAYOUTS[0]:
            out["doc_first"] = doc["image"]
            docs["rescale"] = _doc_entry(rescale_doc(doc, RESCALE, RESCALE))
    out["docs"] = np.asarray(json.dumps(docs, ensure_ascii=False))


def cli_outputs(out: dict, tmp: Path) -> None:
    from kiri_tpu import cli

    cli.main(["generate-detector", "--num-train", "8", "--num-val", "2",
              "--kind", "both", "--output", str(tmp / "det")])
    out["detector_files"] = np.asarray(json.dumps(tree_digests(tmp / "det")))
    cli.main(["generate", "-n", str(N_GENERATE), "-o", str(tmp / "gen")])
    out["generate_labels"] = np.asarray(
        (tmp / "gen" / "labels.txt").read_text(encoding="utf-8"))
    files = tree_digests(tmp / "gen")
    out["generate_digest"] = np.asarray(hashlib.sha256(
        "".join(v for k, v in files.items() if k.endswith(".png"))
        .encode()).hexdigest())


def live_pools(out: dict) -> None:
    import jax.numpy as jnp

    from kiri_tpu.data.docsynth import DocumentGenerator
    from kiri_tpu.detect.craft import load_craft_checkpoint
    from kiri_tpu.detect.craft.train import CRAFTTrainConfig, craft_loss
    from kiri_tpu.detect.craft.train import make_batch as craft_batch
    from kiri_tpu.detect.db import load_db_checkpoint
    from kiri_tpu.detect.db.train import DBTrainConfig, db_loss
    from kiri_tpu.detect.db.train import make_batch as db_batch

    n = POOL // BATCH
    first = int(np.random.default_rng(SEED).integers(n))
    for kind in ("db", "craft"):
        gen = DocumentGenerator(DOC_SIZE, DOC_SIZE, seed=SEED,
                                khmer_ratio=0.3)
        if kind == "db":
            pool = [db_batch(gen, BATCH, DOC_SIZE, AUG) for _ in range(n)]
        else:
            factors = CRAFTTrainConfig().scale_aug_factors
            small = [DocumentGenerator(int(round(DOC_SIZE / f)),
                                       int(round(DOC_SIZE / f)),
                                       seed=SEED + 17 * i, fonts=gen.fonts,
                                       khmer_ratio=0.3)
                     for i, f in enumerate(factors, 1)]
            pool = [craft_batch(gen, BATCH, DOC_SIZE, AUG, None, SCALE_AUG,
                                small) for _ in range(n)]
        out[f"{kind}_batches"] = np.asarray(json.dumps(
            [{k: digest(v) for k, v in b.items()} for b in pool]))
        batch = {k: jnp.asarray(v) for k, v in pool[first].items()}
        if kind == "db":
            tc = DBTrainConfig()
            _, (_, m) = db_loss(
                load_db_checkpoint(REPO / "models" / "detector.safetensors"),
                batch, k=tc.k, alpha=tc.alpha, beta=tc.beta,
                neg_ratio=tc.neg_ratio)
            step0 = {k: float(v) for k, v in m.items()}
        else:
            loss, _ = craft_loss(load_craft_checkpoint(
                REPO / "models" / "craft.safetensors"), batch)
            step0 = {"loss": float(loss)}
        out[f"{kind}_step0"] = np.asarray(json.dumps(step0))
        print(kind, "step 0", step0, flush=True)


class _Recorder:
    """An OCR whose ``process_document`` results are kept."""

    def __init__(self, ocr):
        self.ocr, self.pages = ocr, []

    def process_document(self, img):
        res = self.ocr.process_document(img)
        self.pages.append([[list(map(int, r["box"])), r["text"]]
                           for r in res])
        return res


def eval_rows(out: dict) -> None:
    from kiri_tpu.evalpage import eval_condition
    from kiri_tpu.pipeline import OCR

    ckpt = str(REPO / "models" / "model.safetensors")
    det = str(REPO / "models" / "detector.safetensors")
    rows = {}
    for name, kw in (("f32", dict(use_fp16=False)),
                     ("bf16", dict(use_fp16=True, preprocess="device"))):
        OCR._model_cache.clear()
        ocr = OCR(ckpt, det_model_path=det, **kw)
        rows[name] = {}
        for cond in EVAL_CONDITIONS:
            t0 = time.perf_counter()
            rec = _Recorder(ocr)
            row = eval_condition(rec, cond, EVAL_PAGES, page=DOC_SIZE)
            rows[name][cond] = {"row": row, "texts": rec.pages}
            print(name, row, f"{time.perf_counter() - t0:.1f} s", flush=True)
    out["eval_rows"] = np.asarray(json.dumps(rows, ensure_ascii=False))


def main() -> None:
    import cv2
    import jax
    import PIL

    jax.config.update("jax_platforms", "cpu")
    # cv2's own resize code: with IPP, kiri_tpu's cubic line resize depends
    # on the CPU (tests/test_torch_imgproc.py), and the port follows
    # OpenCV's own code.
    cv2.ipp.setUseIPP(False)
    from kiri_tpu.data import synth

    synth._FONT_DIRS[:] = []
    out: dict = {"versions": np.asarray(json.dumps({
        "Pillow": PIL.__version__, "cv2": cv2.__version__,
        "numpy": np.__version__}))}
    with tempfile.TemporaryDirectory(prefix="kiri_smoke_gen_") as d:
        t0 = time.perf_counter()
        lines_and_docs(out, Path(d))
        cli_outputs(out, Path(d))
        print(f"generators: {time.perf_counter() - t0:.1f} s", flush=True)
    live_pools(out)
    eval_rows(out)
    if OUT.exists():
        with np.load(OUT) as old:
            for k in old.files:
                if k not in out or not np.array_equal(old[k], out[k]):
                    sys.exit(f"{OUT}: {k} would change; delete the file "
                             "first to regenerate it")
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
