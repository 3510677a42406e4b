"""Store the model-files fixture that `kiri_tpu_torch` is held to on the card
(the GPU machine has no JAX, no safetensors and no cv2):

    python scripts/make_torch_smoke_models.py

writes ``kiri_tpu_torch/assets/smoke_models.npz`` with ``kiri_tpu``'s
answers for

* the four other formats of ``models/model.safetensors`` that
  ``kiri_tpu_torch.smoke.write_model_formats`` writes (F16 ``.safetensors``
  with its meta, F32 without one, the ``{"config", "model"}`` ``.pt`` and a
  bare state-dict ``.pt``): ``cfgs`` (each file's loaded config, JSON),
  ``<fmt>_{ctc,decoder}_{texts,conf}_f32`` over the 64 smoke lines, and
  ``pt_ocr``: ``OCR(<pt_config>, preprocess="device")``'s float32 "fast"
  results on the pages ``PT_OCR_PAGES``. The meta-less and ``.pt`` loads
  infer the config from the shapes (4 heads for v13, whose meta says 8):
  their answers are ``kiri_tpu``'s for that model, not the committed one's;
* ``KiriOCR.from_checkpoint`` in float32: ``kiri_logits_f32``
  (``ctc_logits(encode(x))`` of the first ``KIRI_LINES`` smoke lines cut to
  48 x ``KIRI_WIDTH``) and ``kiri_num_params``;
* the PP-OCR DB graph of ``kiri_tpu_torch.smoke.build_ppocr_det`` (seed
  ``ONNX_SEED``, conditioned, head gain and bias ``ONNX_HEAD_GAIN``,
  ``ONNX_HEAD_BIAS``), written here with ``kiri_tpu``'s wire writer:
  ``onnx_sha256`` of its bytes (3.9 MB; the card rebuilds it), the u16 maps
  ``onnx_map_<i>`` of ``DBDetector(det.onnx)`` on the pages ``ONNX_PAGES``,
  ``onnx_margin_<i>`` (the fewest u16 counts between the map and the 0.3
  threshold, and the least distance of a box score from 0.5, in
  probability), ``onnx_quads`` (``detect_text``'s quads and scores), and
  ``onnx_ocr``: ``OCR(det_model_path=det.onnx)``'s float32 "fast" results
  on ``ONNX_OCR_PAGES``;
* ``khmer_cluster_cer``: ``corpus_cluster_cer(texts, batch_texts_f32)`` of
  the smoke lines (``smoke_lines.npz``);
* ``versions``: numpy, torch and JAX.

It runs on the CPU with JAX (a few minutes on 8 cores), with cv2's IPP off as
the page fixture was made. It refuses to overwrite the committed file:
delete it first when the checkpoints, the lines or the pages change.
"""
from __future__ import annotations

import hashlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _results(res):
    return [[{k: (v.tolist() if isinstance(v, np.ndarray) else v)
              for k, v in r.items()} for r in page] for page in res]


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import cv2
    import jax.numpy as jnp
    import torch

    cv2.ipp.setUseIPP(False)
    from kiri_tpu.config import CFG
    from kiri_tpu.detect.db import DBDetector
    from kiri_tpu.engine import RecognizerEngine
    from kiri_tpu.models.recognizer import KiriOCR
    from kiri_tpu.ops.preprocess import invert_if_dark
    from kiri_tpu.pipeline import OCR
    from kiri_tpu.tokenizer import CharTokenizer
    from kiri_tpu.train.checkpoints import find_vocab_file, load_checkpoint
    from kiri_tpu.utils import onnx_pb
    from kiri_tpu.utils.khmer import corpus_cluster_cer
    from kiri_tpu_torch import smoke as S

    if S.SMOKE_MODELS.exists():
        sys.exit(f"{S.SMOKE_MODELS} exists: delete it first to remake it")
    ckpt = REPO / "models" / "model.safetensors"
    det_path = str(REPO / "models" / "detector.safetensors")
    lines, _ = S.load_smoke_lines()
    imgs, widths = lines["imgs"], lines["widths"]
    pages = [p["image"] for p in S.load_smoke_pages()["pages"]]
    tmp = Path(tempfile.mkdtemp(prefix="kiri_models_"))
    out, cfgs = {}, {}

    files = S.write_model_formats(ckpt, tmp)
    for fmt, path in files.items():
        variables, cfg, meta = load_checkpoint(path)
        cfgs[fmt] = cfg.to_dict()
        tok = CharTokenizer(find_vocab_file(meta.get("vocab_path", ""),
                                            path), cfg)
        eng = RecognizerEngine(variables, cfg.replace(
            COMPUTE_DTYPE="float32"), tok)
        for m in ("ctc", "decoder"):
            res = eng.recognize_batch(imgs, m, widths=widths)
            out[f"{fmt}_{m}_texts_f32"] = np.asarray([t for t, _ in res])
            out[f"{fmt}_{m}_conf_f32"] = np.asarray([c for _, c in res],
                                                    np.float32)
        print(fmt, cfg.ENC_HEADS, cfg.KHMER_VISUAL_ORDER, flush=True)
    OCR._model_cache.clear()
    ocr = OCR(files["pt_config"], det_model_path=det_path,
              decode_method="fast", use_fp16=False, preprocess="device")
    pt_ocr = _results([ocr.process_document(pages[i])
                       for i in S.PT_OCR_PAGES])

    meta = json.loads((REPO / "models" / "model_meta.json").read_text())
    cfg32 = CFG.from_dict(meta["config"]).replace(COMPUTE_DTYPE="float32")
    kiri = KiriOCR.from_checkpoint(str(ckpt), cfg=cfg32)
    x = imgs[:S.KIRI_LINES, :, :S.KIRI_WIDTH]
    out["kiri_logits_f32"] = np.asarray(kiri.ctc_logits(kiri.encode(
        jnp.asarray(x))), np.float32)
    out["kiri_num_params"] = np.asarray(kiri.num_params(), np.int64)

    data = S.build_ppocr_det(seed=S.ONNX_SEED, conditioned=True,
                             head_gain=S.ONNX_HEAD_GAIN,
                             head_bias=S.ONNX_HEAD_BIAS, pb=onnx_pb)
    out["onnx_sha256"] = np.asarray(hashlib.sha256(data).hexdigest())
    onnx_path = tmp / "det.onnx"
    onnx_path.write_bytes(data)
    det = DBDetector(str(onnx_path))
    quads = {}
    for i in S.ONNX_PAGES:
        gray = invert_if_dark(det._to_gray(pages[i]))
        canvas, (nh, nw), _ = det._resize_image(gray)
        wire = np.asarray(det._fwd(det.variables, jnp.asarray(canvas)))
        out[f"onnx_map_{i}"] = wire
        res = det.detect_text(pages[i])
        quads[str(i)] = [[q.tolist(), float(s)] for q, s in res]
        _, scores = det.detect(pages[i], return_scores=True)
        thr = det.det_db_thresh * 65535.0
        out[f"onnx_margin_{i}"] = np.asarray(
            [np.abs(wire[:nh, :nw].astype(np.float64) - thr).min(),
             min([abs(s - det.det_db_box_thresh) for s in scores] or [1.0])])
        print(f"onnx page {i}: canvas {canvas.shape}, {len(res)} boxes, "
              f"margin {out[f'onnx_margin_{i}']}", flush=True)
    OCR._model_cache.clear()
    ocr = OCR(str(ckpt), det_model_path=str(onnx_path), decode_method="fast",
              use_fp16=False)
    onnx_ocr = _results([ocr.process_document(pages[i])
                         for i in S.ONNX_OCR_PAGES])

    texts = [str(t) for t in lines["texts"]]
    out["khmer_cluster_cer"] = np.asarray(corpus_cluster_cer(
        texts, [str(t) for t in lines["batch_texts_f32"]]), np.float64)
    out.update({
        "cfgs": np.asarray(json.dumps(cfgs)),
        "pt_ocr": np.asarray(json.dumps(pt_ocr)),
        "onnx_ocr": np.asarray(json.dumps(onnx_ocr)),
        "onnx_quads": np.asarray(json.dumps(quads)),
        "versions": np.asarray(json.dumps({
            "numpy": np.__version__, "torch": torch.__version__,
            "jax": jax.__version__})),
    })
    S.SMOKE_MODELS.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(S.SMOKE_MODELS, **out)
    print(f"wrote {S.SMOKE_MODELS} "
          f"({S.SMOKE_MODELS.stat().st_size / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
