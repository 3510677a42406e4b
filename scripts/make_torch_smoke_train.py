"""Store the training fixture that `kiri_tpu_torch`'s trainers are held to on
the card (the GPU machine has no JAX, no PIL and no text renderer):

    python scripts/make_torch_smoke_train.py [--add]

writes ``kiri_tpu_torch/assets/smoke_train.npz`` with

* ``rec_idx``: the 32 smoke lines (``smoke_lines.npz``, width 640) of the
  recognizer's fixed batch, and ``rec_step0_{loss,ctc_loss,dec_loss,
  grad_norm}``: ``kiri_tpu``'s float32 step-0 hybrid loss on it from
  ``models/model.safetensors`` (DROPOUT 0, no decoder-input noise), and the
  global norm of its gradient;
* ``rec_step0_f64_{loss,ctc_loss,dec_loss,grad_norm}``: the same step of
  ``kiri_tpu`` in float64 (``--add`` computes these alone, in a process of
  their own, and keeps every other array as it is): the reference that the
  port's float32 step is held to, since ``kiri_tpu``'s float32 sums lie
  ~1.6e-4 (relative) from it on a loss of 0.009;
* ``det_images`` [4, 640, 640] u8 and ``det_annotations`` (JSON): four
  documents of ``kiri_tpu.data.docsynth.generate_detector_dataset`` (seed
  ``DET_SEED``), from which the port writes a ``generate-detector``
  directory with its own ground truth;
* ``db_step0_{loss,prob_loss,bin_loss,thresh_loss}`` and
  ``craft_step0_loss``: ``kiri_tpu``'s float32 losses of that batch of four
  from ``models/detector.safetensors`` and ``models/craft.safetensors``.

It runs on the CPU with JAX (about 3 minutes on 8 cores). It refuses to
change an array the committed file already holds: delete the file first when
the checkpoints or the generator change.
"""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

OUT = REPO / "kiri_tpu_torch" / "assets" / "smoke_train.npz"
N_REC = 32
N_DOCS = 4
DET_SIZE = 640
DET_SEED = 20261017


def recognizer_step0(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    import optax

    from kiri_tpu.tokenizer import CharTokenizer
    from kiri_tpu.train.checkpoints import find_vocab_file, load_checkpoint
    from kiri_tpu.train.trainer import collate, hybrid_loss

    ckpt = str(REPO / "models" / "model.safetensors")
    variables, cfg, meta = load_checkpoint(ckpt)
    cfg = cfg.replace(COMPUTE_DTYPE="float32", DROPOUT=0.0)
    tok = CharTokenizer(find_vocab_file(meta.get("vocab_path", ""), ckpt), cfg)
    with np.load(REPO / "kiri_tpu_torch" / "assets" / "smoke_lines.npz") as f:
        imgs, texts = f["imgs"], [str(t) for t in f["texts"]]
    idx = np.arange(N_REC, dtype=np.int32)
    batch = collate([{"image": imgs[i], "text": texts[i]} for i in idx], tok,
                    512, img_hw=(cfg.IMG_H, cfg.IMG_W))

    def loss_fn(params):
        v = {**variables, "params": params}
        loss, (_, metrics) = hybrid_loss(
            v, {k: jnp.asarray(x) for k, x in batch.items()},
            jax.random.PRNGKey(0), cfg=cfg, dec_pad=tok.dec_pad,
            ctc_weight=0.5, dec_weight=0.5)
        return loss, metrics

    (_, metrics), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    out["rec_idx"] = idx
    for k in ("loss", "ctc_loss", "dec_loss"):
        out[f"rec_step0_{k}"] = np.float64(metrics[k])
    out["rec_step0_grad_norm"] = np.float64(optax.global_norm(grads))
    print({k: float(v) for k, v in out.items() if k.startswith("rec_step0")})


def kiri_tpu_float32_as_float64(set_attr=setattr) -> None:
    """Make the modules of ``kiri_tpu``'s train step see a ``jnp`` whose
    ``float32`` is ``float64`` (through ``set_attr``, so that a test can
    undo it): under JAX's 64-bit types its casts to float32 (the compute
    dtype, BatchNorm's and the losses' float32) become casts to float64.
    The package's files are not touched."""
    import types

    import jax.numpy as jnp

    from kiri_tpu.models import layers, recognizer
    from kiri_tpu.ops import ctc
    from kiri_tpu.train import trainer

    wide = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                    if not k.startswith("__")})
    wide.float32 = jnp.float64
    for mod in (layers, recognizer, ctc, trainer):
        set_attr(mod, "jnp", wide)


def recognizer_step0_f64(out: dict) -> None:
    """``recognizer_step0``'s step in float64 (see
    ``kiri_tpu_float32_as_float64``)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    kiri_tpu_float32_as_float64()
    import jax.numpy as jnp
    import optax

    from kiri_tpu.tokenizer import CharTokenizer
    from kiri_tpu.train.checkpoints import find_vocab_file, load_checkpoint
    from kiri_tpu.train.trainer import collate, hybrid_loss

    ckpt = str(REPO / "models" / "model.safetensors")
    variables, cfg, meta = load_checkpoint(ckpt)
    variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                             variables)
    cfg = cfg.replace(COMPUTE_DTYPE="float32", DROPOUT=0.0)
    tok = CharTokenizer(find_vocab_file(meta.get("vocab_path", ""), ckpt), cfg)
    with np.load(REPO / "kiri_tpu_torch" / "assets" / "smoke_lines.npz") as f:
        imgs, texts = f["imgs"], [str(t) for t in f["texts"]]
    batch = collate([{"image": imgs[i], "text": texts[i]}
                     for i in range(N_REC)], tok, 512,
                    img_hw=(cfg.IMG_H, cfg.IMG_W))

    def loss_fn(params):
        v = {**variables, "params": params}
        loss, (_, metrics) = hybrid_loss(
            v, {k: jnp.asarray(x) for k, x in batch.items()},
            jax.random.PRNGKey(0), cfg=cfg, dec_pad=tok.dec_pad,
            ctc_weight=0.5, dec_weight=0.5)
        return loss, metrics

    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    assert loss.dtype == jnp.float64, loss.dtype
    assert all(g.dtype == jnp.float64 for g in jax.tree.leaves(grads))
    for k in ("loss", "ctc_loss", "dec_loss"):
        out[f"rec_step0_f64_{k}"] = np.float64(metrics[k])
    out["rec_step0_f64_grad_norm"] = np.float64(optax.global_norm(grads))
    print({k: float(v) for k, v in out.items() if "step0_f64" in k})


def detector_step0(out: dict) -> None:
    import jax.numpy as jnp

    from kiri_tpu.data.docsynth import (generate_detector_dataset,
                                        load_detector_batches)
    from kiri_tpu.detect.craft import load_craft_checkpoint
    from kiri_tpu.detect.craft.train import craft_loss
    from kiri_tpu.detect.db import load_db_checkpoint
    from kiri_tpu.detect.db.train import DBTrainConfig, db_loss
    from PIL import Image

    root = Path(tempfile.mkdtemp(prefix="kiri_smoke_det_"))
    generate_detector_dataset(str(root), N_DOCS, DET_SIZE, DET_SIZE,
                              seed=DET_SEED)
    ann = json.loads((root / "annotations.json").read_text())
    out["det_images"] = np.stack([
        np.asarray(Image.open(root / "images" / a["image"]).convert("L"))
        for a in ann])
    out["det_annotations"] = np.asarray(json.dumps(ann))

    tc = DBTrainConfig()
    batch = {k: jnp.asarray(v) for k, v in
             load_detector_batches(str(root), "db", N_DOCS)[0].items()}
    _, (_, m) = db_loss(load_db_checkpoint(REPO / "models"
                                           / "detector.safetensors"),
                        batch, k=tc.k, alpha=tc.alpha, beta=tc.beta,
                        neg_ratio=tc.neg_ratio)
    for k, v in m.items():
        out[f"db_step0_{k}"] = np.float64(v)
    batch = {k: jnp.asarray(v) for k, v in
             load_detector_batches(str(root), "craft", N_DOCS)[0].items()}
    loss, _ = craft_loss(load_craft_checkpoint(REPO / "models"
                                               / "craft.safetensors"), batch)
    out["craft_step0_loss"] = np.float64(loss)
    print({k: float(v) for k, v in out.items() if "step0" in k})


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    out: dict = {}
    if "--add" in sys.argv[1:]:
        with np.load(OUT) as old:
            out.update({k: old[k] for k in old.files})
        recognizer_step0_f64(out)
    else:
        recognizer_step0(out)
        detector_step0(out)
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
