"""Render the smoke fixture that `kiri_tpu_torch` checks itself against.

The GPU machine has no text renderer (no PIL, no cv2), so the lines and the
reference package's answers are rendered here once and committed:

    python scripts/make_torch_smoke_lines.py

writes ``kiri_tpu_torch/assets/smoke_lines.npz`` with 64 bilingual lines
(40% Khmer, as in ``bench.py``):

* ``crops_flat`` / ``crop_shapes``: the raw u8 crops, concatenated row-major,
  at heights that need both down- and upscaling to the model height; every
  seventh crop is inverted (light text on dark);
* ``imgs`` [64, 48, 640] u8 and ``widths``: the same crops through the host
  preprocessing (``kiri_tpu.ops.preprocess.preprocess_crops``);
* ``texts``: the ground truth;
* ``{batch,crops}_{texts,conf}_{f32,bf16}``: ``kiri_tpu``'s CTC answers for
  ``recognize_batch(imgs, "ctc", widths)`` and ``recognize_crops(crops,
  "ctc")`` with the committed checkpoint, at float32 and bfloat16 on the CPU;
* ``batch_{decoder,beam,auto}_{texts,conf}_{f32,bf16}`` and
  ``crops_decoder_{texts,conf}_{f32,bf16}``: its answers for the decoder
  paths, ``recognize_batch(imgs, m, widths)`` and ``recognize_crops(crops,
  "decoder")``;
* ``batch_decoder_rounds1_{texts,conf}_f32``: ``"decoder"`` under
  ``SPEC_MAX_ROUNDS=1``, where every line whose draft needs a correction is
  decoded again by the step loop;
* ``batch_auto_escalated_{texts,conf}_{f32,bf16}``: the committed
  checkpoint reads every smoke line with a CTC confidence above
  ``AUTO_CONF_THRESHOLD``, so ``"auto"`` escalates none of them; this is
  ``"auto"`` under ``AUTO_CONF_THRESHOLD = auto_escalate_threshold``
  (0.98505, which 25 of the 64 lines fall below, the nearest one 5e-4 away);
* ``auto_margin_{f32,bf16}``: the smallest ``|conf - AUTO_CONF_THRESHOLD|``
  over the lines. ``"auto"`` branches on that comparison, so the script fails
  if a line lies within 1e-3 of the threshold, where a last-digit difference
  between two implementations could send it the other way;
* ``stream_records_f32``: a JSON string ``{method: [records of each line]}``
  of ``stream_records_batch(imgs, m)`` for ``"ctc"``, ``"decoder"`` and
  ``"beam"`` (one-shot, float32), and ``stream_{ctc,decoder,beam}_texts_bf16``
  the text of each line's last record in bfloat16;
* ``noisy_crops_flat`` / ``noisy_crop_shapes`` / ``noisy_sharpen``: 16 of the
  crops degraded from a seed (salt and pepper, gaussian noise, low contrast,
  and downscaled under 36 px with noise), with a sharpen mask and
  ``noisy_src``, the index of the line each came from;
  ``noisy_enhanced_flat`` / ``noisy_small_noisy``: ``enhance_lines`` of them
  (each crop's own pixels, concatenated) and its small-noisy flags;
* ``crops_enhance_{ctc,decoder}_{texts,conf}_{f32,bf16}``:
  ``recognize_crops(noisy_crops, m, enhance=True, sharpen=noisy_sharpen)``;
* ``batch_spec_beam_{texts,conf}_f32``: ``"beam"`` under ``SPEC_BEAM=True``
  on the lines at full width (``recognize_batch(imgs, "beam")``, no widths:
  the JAX package's width-bucketed path ignores ``SPEC_BEAM``).

The arrays the file already holds are kept as they are: the script fails if a
regenerated one differs from the committed one. After a change of the
renderer or the checkpoint, delete the file first.
"""
from __future__ import annotations

import json
import random
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

N_LINES = 64
SEED = 20261016
HEIGHTS = (32, 40, 48, 56, 72)
OUT = REPO / "kiri_tpu_torch" / "assets" / "smoke_lines.npz"
AUTO_MARGIN_MIN = 1e-3
AUTO_ESCALATE_THRESHOLD = 0.98505
AUTO_ESCALATE_MARGIN_MIN = 2e-4
N_NOISY = 16


def noisy_crops(crops, seed=SEED):
    """The 16 narrowest crops, each degraded one of four ways in turn, a
    sharpen mask (every third) and the indices of the crops they came
    from."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    src = sorted(range(len(crops)), key=lambda i: crops[i].shape[1])[:N_NOISY]
    out = []
    for k, i in enumerate(src):
        c = crops[i].astype(np.float32)
        kind = k % 4
        if kind == 0:                                   # salt and pepper
            m = rng.random(c.shape)
            c = np.where(m < 0.004, 0.0, np.where(m > 0.996, 255.0, c))
        elif kind == 1:                                 # gaussian noise
            c = c + rng.normal(0, 20, c.shape)
        elif kind == 2:                                 # low contrast
            c = c / 255.0 * 90 + 90
        else:                                           # small and noisy
            h = int(rng.integers(22, 34))
            w = max(8, round(c.shape[1] * h / c.shape[0]))
            small = Image.fromarray(crops[i]).resize((w, h), Image.BILINEAR)
            c = (np.asarray(small, np.float32)
                 + rng.normal(0, 18, (h, w)))
        out.append(np.clip(c, 0, 255).astype(np.uint8))
    return out, np.arange(len(out)) % 3 == 1, np.asarray(src, np.int32)


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from kiri_tpu.data.synth import (DatasetGenerator, ImageRenderer,
                                     sample_khmer_text, sample_text)
    from kiri_tpu.engine import RecognizerEngine
    from kiri_tpu.kernels.resize import enhance_lines, pack_crops
    from kiri_tpu.ops.preprocess import preprocess_crops
    from kiri_tpu.tokenizer import CharTokenizer
    from kiri_tpu.train.checkpoints import find_vocab_file, load_checkpoint

    ckpt = str(REPO / "models" / "model.safetensors")
    variables, cfg, meta = load_checkpoint(ckpt)
    tok = CharTokenizer(find_vocab_file(meta.get("vocab_path", ""), ckpt), cfg)

    gen = DatasetGenerator(tempfile.mkdtemp(prefix="kiri_smoke_"),
                           height=cfg.IMG_H, augment=False, seed=SEED)
    rng = random.Random(SEED)
    charset = "".join(t for t in tok.token_to_id if len(t) == 1
                      and t.isascii() and t.isprintable())
    crops, texts = [], []
    i = 0
    while len(crops) < N_LINES:
        text = (sample_khmer_text(rng, 2, 4) if i % 5 < 2
                else sample_text(rng, 2, 5, charset))
        gen.renderer = ImageRenderer(height=HEIGHTS[i % len(HEIGHTS)],
                                     augment=False)
        img = gen.generate_one(text)
        i += 1
        if img is None:
            continue
        if len(crops) % 7 == 3:
            img = 255 - img
        crops.append(np.ascontiguousarray(img, np.uint8))
        texts.append(text)

    imgs, widths = preprocess_crops(cfg, crops)
    out = {
        "crops_flat": np.concatenate([c.ravel() for c in crops]),
        "crop_shapes": np.asarray([c.shape for c in crops], np.int32),
        "imgs": imgs,
        "widths": widths,
        "texts": np.asarray(texts),
    }
    noisy, sharpen, noisy_src = noisy_crops(crops)
    buf, sizes = pack_crops(noisy)
    enhanced, small_noisy = (np.asarray(a) for a in enhance_lines(
        jnp.asarray(buf), jnp.asarray(sizes), sharpen=jnp.asarray(sharpen)))
    out.update({
        "noisy_crops_flat": np.concatenate([c.ravel() for c in noisy]),
        "noisy_crop_shapes": np.asarray([c.shape for c in noisy], np.int32),
        "noisy_sharpen": sharpen,
        "noisy_src": noisy_src,
        "noisy_enhanced_flat": np.concatenate(
            [e[:h, :w].ravel() for e, (h, w) in zip(enhanced, sizes)]),
        "noisy_small_noisy": small_noisy,
    })
    stream_f32 = {}
    for dtype, tag in (("float32", "f32"), ("bfloat16", "bf16")):
        engine = RecognizerEngine(variables, cfg.replace(COMPUTE_DTYPE=dtype),
                                  tok)
        for path, res in (
                ("batch", engine.recognize_batch(imgs, "ctc", widths=widths)),
                ("crops", engine.recognize_crops(crops, "ctc"))):
            out[f"{path}_texts_{tag}"] = np.asarray([t for t, _ in res])
            out[f"{path}_conf_{tag}"] = np.asarray([c for _, c in res],
                                                   np.float32)
        runs = [(f"batch_{m}", engine.recognize_batch(imgs, m, widths=widths))
                for m in ("decoder", "beam", "auto")]
        runs.append(("crops_decoder", engine.recognize_crops(crops,
                                                             "decoder")))
        eng_esc = RecognizerEngine(
            variables,
            engine.cfg.replace(AUTO_CONF_THRESHOLD=AUTO_ESCALATE_THRESHOLD),
            tok)
        runs.append(("batch_auto_escalated",
                     eng_esc.recognize_batch(imgs, "auto", widths=widths)))
        for m in ("ctc", "decoder", "beam"):
            recs = [list(r) for r in engine.stream_records_batch(imgs, m)]
            if tag == "f32":
                stream_f32[m] = recs
            else:
                out[f"stream_{m}_texts_bf16"] = np.asarray(
                    [r[-1]["text"] for r in recs])
        for m in ("ctc", "decoder"):
            runs.append((f"crops_enhance_{m}", engine.recognize_crops(
                noisy, m, enhance=True, sharpen=sharpen)))
        if tag == "f32":
            eng_sb = RecognizerEngine(
                variables, engine.cfg.replace(SPEC_BEAM=True), tok)
            runs.append(("batch_spec_beam",
                         eng_sb.recognize_batch(imgs, "beam")))
            eng1 = RecognizerEngine(
                variables, engine.cfg.replace(SPEC_MAX_ROUNDS=1), tok)
            runs.append(("batch_decoder_rounds1",
                         eng1.recognize_batch(imgs, "decoder", widths=widths)))
        for name, res in runs:
            out[f"{name}_texts_{tag}"] = np.asarray([t for t, _ in res])
            out[f"{name}_conf_{tag}"] = np.asarray([c for _, c in res],
                                                   np.float32)
        margin = float(np.abs(out[f"batch_conf_{tag}"]
                              - cfg.AUTO_CONF_THRESHOLD).min())
        out[f"auto_margin_{tag}"] = np.asarray(margin, np.float32)
        if margin < AUTO_MARGIN_MIN:
            raise SystemExit(
                f"{tag}: a line's CTC confidence lies {margin:.2e} from "
                f"AUTO_CONF_THRESHOLD; pick another seed")
        esc_margin = float(np.abs(out[f"batch_conf_{tag}"]
                                  - AUTO_ESCALATE_THRESHOLD).min())
        if esc_margin < AUTO_ESCALATE_MARGIN_MIN:
            raise SystemExit(
                f"{tag}: a line's CTC confidence lies {esc_margin:.2e} from "
                f"AUTO_ESCALATE_THRESHOLD; pick another threshold")
    out["auto_escalate_threshold"] = np.asarray(AUTO_ESCALATE_THRESHOLD,
                                                np.float64)
    out["stream_records_f32"] = np.asarray(json.dumps(stream_f32,
                                                      ensure_ascii=False))
    if OUT.exists():
        with np.load(OUT) as old:
            changed = [k for k in old.files
                       if k in out and not np.array_equal(old[k], out[k])]
        if changed:
            raise SystemExit(f"regenerated arrays differ from the committed "
                             f"fixture: {changed}")
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **out)
    n_kh = sum(any(0x1780 <= ord(c) <= 0x17FF for c in t) for t in texts)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes): {len(texts)} lines, "
          f"{n_kh} Khmer, crop heights {sorted(set(c.shape[0] for c in crops))}"
          f", max crop width {max(c.shape[1] for c in crops)}, "
          f"clipped {int((widths >= cfg.IMG_W).sum())}")
    print(f"noisy crops: {len(noisy)}, heights "
          f"{sorted(set(c.shape[0] for c in noisy))}, small noisy "
          f"{int(small_noisy.sum())}, sharpened {int(sharpen.sum())}")
    for tag in ("f32", "bf16"):
        print(tag, "auto margin", float(out[f"auto_margin_{tag}"]),
              "escalated", int((out[f"batch_conf_{tag}"]
                                < cfg.AUTO_CONF_THRESHOLD).sum()),
              "and under the raised threshold",
              int((out[f"batch_conf_{tag}"] < AUTO_ESCALATE_THRESHOLD).sum()))
        for key in sorted(k for k in out if k.endswith(f"_texts_{tag}")):
            truth = ([texts[i] for i in noisy_src] if "enhance" in key
                     else texts)
            print(tag, key, "exact",
                  sum(a == b for a, b in zip(out[key], truth)))


if __name__ == "__main__":
    main()
