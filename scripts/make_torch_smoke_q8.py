"""Store ``kiri_tpu``'s int8 fast path on the committed checkpoint, which
``kiri_tpu_torch``'s ``Q8Encoder`` is held to on the card:

    python scripts/make_torch_smoke_q8.py

runs ``kiri_tpu.ops.quant8.Q8Encoder`` over the 64 lines of
``kiri_tpu_torch/assets/smoke_lines.npz`` (``imgs``, 48 x 640 u8) with
``models/model.safetensors``, calibrated on lines 0-31, on the CPU, and
writes ``kiri_tpu_torch/assets/smoke_q8.npz``. For each ``parts`` set P in
``PARTS`` (key: the parts joined by "_") and each dtype D ("f32", "bf16"):

* ``{P}_texts_{D}``: the greedy CTC texts (argmax, ``decode_ctc_batch``);
* ``{P}_cer_{D}``: their text CER against ``Q8Encoder.bf16``'s texts in the
  same dtype (edit distance over the reference's characters, as
  ``tests/test_quant8.py`` counts it);
* float32 only, the calibrated scales: ``{P}_stem{i}_inv``, ``_wq`` (HWIO
  int8) and ``_ws`` for convs i = 1-3 where the stem is quantized, and
  ``{P}_enc``, float32 [n], one per quantized matmul in ``kiri_tpu``'s
  order;

and ``ref_texts_{D}``, ``Q8Encoder.bf16``'s texts. ~5 min on 8 CPU cores.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

OUT = REPO / "kiri_tpu_torch" / "assets" / "smoke_q8.npz"
LINES = REPO / "kiri_tpu_torch" / "assets" / "smoke_lines.npz"
PARTS = (("stem",), ("stem", "attn", "ffn"), ("attn", "ffn"))
CALIB_LINES = 32
DTYPES = {"f32": "float32", "bf16": "bfloat16"}


def text_cer(hyp, ref) -> float:
    """Edit distance of ``hyp`` to ``ref`` over the characters of ``ref``
    (each text at least 1)."""
    def lev(a, b):
        prev = list(range(len(b) + 1))
        for x, ca in enumerate(a, 1):
            cur = [x]
            for y, cb in enumerate(b, 1):
                cur.append(min(prev[y] + 1, cur[y - 1] + 1,
                               prev[y - 1] + (ca != cb)))
            prev = cur
        return prev[-1]
    return (sum(lev(a, b) for a, b in zip(hyp, ref))
            / sum(max(1, len(b)) for b in ref))


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from kiri_tpu.ops.quant8 import Q8Encoder
    from kiri_tpu.tokenizer import CharTokenizer
    from kiri_tpu.train.checkpoints import find_vocab_file, load_checkpoint

    ckpt = str(REPO / "models" / "model.safetensors")
    variables, cfg, meta = load_checkpoint(ckpt)
    tok = CharTokenizer(find_vocab_file(meta.get("vocab_path", ""), ckpt), cfg)
    with np.load(LINES) as f:
        imgs = f["imgs"]
    out = {}

    def texts(ctc):
        return [str(t) for t in tok.decode_ctc_batch(
            np.argmax(np.asarray(ctc, np.float32), -1))]

    for d, dtype in DTYPES.items():
        dcfg = cfg.replace(COMPUTE_DTYPE=dtype)
        ref = texts(Q8Encoder(variables, dcfg).bf16(imgs)[1])
        out[f"ref_texts_{d}"] = np.array(ref)
        for parts in PARTS:
            key = "_".join(parts)
            q = Q8Encoder(variables, dcfg, parts=parts)
            q.calibrate(imgs[:CALIB_LINES])
            hyp = texts(q(imgs)[1])
            out[f"{key}_texts_{d}"] = np.array(hyp)
            out[f"{key}_cer_{d}"] = np.float64(text_cer(hyp, ref))
            print(f"{key} {dtype}: CER vs the reference path "
                  f"{out[f'{key}_cer_{d}']:.5f}, "
                  f"{sum(a == b for a, b in zip(hyp, ref))}/{len(ref)} "
                  f"texts equal", flush=True)
            if d != "f32":
                continue
            s = jax.device_get(q.scales)
            for i, st in enumerate(s["stem"], 1):
                for name in ("inv", "wq", "ws"):
                    out[f"{key}_stem{i}_{name}"] = np.asarray(st[name])
            out[f"{key}_enc"] = np.asarray(s["enc"], np.float32)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
