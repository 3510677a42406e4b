"""Shared set-up of the training tests (tests/test_torch_train_*.py): the
small recognizer of ``tests/test_trainer.py`` in both packages, its weights
carried across by ``kiri_tpu_torch.convert``, and batches made from a numpy
seed."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

SMALL = dict(ENC_DIM=32, ENC_LAYERS=1, ENC_FF=64, ENC_HEADS=4, DEC_DIM=32,
             DEC_LAYERS=1, DEC_FF=64, DEC_HEADS=4, IMG_H=48, IMG_W=160,
             COMPUTE_DTYPE="float32", DROPOUT=0.0)
CHARS = "abcde "
TEXTS = ["ab cde", "a", "", "eeddcc ba", "cab", "dd e", "bad", "e"]


def write_vocab(path: Path) -> str:
    vocab = {"<unk>": 0}
    for i, ch in enumerate(CHARS):
        vocab[ch] = i + 1
    Path(path).write_text(json.dumps(vocab))
    return str(path)


def samples(n: int = 8, seed: int = 0, width: int = 160):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 255, (48, width), np.uint8),
             "text": TEXTS[i % len(TEXTS)]} for i in range(n)]


def both(tmp: Path, **kw):
    """(kiri_tpu cfg, port cfg, kiri_tpu tokenizer, port tokenizer) of the
    small model with ``kw`` over ``SMALL``."""
    from kiri_tpu.config import CFG as JCFG
    from kiri_tpu.tokenizer import CharTokenizer as JTok
    from kiri_tpu_torch.config import CFG
    from kiri_tpu_torch.tokenizer import CharTokenizer

    vp = write_vocab(Path(tmp) / "vocab.json")
    jcfg, cfg = JCFG(**{**SMALL, **kw}), CFG(**{**SMALL, **kw})
    return jcfg, cfg, JTok(vp, jcfg), CharTokenizer(vp, cfg)


def jax_init(jcfg, jtok, seed: int = 0):
    import jax

    from kiri_tpu.models import recognizer as R

    return R.init_recognizer(jax.random.PRNGKey(seed), jcfg, jtok)


def to_numpy(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def port_state(variables, cfg) -> dict:
    """kiri_tpu variables (or gradients in their place) -> torch names."""
    from kiri_tpu_torch.convert import state_dict_from_jax

    return state_dict_from_jax(
        to_numpy({"params": variables["params"],
                  "batch_stats": variables["batch_stats"]}), cfg.MAX_DEC_LEN)


def port_model(variables, cfg):
    from kiri_tpu_torch.checkpoints import build_model

    return build_model(port_state(variables, cfg), cfg)


def grads_by_name(model) -> dict:
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            for n, p in model.named_parameters()}


def to_torch(batch) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()
            if k != "text"}
