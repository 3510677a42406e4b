"""The port's training recipe (kiri_tpu_torch/train/recipe.py) against
``scripts/train_recognizer.py`` on the CPU, the pseudo-glyph pool on both
sides: the JAX script's own ``main()`` is run through importlib with
``sys.argv`` set and ``train_loop`` replaced by a stub that keeps
``(train, val)``; ``recipe.build_samples`` must give the same lines (image
bytes and texts, in order) and ``build_full_vocab`` over their labels, as
``recipe.main`` calls it, the same ``vocab.json`` bytes. Then one float32
step of both packages' ``train_loop`` from the same small model on the
first recipe lines: the loss within TOL_TRAIN_STEP0 (1e-4, relative) of
kiri_tpu's."""
from __future__ import annotations

import importlib.util
import json
import sys
from types import SimpleNamespace

import numpy as np
import pytest
from torch_pages import REPO, cv2_without_ipp  # noqa: F401
from torch_train import SMALL, jax_init

from kiri_tpu.data import synth as JS
from kiri_tpu_torch.train import recipe

TOL_TRAIN_STEP0 = 1e-4
#: Every option of the recipe on, at 96 samples.
ARGV = ["--samples", "96", "--doc-crop-ratio", "0.25", "--aug-conditions",
        "1.0", "--resample-weight", "0.5", "--small-render-ratio", "0.3",
        "--small-resample", "0.7", "--enhance-ratio", "0.3",
        "--sign-boost", "0.3", "--khmer-ratio", "0.5", "--visual-order",
        "--max-words", "8"]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the JAX script's (train, val), vocab bytes; the port's)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JS, "_FONT_DIRS", [])
    jdir = tmp_path_factory.mktemp("jax")
    kept = {}

    def stub(cfg, tok, tc, train, val, **kw):
        kept.update(train=train, val=val, cfg=cfg, tc=tc, kw=kw)
        return SimpleNamespace(best_val_acc=0.0)

    import kiri_tpu.train.trainer as JT

    mp.setattr(JT, "train_loop", stub)
    spec = importlib.util.spec_from_file_location(
        "_jax_train_recognizer", REPO / "scripts" / "train_recognizer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mp.setattr(sys, "argv", ["train_recognizer", *ARGV,
                             "--out-dir", str(jdir)])
    try:
        mod.main()
    finally:
        mp.undo()
    tdir = tmp_path_factory.mktemp("port")
    args = recipe.parser().parse_args([*ARGV, "--out-dir", str(tdir),
                                       "--no-fonts", "--device", "cpu"])
    train, val = recipe.build_samples(args)
    from kiri_tpu_torch.tokenizer import build_full_vocab

    build_full_vocab(tdir / "vocab.json",
                     extra_texts=(s["text"] for s in val + train))
    return kept, (jdir / "vocab.json").read_bytes(), train, val, (
        tdir / "vocab.json").read_bytes()


def test_build_samples_equal_the_scripts(both):
    kept, _, train, val, _ = both
    for got, want in ((train, kept["train"]), (val, kept["val"])):
        assert [s["text"] for s in got] == [s["text"] for s in want]
        for a, b in zip(got, want):
            a, b = a["image"], np.asarray(b["image"])
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert len(val) == 64 and len(train) == 29
    # Every source is present: 44 lines at the model's height, 25 small
    # renders (5 a height) and 24 document crops.
    heights = [s["image"].shape[0] for s in train + val]
    assert sum(h < 32 for h in heights) >= 15
    assert kept["tc"].epochs == 12 and kept["tc"].batch_size == 64
    assert kept["cfg"].KHMER_VISUAL_ORDER


def test_vocab_bytes_equal_the_scripts(both):
    _, jvocab, _, _, tvocab = both
    assert tvocab == jvocab
    assert len(json.loads(tvocab)) > 180


def test_recipe_step_matches_kiri_tpu(both, tmp_path):
    """One float32 step (batch 8, from the same weights) of each package's
    ``train_loop`` on the recipe's first lines, with its vocab."""
    import kiri_tpu.train.checkpoints as JC
    import kiri_tpu.train.trainer as JT
    from kiri_tpu.config import CFG as JCFG
    from kiri_tpu.tokenizer import CharTokenizer as JTok
    from kiri_tpu_torch.config import CFG
    from kiri_tpu_torch.tokenizer import CharTokenizer
    from kiri_tpu_torch.train import trainer as T

    _, _, train, val, tvocab = both
    vp = tmp_path / "vocab.json"
    vp.write_bytes(tvocab)
    kw = dict(SMALL, IMG_W=640)
    jcfg, cfg = JCFG(**kw), CFG(**kw)
    jtok, tok = JTok(str(vp), jcfg), CharTokenizer(str(vp), cfg)
    JC.save_checkpoint(tmp_path / "init.safetensors",
                       jax_init(jcfg, jtok, seed=4), jcfg)
    data, held = train[:8], val[:8]
    tc = dict(epochs=1, batch_size=8, log_every=0, lr=1e-3, warmup_steps=2)
    JT.train_loop(jcfg, jtok, JT.TrainConfig(out_dir=str(tmp_path / "j"),
                                             n_devices=1, **tc),
                  data, held, from_model=str(tmp_path / "init.safetensors"),
                  verbose=False)
    T.train_loop(cfg, tok, T.TrainConfig(out_dir=str(tmp_path / "t"), **tc),
                 data, held, from_model=str(tmp_path / "init.safetensors"),
                 verbose=False, device="cpu")
    jh = json.loads((tmp_path / "j" / "history.json").read_text())
    th = json.loads((tmp_path / "t" / "history.json").read_text())
    assert len(th) == len(jh) == 1
    assert abs(th[0]["loss"] - jh[0]["loss"]) <= \
        TOL_TRAIN_STEP0 * abs(jh[0]["loss"])
    assert np.isfinite(th[0]["loss"])
