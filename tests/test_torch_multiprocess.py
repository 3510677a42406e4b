"""Two processes of the port (gloo ranks on the CPU, one device each) train
data-parallel on ``tests/mp_runner.py``'s config and batch and reproduce
``kiri_tpu``'s single-process three-step loss trajectory within 1e-4, as
``tests/test_multiprocess.py`` holds ``kiri_tpu``'s two processes to it.
Then ``train_loop`` over two ranks (tensor-parallel, validation through the
meshed engine, rank 0 writing) against one device's, and ``kiri-tpu-torch
train`` under torchrun.
Both start from ``kiri_tpu``'s initial weights (carried across by
``convert``); DROPOUT is 0, since the port's dropout draws from torch's
generator, not JAX's (its draws over ranks are held to one device in
``test_torch_sharding.py``)."""
from __future__ import annotations

import os
from pathlib import Path

import jax
import numpy as np

from kiri_tpu.config import CFG as JCFG
from kiri_tpu.models import recognizer as R
from kiri_tpu.tokenizer import CharTokenizer as JTok
from kiri_tpu.tokenizer import build_vocab_from_texts
from kiri_tpu.train.trainer import TrainConfig, Trainer, collate
from kiri_tpu_torch.parallel.launch import spawn

from torch_train import port_state

TESTS = str(Path(__file__).resolve().parent)
CFG_KW = dict(IMG_H=48, IMG_W=160, ENC_DIM=64, ENC_LAYERS=1, ENC_HEADS=4,
              ENC_FF=128, DEC_DIM=64, DEC_LAYERS=1, DEC_HEADS=4, DEC_FF=128,
              COMPUTE_DTYPE="float32", DROPOUT=0.0)
TC = dict(epochs=1, batch_size=8, lr=1e-3, seed=3)
TOL = 1e-4


def test_two_ranks_match_kiri_tpus_single_process(tmp_path):
    vocab = str(tmp_path / "vocab.json")
    build_vocab_from_texts(["ab"], vocab)
    jcfg = JCFG(**CFG_KW)
    jtok = JTok(vocab, jcfg)
    rng = np.random.default_rng(7)
    texts = ["ab", "ba", "aa", "bb", "ab", "ba", "aa", "bb"]
    batch = collate([{"image": rng.integers(0, 255, (48, 160), np.uint8),
                      "text": t} for t in texts], jtok)
    var = R.init_recognizer(jax.random.PRNGKey(TC["seed"]), jcfg, jtok)
    from kiri_tpu_torch.config import CFG

    state = {k: v.numpy() for k, v in port_state(var, CFG(**CFG_KW)).items()}
    trainer = Trainer(jcfg, jtok, TrainConfig(**TC), variables=var,
                      total_steps=4, use_mesh=False)
    want = [trainer.run_step(batch)["loss"] for _ in range(3)]

    out = spawn("torch_parallel_ranks:train_steps", 2,
                dict(state=state, cfgd=CFG_KW, vocab=vocab, batch=batch,
                     mp=1, steps=3, tc=TC, total_steps=4),
                paths=[TESTS], timeout=300)
    for metrics, _ in out:
        got = [m["loss"] for m in metrics]
        assert len(got) == 3 and all(np.isfinite(got))
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # Both ranks end with the same weights.
    (_, a), (_, b) = out
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


SMALL_KW = dict(ENC_DIM=32, ENC_LAYERS=1, ENC_FF=64, ENC_HEADS=4, DEC_DIM=32,
                DEC_LAYERS=1, DEC_FF=64, DEC_HEADS=4, IMG_H=48, IMG_W=160,
                COMPUTE_DTYPE="float32", DROPOUT=0.0)


def _lines(n, seed):
    rng = np.random.default_rng(seed)
    words = ["ab", "ba b", "aab", "b a"]
    return [{"image": rng.integers(0, 255, (48, 160), np.uint8),
             "text": words[i % 4]} for i in range(n)]


def test_train_loop_over_two_ranks_matches_one_device(tmp_path):
    from kiri_tpu_torch.config import CFG
    from kiri_tpu_torch.tokenizer import CharTokenizer
    from kiri_tpu_torch.train.trainer import TrainConfig as TC
    from kiri_tpu_torch.train.trainer import train_loop

    vocab = str(tmp_path / "vocab.json")
    build_vocab_from_texts(["ab "], vocab)
    train, val = _lines(8, 1), _lines(4, 2)
    tc = dict(epochs=2, batch_size=4, lr=1e-3, warmup_steps=2, log_every=0)
    cfg = CFG(**SMALL_KW)
    one = train_loop(cfg, CharTokenizer(vocab, cfg),
                     TC(**tc, out_dir=str(tmp_path / "one")), train, val,
                     vocab_path=vocab, verbose=False, device="cpu")
    (hist, files), (hist1, _) = spawn(
        "torch_parallel_ranks:train_loop_run", 2,
        dict(cfgd=SMALL_KW, vocab=vocab, train=train, val=val,
             tc={**tc, "out_dir": str(tmp_path / "two"), "n_devices": 2,
                 "model_parallel": 2}), paths=[TESTS], timeout=300)
    assert files == sorted(p.name for p in (tmp_path / "one").iterdir())
    def timeless(h):
        return [{k: v for k, v in row.items() if k != "time_s"} for row in h]

    assert timeless(hist) == timeless(hist1)  # every rank's history alike
    for a, b in zip(hist, one.history):
        assert a["epoch"] == b["epoch"]
        for k in ("loss", "ctc_loss", "dec_loss", "val_ctc_acc",
                  "val_ar_acc"):
            assert abs(a[k] - b[k]) <= 1e-3 * max(1.0, abs(b[k])), k


def test_cli_train_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2 -m kiri_tpu_torch.cli train
    --n-devices 2`` on the CPU: the ranks join through torchrun's
    environment, rank 0 builds the vocab and writes the checkpoints."""
    import json
    import subprocess
    import sys

    from kiri_tpu_torch.utils.imageio import encode_png

    data = tmp_path / "data"
    data.mkdir()
    rows = []
    for i, s in enumerate(_lines(8, 3)):
        (data / f"{i}.png").write_bytes(encode_png(s["image"]))
        rows.append(f"{i}.png\t{s['text']}")
    (data / "labels.txt").write_text("\n".join(rows) + "\n")
    out = tmp_path / "run"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "kiri_tpu_torch.cli", "train",
           "--train-labels", str(data / "labels.txt"), "--epochs", "1",
           "--batch-size", "4", "--n-devices", "2", "--model-parallel", "2",
           "--output-dir", str(out), "--device", "cpu", "--enc-dim", "32",
           "--enc-layers", "1", "--enc-heads", "4", "--enc-ff", "64",
           "--dec-dim", "32", "--dec-layers", "1", "--dec-heads", "4",
           "--dec-ff", "64", "--width", "160"]
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(Path(TESTS).parent)}
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert (out / "model_epoch_1.safetensors").exists()
    meta = json.loads((out / "model_epoch_1_meta.json").read_text())
    assert meta["epoch"] == 1 and meta["config"]["ENC_DIM"] == 32
    assert proc.stdout.count("1 epochs") == 1      # rank 0 alone prints
