"""The port's batching, ``train_loop``, checkpoints and resume against
kiri_tpu's, on the small model."""
from __future__ import annotations

import json
import shutil

import jax
import numpy as np
import pytest
import torch

from kiri_tpu.models import recognizer as R
from kiri_tpu.train import checkpoints as JC
from kiri_tpu.train import trainer as JT
from kiri_tpu.utils.convert import to_torch_state_dict
from kiri_tpu_torch.checkpoints import read_safetensors
from kiri_tpu_torch.engine import RecognizerEngine
from kiri_tpu_torch.train import trainer as T

from torch_train import both, jax_init, port_model, samples

KHMER = "បំេ កា"


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def cv2_without_ipp():
    """kiri_tpu's collate resizes with cv2; the port computes cv2's own code,
    which IPP's cubic resize departs from (tests/test_torch_imgproc.py)."""
    import cv2

    before = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(before)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return both(tmp_path_factory.mktemp("loop"))


def _mixed(n=11, seed=2):
    """Lines of mixed heights and widths, texts empty to over-long."""
    rng = np.random.default_rng(seed)
    texts = ["", "a", "ab cde" * 3, "e" * 70, KHMER, "cab", "dd e"]
    return [{"image": rng.integers(0, 255, (int(rng.integers(20, 60)),
                                            int(rng.integers(30, 400))),
                                   np.uint8),
             "text": texts[i % len(texts)]} for i in range(n)]


@pytest.mark.parametrize("img_hw,max_seq_len", [(None, 512), ((48, 160), 512),
                                                ((48, 320), 20)])
def test_collate_matches_kiri_tpu(small, img_hw, max_seq_len):
    _, _, jtok, tok = small
    data = _mixed() if img_hw else samples(6)
    want = JT.collate(data, jtok, max_seq_len, img_hw=img_hw)
    got = T.collate(data, tok, max_seq_len, img_hw=img_hw)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("batch_size", [4, 5])
def test_width_bucket_plan_matches_kiri_tpu(small, batch_size):
    jcfg, cfg, _, _ = small
    data = _mixed(23)
    jr, tr = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):     # consecutive epochs draw from one generator
        want = JT.width_bucket_plan(jr, data, jcfg, batch_size)
        got = T.width_bucket_plan(tr, data, cfg, batch_size)
        assert got == want


@pytest.fixture(scope="module")
def loops(small, tmp_path_factory):
    """train_loop of both packages (2 epochs, validation each epoch) from
    the same weights, and the port resumed from its epoch-1 checkpoint."""
    jcfg, cfg, jtok, tok = small
    root = tmp_path_factory.mktemp("runs")
    var = jax_init(jcfg, jtok, seed=3)
    data, val = samples(8), samples(4, seed=5)
    JC.save_checkpoint(root / "init.safetensors", var, jcfg)
    # One device: under the tests' eight virtual CPU devices kiri_tpu would
    # pad each batch of 4 to 8 rows and shard it.
    kw = dict(epochs=2, batch_size=4, log_every=0, lr=1e-3, warmup_steps=2,
              n_devices=1)
    JT.train_loop(jcfg, jtok, JT.TrainConfig(out_dir=str(root / "jax"), **kw),
                  data, val, from_model=str(root / "init.safetensors"),
                  verbose=False)
    ours = T.train_loop(cfg, tok, T.TrainConfig(out_dir=str(root / "port"),
                                                **kw),
                        data, val, from_model=str(root / "init.safetensors"),
                        verbose=False, device="cpu")
    (root / "cut").mkdir()
    for suffix in (".safetensors", "_meta.json", "_optim_torch.npz"):
        shutil.copy(root / "port" / f"model_epoch_1{suffix}",
                    root / "cut" / f"latest{suffix}")
    cut = T.train_loop(cfg, tok, T.TrainConfig(out_dir=str(root / "cut"),
                                               **kw),
                       data, val, from_model=str(root / "init.safetensors"),
                       verbose=False, resume=True, device="cpu")
    return root, ours, cut


def test_train_loop_writes_kiri_tpu_files(loops):
    root, ours, _ = loops
    theirs = {p.name.replace("_optim.npz", "_optim_torch.npz")
              for p in (root / "jax").iterdir()}
    assert {p.name for p in (root / "port").iterdir()} == theirs
    assert "history.json" in theirs
    jh = json.loads((root / "jax" / "history.json").read_text())
    th = json.loads((root / "port" / "history.json").read_text())
    assert [list(r) for r in th] == [list(r) for r in jh]
    for a, b in zip(th, jh):
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"])
        assert a["val_ctc_acc"] == b["val_ctc_acc"]
    jm = json.loads((root / "jax" / "latest_meta.json").read_text())
    tm = json.loads((root / "port" / "latest_meta.json").read_text())
    assert set(tm) == set(jm)
    assert (tm["epoch"], tm["step"]) == (jm["epoch"], jm["step"]) == (2, 4)


def test_resume_continues_as_the_uninterrupted_run(loops):
    _, ours, cut = loops
    assert cut.step == ours.step and cut.epoch == ours.epoch
    for (n, p), q in zip(ours.model.named_parameters(),
                         cut.model.parameters()):
        assert torch.equal(p, q), n
    for (n, p), q in zip(ours.model.named_buffers(), cut.model.buffers()):
        assert torch.equal(p, q), n
    assert cut.history[-1]["loss"] == ours.history[-1]["loss"]


def test_checkpoint_loads_in_kiri_tpu(loops, small):
    """The port's checkpoint has to_torch_state_dict's keys and shapes
    (num_batches_tracked 0) and kiri_tpu reads it to the port's logits."""
    jcfg, cfg, _, _ = small
    root, ours, _ = loops
    path = root / "port" / "latest.safetensors"
    sd = read_safetensors(path)
    var, jcfg2, meta = JC.load_checkpoint(str(path))
    want = to_torch_state_dict(var, jcfg2)
    assert {k: v.shape for k, v in sd.items()} == \
        {k: v.shape for k, v in want.items()}
    assert all(int(v) == 0 for k, v in sd.items()
               if k.endswith("num_batches_tracked"))
    assert meta["step"] == 4
    assert json.dumps(jcfg2.to_dict()) == json.dumps(jcfg.to_dict())
    imgs = np.stack([s["image"] for s in samples(4, seed=8)])
    jmem, _ = R.encode(var, jax.numpy.asarray(imgs), jcfg2)
    jctc = np.asarray(R.ctc_logits(var["params"], jmem, jcfg2))
    with torch.no_grad():
        mem = ours.model.encode(torch.from_numpy(imgs), torch.float32)
        ctc = ours.model.ctc_logits(mem).numpy()
    assert np.abs(ctc - jctc).max() <= 1e-4 * (np.abs(jctc).max() + 1)


def test_kiri_tpu_checkpoint_resumes_with_fresh_moments(small, tmp_path):
    """kiri_tpu's own ``_optim.npz`` is not read: the port resumes its
    checkpoint with the weights and counters and fresh AdamW moments."""
    jcfg, cfg, jtok, tok = small
    var = jax_init(jcfg, jtok, seed=4)
    JC.save_checkpoint(tmp_path / "latest.safetensors", var, jcfg, epoch=1,
                       step=3, opt_state={"m": np.zeros(3, np.float32)})
    tr = T.Trainer(cfg, tok, T.TrainConfig(), device="cpu")
    assert tr.resume(tmp_path / "latest.safetensors")
    assert (tr.epoch, tr.step) == (1, 3) and not tr.optimizer.state
    ref = port_model(var, cfg).state_dict()
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, ref[k]), k


def test_engine_reads_weights_after_a_step(small):
    """The engine's folded-stem and decoder caches follow the optimizer's
    in-place writes (their keys hold each tensor's version)."""
    jcfg, cfg, jtok, tok = small
    tr = T.Trainer(cfg, tok, T.TrainConfig(lr=1e-2, warmup_steps=1),
                   model=port_model(jax_init(jcfg, jtok), cfg),
                   total_steps=4, device="cpu")
    eng = RecognizerEngine(tr.model, cfg, tok, device="cpu")
    imgs = np.stack([s["image"] for s in samples(4)])
    ctc0 = eng.encode_batch(imgs)[1].clone()
    emb0 = tr.model.decoder_weights(torch.float32).emb.clone()
    tr.run_step(T.collate(samples(8), tok))
    ctc1 = eng.encode_batch(imgs)[1]
    fresh = RecognizerEngine(port_model(jax_init(jcfg, jtok), cfg), cfg, tok,
                             device="cpu")
    fresh.model.load_state_dict(tr.model.state_dict())
    assert not torch.equal(ctc0, ctc1)
    assert torch.equal(ctc1, fresh.encode_batch(imgs)[1])
    emb1 = tr.model.decoder_weights(torch.float32).emb
    assert not torch.equal(emb0, emb1)
    assert torch.equal(emb1, tr.model.dec_emb.weight.detach())
    texts = eng.recognize_batch(imgs, "decoder")
    assert texts == fresh.recognize_batch(imgs, "decoder")
