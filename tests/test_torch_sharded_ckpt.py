"""Sharded checkpoints of the port (``train/sharded_ckpt.py`` on
``torch.distributed.checkpoint``), as ``tests/test_sharded_ckpt.py`` holds
``kiri_tpu``'s: the plain round trip and the round trip of two ranks with
a model axis of 2 (each rank writes its shards, a restore onto the mesh
lands them sharded), both with AdamW's moments; ``to_reference``'s file
read by ``kiri_tpu.train.checkpoints``; a ``kiri_tpu`` ``to_reference``
file read by the port. The two packages' ``state/`` trees (DCP, orbax) do
not read each other: the single file is where they meet (ROADMAP.md
queue 3)."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from kiri_tpu.train import checkpoints as JC
from kiri_tpu_torch.checkpoints import build_model, load_checkpoint
from kiri_tpu_torch.parallel.launch import spawn
from kiri_tpu_torch.train import sharded_ckpt as S
from kiri_tpu_torch.train.trainer import TrainConfig, Trainer, collate

from torch_train import both, jax_init, port_state, samples

TESTS = str(Path(__file__).resolve().parent)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ck")
    jcfg, cfg, jtok, tok = both(tmp)
    var = jax_init(jcfg, jtok)
    state = {k: v.numpy() for k, v in port_state(var, cfg).items()}
    return jcfg, cfg, jtok, tok, var, state, str(tmp / "vocab.json")


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def _sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def test_roundtrip_plain_with_moments(small, tmp_path):
    _, cfg, _, tok, _, state, vocab = small
    tr = Trainer(cfg, tok, TrainConfig(lr=1e-3, warmup_steps=2),
                 model=build_model(state, cfg), total_steps=10, device="cpu")
    tr.run_step(collate(samples(8), tok))
    S.save_sharded(tmp_path / "ck", tr.model, cfg, vocab_path=vocab,
                   epoch=3, step=77, best_val_acc=0.5,
                   opt_state=tr.opt_state())
    model, cfg2, meta, opt = S.restore_sharded(tmp_path / "ck",
                                               with_opt_state=True,
                                               device="cpu")
    assert meta["epoch"] == 3 and meta["step"] == 77
    assert meta["framework"] == "kiri_tpu_torch" and meta["has_opt_state"]
    assert set(meta) == {"config", "vocab_path", "epoch", "step",
                         "best_val_acc", "use_dec_pos_enc", "has_opt_state",
                         "framework"}
    assert cfg2.ENC_DIM == cfg.ENC_DIM
    _equal(_sd(model), _sd(tr.model))
    _equal({k: np.asarray(v) for k, v in opt.items()}, tr.opt_state())
    # Without moments when none were saved or none are asked for.
    S.save_sharded(tmp_path / "ck2", tr.model, cfg)
    assert S.restore_sharded(tmp_path / "ck2", with_opt_state=True,
                             device="cpu")[3] is None
    assert S.restore_sharded(tmp_path / "ck", device="cpu")[3] is None


@pytest.fixture(scope="module")
def two_ranks(small, tmp_path_factory):
    _, cfg, _, tok, _, state, vocab = small
    root = tmp_path_factory.mktemp("sharded") / "ck"
    out = spawn("torch_parallel_ranks:checkpoint", 2,
                dict(state=state, cfgd=cfg.to_dict(), vocab=vocab,
                     batch=collate(samples(8), tok), mp=2, root=str(root)),
                paths=[TESTS], timeout=300)
    return root, out


def test_roundtrip_sharded_over_two_ranks(two_ranks):
    root, out = two_ranks
    files = sorted(p.name for p in (root / "state").iterdir())
    assert files == [".metadata", "__0_0.distcp", "__1_0.distcp"]
    for r in out:
        _equal(r["local"], r["mine"])          # each rank's shards, in place
        _equal(r["whole"], r["expected"])      # and the whole model
        _equal(r["opt"], r["my_opt"])
        _equal(r["whole_opt"], r["expected_opt"])
        assert r["meta"]["epoch"] == 2 and r["meta"]["has_opt_state"]
        # The single file, gathered and written by rank 0, resumes on the
        # mesh: each rank's shards and moments come back.
        assert r["resumed"] and r["resumed_step"] == 1
        _equal(r["resumed_state"], r["mine"])
        _equal({k: v for k, v in r["resumed_opt"].items()},
               {k: v for k, v in r["my_opt"].items()})
    a, b = (r["mine"]["enc.layers.0.linear1.weight"] for r in out)
    assert a.shape[0] * 2 == out[0]["whole"][
        "enc.layers.0.linear1.weight"].shape[0]
    assert not np.array_equal(a, b)


def test_to_reference_loads_in_kiri_tpu(small, two_ranks):
    jcfg, cfg, jtok, tok, _, _, _ = small
    root, out = two_ranks
    ref = root / "reference.safetensors"
    variables, jcfg2, meta = JC.load_checkpoint(str(ref))
    assert jcfg2.ENC_DIM == cfg.ENC_DIM and meta["epoch"] == 2
    got = port_state(variables, cfg)
    for k, v in out[0]["whole"].items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    model, _, _ = load_checkpoint(ref, device="cpu")
    _equal(_sd(model), out[0]["whole"])


def test_kiri_tpu_to_reference_loads_in_the_port(small, tmp_path):
    from kiri_tpu.train import sharded_ckpt as JS

    jcfg, cfg, jtok, tok, var, state, vocab = small
    JS.save_sharded(tmp_path / "jck", var, jcfg, vocab_path=vocab, epoch=1)
    JS.to_reference(tmp_path / "jck", tmp_path / "j.safetensors")
    model, cfg2, meta = load_checkpoint(tmp_path / "j.safetensors",
                                        device="cpu")
    assert meta["epoch"] == 1 and cfg2.ENC_DIM == cfg.ENC_DIM
    want = port_state(var, cfg)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked") or k == "dec_pos_enc.pe":
            continue
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    # The packages' state/ trees are their own: orbax against DCP.
    assert (tmp_path / "jck" / "state").is_dir()
    assert json.loads((tmp_path / "jck" / "kiri_meta.json").read_text())[
        "framework"] == "kiri_tpu"
    with pytest.raises(Exception):
        S.restore_sharded(tmp_path / "jck", device="cpu")
