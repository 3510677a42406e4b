"""kiri_tpu_torch's checkpoint reader and loader, and the function that
carries kiri_tpu parameters across, against kiri_tpu."""
from __future__ import annotations

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from kiri_tpu.config import CFG as JCFG
from kiri_tpu.models import recognizer as R
from kiri_tpu.tokenizer import CharTokenizer as JTok
from kiri_tpu_torch.checkpoints import (build_model, find_vocab_file,
                                        load_checkpoint, read_safetensors)
from kiri_tpu_torch.config import CFG
from kiri_tpu_torch.convert import state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "models" / "model.safetensors"


def test_reader_bit_equal_to_safetensors():
    from safetensors.numpy import load_file

    want = load_file(str(CKPT))
    got = read_safetensors(CKPT)
    assert len(got) == len(want) == 143
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert got[k].tobytes() == v.tobytes(), k


def test_reader_rejects_bad_byte_range(tmp_path):
    header = json.dumps({"t": {"dtype": "F32", "shape": [4],
                               "data_offsets": [0, 8]}}).encode()
    p = tmp_path / "bad.safetensors"
    p.write_bytes(len(header).to_bytes(8, "little") + header + bytes(16))
    with pytest.raises(ValueError, match="byte range"):
        read_safetensors(p)


def test_committed_checkpoint_loads_strict():
    model, cfg, meta = load_checkpoint(CKPT, device="cpu")
    assert cfg.ENC_DIM == 256 and cfg.ENC_LAYERS == 4 and cfg.DEC_LAYERS == 3
    assert cfg.COMPUTE_DTYPE == "bfloat16" and cfg.KHMER_VISUAL_ORDER
    sd = model.state_dict()
    assert len(sd) == 143
    assert model.ctc_head[2].weight.shape == (210, 256)
    ref = read_safetensors(CKPT)
    for k, v in sd.items():
        assert np.array_equal(v.numpy(), ref[k]), k
    assert find_vocab_file(meta["vocab_path"], str(CKPT)) == str(
        REPO / "models" / "vocab.json")


def test_carry_across_matches_jax(tmp_path):
    """A random kiri_tpu init on a small config, carried across, gives the
    same encoder memory, CTC logits and memory projection at f32."""
    (tmp_path / "v.json").write_text(json.dumps(
        {"<unk>": 0, "a": 1, "b": 2, "c": 3}))
    small = dict(ENC_DIM=64, ENC_LAYERS=2, ENC_HEADS=4, ENC_FF=128,
                 DEC_DIM=64, DEC_LAYERS=1, DEC_HEADS=4, DEC_FF=128,
                 COMPUTE_DTYPE="float32")
    jcfg = JCFG(**small)
    variables = R.init_recognizer(jax.random.PRNGKey(0), jcfg,
                                  JTok(tmp_path / "v.json", jcfg))
    rng = np.random.default_rng(1)
    for i in range(4):
        bn = variables["batch_stats"]["stem"][f"bn{i}"]
        bn["mean"] = rng.normal(0, 0.3, bn["mean"].shape).astype(np.float32)
        bn["var"] = (np.abs(rng.normal(0, 1, bn["var"].shape)) + 0.5
                     ).astype(np.float32)
    np_vars = jax.tree.map(np.asarray, {k: variables[k] for k in
                                        ("params", "batch_stats")})
    sd = state_dict_from_jax(np_vars, jcfg.MAX_DEC_LEN)
    model = build_model(sd, CFG(**small))

    imgs = rng.integers(0, 256, (2, 48, 160), np.uint8)
    mem = jax.jit(lambda v, x: R.encode(v, x, jcfg)[0])(variables, imgs)
    with torch.inference_mode():
        ours = model.encode(torch.from_numpy(imgs), torch.float32)
        np.testing.assert_allclose(ours.numpy(), np.asarray(mem), atol=1e-4)
        np.testing.assert_allclose(
            model.ctc_logits(ours).numpy(),
            np.asarray(R.ctc_logits(variables["params"], mem, jcfg)),
            atol=1e-4)
        np.testing.assert_allclose(
            model.mem_project(ours).numpy(),
            np.asarray(R.mem_project(variables["params"], mem)), atol=1e-4)
