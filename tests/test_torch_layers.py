"""kiri_tpu_torch's transformer layers, and the whole encoder + CTC head on
the committed checkpoint, against kiri_tpu at float32 on the CPU."""
from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kiri_tpu.models import layers as JL
from kiri_tpu.models import recognizer as R
from kiri_tpu.ops.ctc import greedy_ctc_stats as j_greedy
from kiri_tpu.train.checkpoints import load_checkpoint as j_load
from kiri_tpu_torch.checkpoints import load_checkpoint
from kiri_tpu_torch.convert import _lin, _ln, _mha
from kiri_tpu_torch.models import layers as L
from kiri_tpu_torch.models.recognizer import EncoderLayer
from kiri_tpu_torch.ops.ctc import greedy_ctc_stats
from kiri_tpu_torch.smoke import load_smoke_lines

REPO = Path(__file__).resolve().parent.parent
D, FF, HEADS = 64, 128, 4


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def enc_layer():
    """A random kiri_tpu encoder layer (non-trivial LN params) and the same
    weights in the port's EncoderLayer, carried across by convert.py."""
    p = JL.enc_layer_init(jax.random.PRNGKey(0), D, FF)
    rng = np.random.default_rng(0)
    for ln in ("ln1", "ln2"):
        p[ln] = {"scale": rng.uniform(0.5, 1.5, D).astype(np.float32),
                 "bias": rng.normal(0, 0.1, D).astype(np.float32)}
    p = jax.tree.map(np.asarray, p)
    sd = {}
    _ln(sd, "norm1", p["ln1"])
    _mha(sd, "self_attn", p["attn"])
    _ln(sd, "norm2", p["ln2"])
    _lin(sd, "linear1", p["ffn"]["lin1"])
    _lin(sd, "linear2", p["ffn"]["lin2"])
    layer = EncoderLayer(D, FF)
    layer.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    return p, layer


@pytest.fixture()
def x():
    return np.random.default_rng(1).normal(0, 1, (2, 7, D)).astype(np.float32)


def test_layer_norm(enc_layer, x):
    p, layer = enc_layer
    got = L.layer_norm(_t(x), layer.norm1.weight, layer.norm1.bias)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(JL.layer_norm(p["ln1"], x)),
                               atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_mha(enc_layer, x, masked):
    p, layer = enc_layer
    kv = np.random.default_rng(2).normal(0, 1, (2, 5, D)).astype(np.float32)
    mask = np.triu(np.ones((7, 5), bool), k=1)[None, None] if masked else None
    a = layer.self_attn
    with torch.inference_mode():
        got = L.mha(_t(x), _t(kv), a.in_proj_weight, a.in_proj_bias,
                    a.out_proj.weight, a.out_proj.bias, HEADS,
                    None if mask is None else torch.from_numpy(mask))
    want = JL.mha(p["attn"], x, kv, HEADS,
                  None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_ffn_and_encoder_layer(enc_layer, x):
    p, layer = enc_layer
    with torch.inference_mode():
        got = L.ffn(_t(x), layer.linear1.weight, layer.linear1.bias,
                    layer.linear2.weight, layer.linear2.bias)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(JL.ffn(p["ffn"], x)), atol=1e-5)
        got = L.encoder_layer(layer, _t(x), HEADS)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(JL.encoder_layer(p, x, HEADS)),
                               atol=1e-5)


def test_position_tables():
    np.testing.assert_array_equal(L.sinusoid_table(522, 256),
                                  JL.sinusoid_table(522, 256))
    for shape in [(6, 160, 256), (6, 40, 64), (2, 3, 1)]:
        np.testing.assert_array_equal(L.pos_enc_2d(*shape),
                                      JL.pos_enc_2d(*shape))


def test_committed_checkpoint_encoder_and_ctc_match_jax():
    """8 smoke lines at W=640, float32: encoder memory and CTC logits within
    1e-4 of kiri_tpu; greedy CTC ids and lengths equal."""
    ckpt = str(REPO / "models" / "model.safetensors")
    variables, jcfg, _ = j_load(ckpt)
    jcfg = jcfg.replace(COMPUTE_DTYPE="float32")
    model, _, _ = load_checkpoint(ckpt, device="cpu")
    imgs = load_smoke_lines()[0]["imgs"][:8]

    @jax.jit
    def jax_path(v, x):
        mem, _ = R.encode(v, x, jcfg)
        return mem, R.ctc_logits(v["params"], mem, jcfg), R.mem_project(
            v["params"], mem)

    mem, ctc, memp = (np.asarray(a) for a in jax_path(variables, imgs))
    with torch.inference_mode():
        tmem = model.encode(torch.from_numpy(imgs), torch.float32)
        tctc = model.ctc_logits(tmem)
        np.testing.assert_allclose(tmem.numpy(), mem, atol=1e-4)
        np.testing.assert_allclose(tctc.numpy(), ctc, atol=1e-4)
        np.testing.assert_allclose(model.mem_project(tmem).numpy(), memp,
                                   atol=1e-4)
        ids, conf, est = greedy_ctc_stats(tctc)
    jids, jconf, jest = (np.asarray(a) for a in j_greedy(jnp.asarray(ctc)))
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_array_equal(est.numpy(), jest)
    np.testing.assert_allclose(conf.numpy(), jconf, atol=1e-6)
