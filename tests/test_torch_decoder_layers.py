"""kiri_tpu_torch's decoder (whole-sequence pass, KV-cached steps, fused
output heads, weights cast once) against kiri_tpu at float32 on the CPU, on
a small random model: 2+2 layers, width 64, 4 heads, 10-class vocabulary.
Tolerance 1e-4 (summation order only)."""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kiri_tpu.config import CFG as JCFG
from kiri_tpu.models import recognizer as R
from kiri_tpu.tokenizer import CharTokenizer as JTok
from kiri_tpu_torch.checkpoints import build_model
from kiri_tpu_torch.config import CFG
from kiri_tpu_torch.convert import state_dict_from_jax
from kiri_tpu_torch.models import layers as L
from kiri_tpu_torch.tokenizer import CharTokenizer

SMALL = dict(ENC_DIM=64, ENC_LAYERS=2, ENC_FF=128, ENC_HEADS=4, DEC_DIM=64,
             DEC_LAYERS=2, DEC_FF=128, DEC_HEADS=4, IMG_H=48, IMG_W=160,
             MAX_DEC_LEN=64, COMPUTE_DTYPE="float32",
             BATCH_BUCKETS=(1, 2, 4, 8), STEP_BUCKETS=(16, 32, 64),
             WIDTH_BUCKETS=(96, 160))
ATOL = 1e-4


def make_small_model(tmp_path, seed: int = 0, **overrides):
    """(kiri_tpu variables, its cfg and tokenizer, the port's model, cfg and
    tokenizer): one random model in both packages, carried across by
    ``convert.state_dict_from_jax``. LayerNorm parameters and biases are
    drawn at random so that none of them drops out of a comparison."""
    vocab = {"<unk>": 0}
    vocab.update({ch: i + 1 for i, ch in enumerate("abcde ")})
    vp = tmp_path / "vocab.json"
    vp.write_text(json.dumps(vocab))
    kw = dict(SMALL, **overrides)
    jcfg, cfg = JCFG(**kw), CFG(**kw)
    jtok = JTok(str(vp), jcfg)
    variables = R.init_recognizer(jax.random.PRNGKey(seed), jcfg, jtok)
    rng = np.random.default_rng(seed)

    def jitter(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'scale'" in name or "'b'" in name or "'bias'" in name:
            return leaf + rng.normal(0, 0.1, leaf.shape).astype(np.float32)
        return leaf
    variables = dict(variables, params=jax.tree_util.tree_map_with_path(
        jitter, variables["params"]))
    sd = state_dict_from_jax(
        jax.tree.map(np.asarray, {k: variables[k]
                                  for k in ("params", "batch_stats")}),
        max_dec_len=cfg.MAX_DEC_LEN)
    return variables, jcfg, jtok, build_model(sd, cfg), cfg, CharTokenizer(
        str(vp), cfg)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads while a module of these tests runs: the test
    workers run side by side, and eight spinning threads each only get in
    each other's way at these sizes."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return make_small_model(tmp_path_factory.mktemp("small"))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    memp = rng.normal(0, 1, (3, 40, 64)).astype(np.float32)
    tokens = rng.integers(3, 10, (3, 12)).astype(np.int32)
    tokens[:, 0] = 1
    return memp, tokens


def _t(x):
    return torch.from_numpy(np.array(x))


def test_decoder_layer_matches_jax(small, inputs):
    variables, _, _, model, cfg, _ = small
    memp, _ = inputs
    x = np.random.default_rng(1).normal(0, 1, (3, 12, 64)).astype(np.float32)
    causal = np.triu(np.ones((12, 12), bool), k=1)
    from kiri_tpu.models import layers as JL
    want = JL.decoder_layer(variables["params"]["dec_layers"][0], x, memp,
                            cfg.DEC_HEADS, jnp.asarray(causal)[None, None])
    with torch.inference_mode():
        got = L.decoder_layer(model.dec.layers[0], _t(x), _t(memp),
                              cfg.DEC_HEADS, _t(causal))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_decoder_forward_heads_matches_jax(small, inputs):
    variables, jcfg, _, model, _, _ = small
    memp, tokens = inputs
    dec, lm = R.decoder_forward_heads(variables, memp, tokens, jcfg)
    with torch.inference_mode():
        tdec, tlm = model.decoder_forward_heads(_t(memp), _t(tokens))
    assert tdec.dtype == tlm.dtype == torch.float32
    np.testing.assert_allclose(tdec.numpy(), np.asarray(dec), atol=ATOL)
    np.testing.assert_allclose(tlm.numpy(), np.asarray(lm), atol=ATOL)


@pytest.mark.parametrize("beams", [1, 3])
def test_decoder_steps_reproduce_the_whole_pass(small, inputs, beams):
    """Position by position, a run of KV-cached steps gives the whole-sequence
    pass's logits, and kiri_tpu's step's; with K beams a line's rows share
    its cross K/V and each reproduces the line."""
    variables, jcfg, _, model, cfg, _ = small
    memp, tokens = inputs
    n, lt = tokens.shape
    rep = np.repeat(tokens, beams, axis=0)
    jcross = R.decode_prepare(variables, jnp.asarray(memp), jcfg)
    jcache = R.init_decode_cache(jcfg, n * beams, lt)
    with torch.inference_mode():
        full_dec, full_lm = model.decoder_forward_heads(_t(memp), _t(tokens))
        cross = model.decode_prepare(_t(memp))
        assert cross[0][0].shape == (n, cfg.DEC_HEADS, 40, 16)
        cache = model.init_decode_cache(n * beams, lt, torch.float32)
        assert cache.shape == (2, n * beams, lt, 2, cfg.DEC_HEADS, 16)
        for pos in range(lt):
            dec, lm = model.decoder_step(_t(rep[:, pos]), pos, cache, cross)
            jdec, jlm, jcache = R.decoder_step(
                variables, jnp.asarray(rep[:, pos]), pos, jcache, jcross,
                jcfg, beams=beams)
            np.testing.assert_allclose(dec.numpy(), np.asarray(jdec),
                                       atol=ATOL)
            np.testing.assert_allclose(lm.numpy(), np.asarray(jlm), atol=ATOL)
            for b in range(beams):
                np.testing.assert_allclose(dec[b::beams].numpy(),
                                           full_dec[:, pos].numpy(),
                                           atol=ATOL)
                np.testing.assert_allclose(lm[b::beams].numpy(),
                                           full_lm[:, pos].numpy(), atol=ATOL)
        np.testing.assert_allclose(cache.numpy(), np.asarray(jcache),
                                   atol=ATOL)


def test_model_without_lm_head_or_position_table(tmp_path):
    variables, jcfg, _, model, _, _ = make_small_model(tmp_path, seed=1,
                                                       USE_LM=False)
    rng = np.random.default_rng(2)
    memp = rng.normal(0, 1, (2, 20, 64)).astype(np.float32)
    tokens = rng.integers(1, 10, (2, 6)).astype(np.int32)
    dec, lm = R.decoder_forward_heads(variables, memp, tokens, jcfg)
    assert lm is None
    with torch.inference_mode():
        tdec, tlm = model.decoder_forward_heads(_t(memp), _t(tokens))
        assert tlm is None
        np.testing.assert_allclose(tdec.numpy(), np.asarray(dec), atol=ATOL)
        assert model.decoder_weights(torch.float32).head_w.shape == (10, 64)


def test_decoder_weights_are_built_once_and_follow_the_parameters(tmp_path):
    _, _, _, model, _, _ = make_small_model(tmp_path, seed=2)
    memp = _t(np.random.default_rng(3).normal(0, 1, (2, 20, 64)).astype(
        np.float32))
    tokens = _t(np.asarray([[1, 4, 5, 6], [1, 7, 8, 9]], np.int32))
    with torch.inference_mode():
        w32 = model.decoder_weights(torch.float32)
        before, _ = model.decoder_forward_heads(memp, tokens)
        assert model.decoder_weights(torch.float32) is w32
        w16 = model.decoder_weights(torch.bfloat16)
    assert w16 is not w32 and model.decoder_weights(torch.bfloat16) is w16
    # Matrices and their biases in the compute dtype, LayerNorm in float32;
    # float32 casts nothing.
    assert w16.layers[0].linear1.weight.dtype == torch.bfloat16
    assert w16.layers[0].self_attn.in_proj_weight.dtype == torch.bfloat16
    assert w16.layers[0].self_attn.in_proj_bias.dtype == torch.bfloat16
    assert w16.layers[0].linear1.bias.dtype == torch.bfloat16
    assert w16.layers[0].norm1.weight.dtype == torch.float32
    assert w16.layers[0].norm1.bias.dtype == torch.float32
    assert w16.emb.dtype == w16.pe.dtype == w16.head_w.dtype == torch.bfloat16
    assert w16.head_w.shape == (20, 64) and w16.head_b.dtype == torch.bfloat16
    assert (w32.layers[0].linear1.weight.data_ptr()
            == model.dec.layers[0].linear1.weight.data_ptr())
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sd["dec_head.weight"] = sd["dec_head.weight"] * 1.5
    model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        assert model.decoder_weights(torch.float32) is not w32
        after, _ = model.decoder_forward_heads(memp, tokens)
    np.testing.assert_allclose(after.numpy(), before.numpy() * 1.5
                               - 0.5 * model.dec_head.bias.detach().numpy(),
                               atol=1e-4)


def test_bf16_decoder_stays_near_float32(small, inputs):
    """bf16 matmuls with float32 sums, LayerNorm and softmax: logits within
    a few bf16 ulps of the float32 pass at this depth (0.15 on logits of
    scale ~1), and float32 on the way out."""
    _, _, _, model, _, _ = small
    memp, tokens = inputs
    with torch.inference_mode():
        dec32, _ = model.decoder_forward_heads(_t(memp), _t(tokens))
        dec16, lm16 = model.decoder_forward_heads(_t(memp).bfloat16(),
                                                  _t(tokens))
        cross = model.decode_prepare(_t(memp).bfloat16())
        cache = model.init_decode_cache(3, 12, torch.bfloat16)
        step, _ = model.decoder_step(_t(tokens[:, 0]), 0, cache, cross)
    assert dec16.dtype == lm16.dtype == step.dtype == torch.float32
    assert cache.dtype == torch.bfloat16 and cross[0][0].dtype == torch.float32
    assert float((dec16 - dec32).abs().max()) < 0.15
    assert float((step - dec32[:, 0]).abs().max()) < 0.15
