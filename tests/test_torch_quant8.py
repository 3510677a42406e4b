"""kiri_tpu_torch's int8 fast path (``ops/quant8.Q8Encoder`` over the plain
versions of ``kernels/quant8.py``) against ``kiri_tpu/ops/quant8.py`` on the
CPU, at the size of ``tests/test_quant8.py`` (width 64, 2 layers, 4 heads,
FF 128, lines 48 x 128), and on the committed checkpoint against the texts
stored in ``kiri_tpu_torch/assets/smoke_q8.npz``.

Tolerances and why:
* quantization (``_qw``, ``_qa``) and the int8 contractions: bit for bit;
* ``pack``: int8 weights equal; the encoder's scales bit for bit; the stem's
  folded weights and their scales within 5e-7 relative (a few float32
  ulps: an ulp of rsqrt, then the rounding of the two products and the
  division by 127 after it) and its biases within 2e-7, because XLA:CPU's
  ``lax.rsqrt`` and ``torch.rsqrt`` round differently (neither is correctly
  rounded) in the BatchNorm fold;
* ``calibrate``: the encoder's per-tensor scales within 1e-6 relative; the
  stem's per-channel scales within 1e-5 relative, since each is a channel's
  abs-max after float32 convolutions of 432-864 products summed in another
  order (1.1e-6 measured), and so a folded int8 weight may move by 1;
* the forward on ``kiri_tpu``'s scales, float32: every CTC frame's argmax
  equal, and mem and logits within 2e-2 (5e-4 on average). The two
  packages' float32 sums (the stem's convolutions, LayerNorm) differ in the
  last bits, and where an activation lies that close to a rounding boundary
  of its quantization, the int8 values differ by 1: a product then moves by
  up to a step of the activation scale (0.027 for the encoder's input here).
  Measured: 2.5e-5 with the stem quantized (its int8 input is the u8 line),
  8.2e-3 for {attn, ffn} (the stem's float32 convolution feeds the
  quantized encoder);
  bfloat16: within 2^-4 (mem) and 2^-5 (logits), 4 and 2 bf16 steps at
  their scale, 1e-2 on average, and 95% of the frames' argmax (random
  weights give near-uniform frames).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decoder_layers import few_torch_threads  # noqa: F401
from test_torch_decoder_layers import make_small_model

from kiri_tpu.ops import quant8 as JQ
from kiri_tpu_torch.convert import q8_scales_from_jax
from kiri_tpu_torch.kernels.quant8 import (q8_conv3x3, q8_conv3x3_plain,
                                           q8_conv_acc, q8_linear,
                                           q8_linear_plain, q8_matmul_acc,
                                           quantize)
from kiri_tpu_torch.kernels.stem import STRIDES
from kiri_tpu_torch.ops import quant8 as TQ
from kiri_tpu_torch.smoke import q8_scales

PARTS = (("stem",), ("stem", "attn", "ffn"), ("attn", "ffn"))
TOL_F32 = 1e-5              # kiri_tpu's own reference path, no int8
TOL_F32_Q8, TOL_F32_Q8_MEAN = 2e-2, 5e-4
TOL_FOLD = 5e-7
TOL_STEM_CALIB = 1e-5
TOL_ENC_CALIB = 1e-6
TOL_BF16_MEM, TOL_BF16_CTC, TOL_BF16_MEAN = 2.0 ** -4, 2.0 ** -5, 1e-2


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(a)))


def _jax_np(tree):
    return jax.tree.map(np.asarray, tree)


def _small(tmp_path_factory, dtype):
    """(kiri_tpu variables and cfg, the port's model and cfg), width 64, two
    layers, 48 x 128 lines, BatchNorm statistics drawn at random in both."""
    tmp = tmp_path_factory.mktemp(f"q8_{dtype}")
    variables, jcfg, _, model, cfg, _ = make_small_model(
        tmp, 0, IMG_W=128, COMPUTE_DTYPE=dtype)
    rng = np.random.default_rng(3)
    stats = variables["batch_stats"]["stem"]
    for i in range(4):
        bn = stats[f"bn{i}"]
        mean = rng.normal(0, 0.2, bn["mean"].shape).astype(np.float32)
        var = (np.abs(rng.normal(0, 1, bn["var"].shape)) + 0.5).astype(
            np.float32)
        stats[f"bn{i}"] = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}
        net = model.stem.net[3 * i + 1]
        net.running_mean.copy_(torch.from_numpy(mean))
        net.running_var.copy_(torch.from_numpy(var))
    return variables, jcfg, model, cfg


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return _small(tmp_path_factory, "float32")


@pytest.fixture(scope="module")
def small_bf16(tmp_path_factory):
    return _small(tmp_path_factory, "bfloat16")


@pytest.fixture(scope="module")
def imgs():
    return np.random.default_rng(0).integers(0, 256, (4, 48, 128), np.uint8)


@pytest.fixture(scope="module")
def jax_runs(small, imgs):
    """kiri_tpu's Q8Encoder of each parts set, calibrated, with its mem and
    logits."""
    variables, jcfg, _, _ = small
    out = {}
    for parts in PARTS:
        q = JQ.Q8Encoder(variables, jcfg, parts=parts)
        q.calibrate(imgs)
        out[parts] = (q, *jax.device_get(q(imgs)))
    return out


# ------------------------------------------------------------ quantization
def test_qw_matches_jax_bit_for_bit():
    """Per-output-channel int8 weights and scales, with exact .5 ties: each
    channel's largest value is 127 x its scale, a power of two, so w / scale
    lands exactly on the halves put in."""
    rng = np.random.default_rng(1)
    scales = (2.0 ** -rng.integers(7, 10, 24)).astype(np.float32)
    w = (rng.uniform(-100, 100, (3, 3, 16, 24)) * scales).astype(np.float32)
    w[0, 0, 0] = 127 * scales
    w[1, 1, 1] = (np.arange(24) % 7 - 3.5).astype(np.float32) * scales
    w[2, 2, 2] = -127 * scales
    jq, js = JQ._qw(jnp.asarray(w), axis=3)
    tq, ts = TQ._qw(torch.from_numpy(w.reshape(-1, 24)).t(), axis=0)
    np.testing.assert_array_equal(np.asarray(jq).reshape(-1, 24).T, tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(tq.numpy()[:, 4 * 16 + 1], np.round(
        np.arange(24) % 7 - 3.5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1.0, 0.5, 0.1, 0.0123])
def test_qa_matches_jax_bit_for_bit(dtype, scale):
    """Per-tensor activation quantization in float32 with 1 / scale taken in
    float32, round half to even (x / scale on the halves), clamp +-127."""
    rng = np.random.default_rng(2)
    x = np.concatenate([
        rng.normal(0, 40 * scale, 500),
        (np.arange(-300, 301) + 0.5) * scale,        # ties at scales 1, 0.5
        [1e6, -1e6, 127.5 * scale, -127.5 * scale, 0.0]]).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(JQ._qa(jx, jnp.float32(scale)))
    got = TQ._qa(torch.from_numpy(np.array(jx, np.float32)).to(
        getattr(torch, dtype)), float(np.float32(scale)))
    np.testing.assert_array_equal(want, got.numpy())
    assert got.dtype == torch.int8 and np.abs(got.numpy()).max() == 127


# ---------------------------------------------------- integer contractions
@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("cin", [1, 16])
def test_conv_acc_equals_lax_conv(stride, cin):
    """The plain int8 convolution equals XLA's conv_general_dilated with
    int32 accumulation, at each stem stride (odd sizes: the padding edge)."""
    rng = np.random.default_rng(cin + 10 * stride[0])
    x = rng.integers(-127, 128, (2, 13, 21, cin), dtype=np.int8)
    w = rng.integers(-127, 128, (3, 3, cin, 24), dtype=np.int8)
    x[0, 0, 0], w[0, 0, 0] = 127, -127
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), window_strides=stride,
        padding=((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    got = q8_conv_acc(torch.from_numpy(x), torch.from_numpy(
        np.ascontiguousarray(w.reshape(-1, 24).T)), stride)
    np.testing.assert_array_equal(np.asarray(want),
                                  got.to(torch.int32).numpy())
    assert torch.equal(got, got.round())


def test_matmul_acc_equals_dot_general():
    """int8 x int8 -> int32 at the largest sum the encoder makes (K 1024,
    all 127s), ragged M."""
    rng = np.random.default_rng(4)
    x = rng.integers(-127, 128, (37, 1024), dtype=np.int8)
    w = rng.integers(-127, 128, (1024, 40), dtype=np.int8)
    x[0], w[:, 0] = 127, 127
    want = jax.lax.dot_general(jnp.asarray(x), jnp.asarray(w),
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    got = q8_matmul_acc(torch.from_numpy(x),
                        torch.from_numpy(np.ascontiguousarray(w.T)))
    np.testing.assert_array_equal(np.asarray(want),
                                  got.to(torch.int32).numpy())
    assert int(np.asarray(want)[0, 0]) == 1024 * 127 * 127


def test_wrappers_take_the_plain_versions_on_cpu():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(0, 1, (2, 9, 11, 16)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, (24, 144), dtype=np.int8))
    inv = torch.from_numpy(rng.uniform(10, 60, 16).astype(np.float32))
    sc = torch.from_numpy(rng.uniform(1e-4, 1e-3, 24).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, 24).astype(np.float32))
    args = (x, w, sc, b, (2, 2))
    assert torch.equal(q8_conv3x3(*args, inv=inv),
                       q8_conv3x3_plain(*args, inv=inv))
    xl = x.reshape(-1, 16)
    assert torch.equal(q8_linear(xl, 40.0, w[:, :16], sc, b),
                       q8_linear_plain(xl, 40.0, w[:, :16], sc, b))
    assert torch.equal(quantize(xl, 40.0)[:3], torch.round(
        xl[:3] * 40.0).clamp(-127, 127).to(torch.int8))


# ---------------------------------------------------------------- Q8Encoder
def test_pack_matches_jax(small):
    variables, jcfg, model, cfg = small
    jq = JQ.Q8Encoder(variables, jcfg)
    tq = TQ.Q8Encoder(model, cfg, device="cpu")
    for j, t in zip(jq.pack["stem"], tq.pack["stem"]):
        cout = t["w"].shape[0]
        np.testing.assert_array_equal(
            np.asarray(j["w"]).reshape(-1, cout).T, t["w"].numpy())
        # b = beta - mean * inv: an ulp of inv moves it by ~1e-8 here.
        np.testing.assert_allclose(np.asarray(j["b"]), t["b"].numpy(),
                                   atol=2e-7, rtol=0)
        wf = np.asarray(j["wf"]).reshape(-1, cout)
        assert np.all(np.abs(wf - t["wf"].numpy()) <= TOL_FOLD * np.abs(wf))
        assert _rel(j["ws"], t["ws"]) <= TOL_FOLD
    for jl, tl in zip(jq.pack["enc"], tq.pack["enc"]):
        want = {"qkv": [jl[k] for k in ("wq", "wk", "wv")],
                "wo": [jl["wo"]], "lin1": [jl["lin1"]], "lin2": [jl["lin2"]]}
        for name, subs in want.items():
            np.testing.assert_array_equal(
                np.concatenate([np.asarray(s["w"]).T for s in subs]),
                tl[name]["w"].numpy())
            np.testing.assert_array_equal(
                np.concatenate([np.asarray(s["ws"]) for s in subs]),
                tl[name]["ws"].numpy())
            np.testing.assert_array_equal(
                np.concatenate([np.asarray(s["b"]) for s in subs]),
                tl[name]["b"].numpy())


@pytest.mark.parametrize("parts", PARTS, ids="_".join)
def test_calibrate_matches_jax(small, imgs, jax_runs, parts):
    _, _, model, cfg = small
    tq = TQ.Q8Encoder(model, cfg, parts=parts, device="cpu")
    tq.calibrate(imgs)
    js, ts = _jax_np(jax_runs[parts][0].scales), tq.scales
    assert len(ts["stem"]) == len(js["stem"]) == (3 if "stem" in parts else 0)
    for j, t in zip(js["stem"], ts["stem"]):
        assert _rel(j["inv"], t["inv"]) <= TOL_STEM_CALIB
        assert _rel(j["ws"], t["ws"]) <= TOL_STEM_CALIB
        wq = j["wq"].reshape(-1, j["wq"].shape[3]).T
        diff = np.abs(wq.astype(np.int32) - t["wq"].numpy())
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    n = (4 * ("attn" in parts) + 2 * ("ffn" in parts)) * cfg.ENC_LAYERS
    assert len(ts["enc"]) == len(js["enc"]) == n
    if n:
        assert _rel(js["enc"], ts["enc"]) <= TOL_ENC_CALIB


def test_scales_from_jax_layout(jax_runs):
    js = _jax_np(jax_runs[PARTS[1]][0].scales)
    ts = q8_scales_from_jax(js)
    for j, t in zip(js["stem"], ts["stem"]):
        kh, kw, cin, cout = j["wq"].shape
        assert t["wq"].shape == (cout, 9 * cin) and t["wq"].is_contiguous()
        assert t["wq"][5, 2 * cin + 7] == j["wq"][0, 2, 7, 5]
        np.testing.assert_array_equal(t["inv"].numpy(), j["inv"])
        np.testing.assert_array_equal(t["ws"].numpy(), j["ws"])
    np.testing.assert_array_equal(np.float32(ts["enc"]),
                                  np.asarray(js["enc"], np.float32))


@pytest.mark.parametrize("parts", PARTS, ids="_".join)
def test_forward_f32_on_jax_scales(small, imgs, jax_runs, parts):
    _, _, model, cfg = small
    jq, mem_j, ctc_j = jax_runs[parts]
    tq = TQ.Q8Encoder(model, cfg, parts=parts, device="cpu")
    tq.scales = q8_scales_from_jax(_jax_np(jq.scales))
    mem, ctc = tq(imgs)
    assert mem.dtype == torch.float32 and ctc.shape == ctc_j.shape
    for got, want in ((mem.numpy(), mem_j), (ctc.numpy(), ctc_j)):
        diff = np.abs(got - want)
        assert diff.max() <= TOL_F32_Q8 and diff.mean() <= TOL_F32_Q8_MEAN
    np.testing.assert_array_equal(ctc.numpy().argmax(-1), ctc_j.argmax(-1))


@pytest.mark.parametrize("parts", PARTS, ids="_".join)
def test_forward_bf16_on_jax_scales(small_bf16, imgs, parts):
    variables, jcfg, model, cfg = small_bf16
    jq = JQ.Q8Encoder(variables, jcfg, parts=parts)
    jq.calibrate(imgs)
    mem_j, ctc_j = (np.asarray(a, np.float32)
                    for a in jax.device_get(jq(imgs)))
    tq = TQ.Q8Encoder(model, cfg, parts=parts, device="cpu")
    tq.scales = q8_scales_from_jax(_jax_np(jq.scales))
    mem, ctc = tq(imgs)
    assert mem.dtype == torch.bfloat16 and ctc.dtype == torch.float32
    dm = np.abs(mem.float().numpy() - mem_j)
    assert dm.max() <= TOL_BF16_MEM and dm.mean() <= TOL_BF16_MEAN
    assert np.abs(ctc.numpy() - ctc_j).max() <= TOL_BF16_CTC
    assert np.mean(ctc.numpy().argmax(-1) == ctc_j.argmax(-1)) >= 0.95


def test_bf16_is_the_ports_encode_and_ctc(small, imgs):
    variables, jcfg, model, cfg = small
    tq = TQ.Q8Encoder(model, cfg, device="cpu")
    mem, ctc = tq.bf16(imgs)
    with torch.inference_mode():
        want = model.encode(torch.from_numpy(imgs), torch.float32)
        assert torch.equal(mem, want)
        assert torch.equal(ctc, model.ctc_logits(want))
    mem_j, ctc_j = jax.device_get(JQ.Q8Encoder(variables, jcfg).bf16(imgs))
    np.testing.assert_allclose(mem.numpy(), mem_j, atol=TOL_F32, rtol=0)
    np.testing.assert_allclose(ctc.numpy(), ctc_j, atol=TOL_F32, rtol=0)


def test_random_weights_close(small, imgs):
    """The port's own int8 path tracks its reference path
    (``test_quant8_random_weights_close``'s bounds)."""
    _, _, model, cfg = small
    q = TQ.Q8Encoder(model, cfg, device="cpu")
    q.calibrate(imgs)
    mem_q, ctc_q = (t.numpy() for t in q(imgs))
    mem_b, ctc_b = (t.numpy() for t in q.bf16(imgs))
    cos = float(np.sum(mem_q * mem_b)
                / (np.linalg.norm(mem_q) * np.linalg.norm(mem_b)))
    assert cos > 0.995, cos
    agree = float(np.mean(ctc_q.argmax(-1) == ctc_b.argmax(-1)))
    assert agree > 0.94, agree


def test_calibrate_before_call_and_equal_qkv_scales(small, imgs):
    _, _, model, cfg = small
    q = TQ.Q8Encoder(model, cfg, parts=("attn",), device="cpu")
    with pytest.raises(RuntimeError, match="calibrate"):
        q(imgs)
    with pytest.raises(ValueError, match="unknown parts"):
        TQ.Q8Encoder(model, cfg, parts=("stem", "head"), device="cpu")
    q.calibrate(imgs)
    assert len(q.scales["enc"]) == 4 * cfg.ENC_LAYERS
    q.scales = {"stem": [], "enc": [0.1, 0.1, 0.2, 0.1] * cfg.ENC_LAYERS}
    with pytest.raises(ValueError, match="three scales"):
        q(imgs)


def test_device_none_without_a_card_raises(small, monkeypatch):
    _, _, model, cfg = small
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TQ.Q8Encoder(model, cfg)


# ---------------------------------------------- the committed checkpoint
@pytest.fixture(scope="module")
def v13():
    from kiri_tpu_torch.checkpoints import find_vocab_file, load_checkpoint
    from kiri_tpu_torch.smoke import MODELS, load_smoke_lines, load_smoke_q8
    from kiri_tpu_torch.tokenizer import CharTokenizer

    ckpt = str(MODELS / "model.safetensors")
    model, cfg, meta = load_checkpoint(ckpt, device="cpu")
    tok = CharTokenizer(find_vocab_file(meta.get("vocab_path", ""), ckpt),
                        cfg)
    return model, cfg.replace(COMPUTE_DTYPE="float32"), tok, \
        load_smoke_lines()[0]["imgs"], load_smoke_q8()


@pytest.mark.parametrize("parts", PARTS, ids="_".join)
def test_checkpoint_f32_texts_equal_stored(v13, parts):
    """Full v13 width, float32, kiri_tpu's stored scales: the greedy CTC
    texts of the first 16 smoke lines equal kiri_tpu's."""
    model, cfg, tok, imgs, stored = v13
    key = "_".join(parts)
    q = TQ.Q8Encoder(model, cfg, parts=parts, device="cpu")
    q.scales = q8_scales_from_jax(q8_scales(stored, parts))
    _, ctc = q(imgs[:16])
    got = tok.decode_ctc_batch(ctc.numpy().argmax(-1))
    assert got == [str(t) for t in stored[f"{key}_texts_f32"][:16]]


def test_fixture_holds_every_parts_set(v13):
    stored = v13[4]
    for parts in PARTS:
        key = "_".join(parts)
        for d in ("f32", "bf16"):
            assert stored[f"{key}_texts_{d}"].shape == (64,)
            assert 0.0 <= float(stored[f"{key}_cer_{d}"]) < 0.05
        assert len(stored[f"{key}_enc"]) == (
            4 * ("attn" in parts) + 2 * ("ffn" in parts)) * 4
