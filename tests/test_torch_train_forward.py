"""The port's train-mode recognizer forward, hybrid loss and gradients
against kiri_tpu's on the small model (weights carried across by
``convert.py``, batches from a numpy seed); dropout sites and masks;
decoder-only mode and decoder-input noise; from-scratch init."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kiri_tpu.models import recognizer as R
from kiri_tpu.train import trainer as JT
from kiri_tpu_torch import convert
from kiri_tpu_torch.models import layers as L
from kiri_tpu_torch.models.recognizer import Recognizer
from kiri_tpu_torch.train import trainer as T

from torch_train import (both, grads_by_name, jax_init, port_model,
                         port_state, samples, to_torch)

TOL_FWD = 1e-5      # x (max |ref| + 1)
TOL_LOSS = 1e-5     # relative
TOL_GRAD = 1e-4     # x (max |ref grad| + 1e-6), each parameter
TOL_BF16 = 2e-2     # relative, the loss in bfloat16
TOL_F64 = 1e-10     # relative, both packages in float64 (3.3e-14 measured)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg, cfg, jtok, tok = both(tmp_path_factory.mktemp("fwd"))
    var = jax_init(jcfg, jtok)
    batch = JT.collate(samples(8), jtok)
    return jcfg, cfg, jtok, tok, var, batch


def _loss_kw(tok, **kw):
    return dict(dec_pad=tok.dec_pad, ctc_weight=0.5, dec_weight=0.5, **kw)


def _jax_value_and_grad(var, batch, jcfg, jtok, **kw):
    def f(params):
        v = {**var, "params": params}
        loss, (stats, m) = JT.hybrid_loss(
            v, {k: jnp.asarray(x) for k, x in batch.items()},
            jax.random.PRNGKey(1), cfg=jcfg, **_loss_kw(jtok, **kw))
        return loss, (stats, m)
    return jax.jit(jax.value_and_grad(f, has_aux=True))(var["params"])


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max()) <= tol * (np.abs(ref).max() + 1)


def test_train_forward_matches_kiri_tpu(setup):
    jcfg, cfg, _, _, var, batch = setup
    model = port_model(var, cfg)
    jmem, jstats = R.encode(var, jnp.asarray(batch["image"]), jcfg,
                            train=True)
    jctc = R.ctc_logits(var["params"], jmem, jcfg, train=True)
    jdec = R.decoder_train_logits(var, R.mem_project(var["params"], jmem),
                                  jnp.asarray(batch["dec_inp"]), jcfg,
                                  train=True)
    with torch.no_grad():
        mem, stats = model.encode(torch.from_numpy(batch["image"]),
                                  torch.float32, train=True)
        ctc = model.ctc_logits(mem)
        dec = model.decoder_train_logits(
            model.mem_project(mem), torch.from_numpy(batch["dec_inp"]))
    assert dec.dtype == ctc.dtype == torch.float32
    for got, ref in ((mem, jmem), (ctc, jctc), (dec, jdec)):
        assert got.shape == ref.shape
        assert _close(got, ref, TOL_FWD)
    for i, (mean, var_) in enumerate(stats):
        ref = jstats["stem"][f"bn{i}"]
        assert _close(mean, ref["mean"], TOL_FWD)
        assert _close(var_, ref["var"], TOL_FWD)


def test_train_forward_at_rate_zero_is_inference(setup):
    """Dropout 0 leaves the layer functions what they are at inference; a
    rate above 0 without a generator raises instead of skipping dropout."""
    _, cfg, _, _, var, batch = setup
    model = port_model(var, cfg)
    x = torch.randn(2, 7, cfg.ENC_DIM)
    layer = model.enc.layers[0]
    ref = L.encoder_layer(layer, x, cfg.ENC_HEADS)
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(L.encoder_layer(layer, x, cfg.ENC_HEADS, 0.0, gen), ref)
    assert torch.equal(L.encoder_layer(layer, x, cfg.ENC_HEADS, 0.0, None),
                       ref)
    assert torch.equal(L.dropout(x, 0.0, gen), x)
    with pytest.raises(ValueError, match="Generator"):
        L.encoder_layer(layer, x, cfg.ENC_HEADS, 0.3, None)
    with pytest.raises(ValueError, match="train=True"):
        model.encode(torch.zeros(1, cfg.IMG_H, 64, dtype=torch.uint8),
                     torch.float32, drop=0.3, gen=gen)


def test_hybrid_loss_and_gradients_match_kiri_tpu(setup):
    jcfg, cfg, jtok, tok, var, batch = setup
    (jl, (_, jm)), jg = _jax_value_and_grad(var, batch, jcfg, jtok)
    model = port_model(var, cfg)
    loss, stats, m = T.hybrid_loss(model, to_torch(batch), None, cfg=cfg,
                                   dtype=torch.float32, **_loss_kw(tok))
    loss.backward()
    assert set(m) == set(jm)
    for k in m:
        assert abs(float(m[k]) - float(jm[k])) <= TOL_LOSS * abs(float(jm[k]))
    ref = port_state({"params": jg, "batch_stats": var["batch_stats"]}, cfg)
    got = grads_by_name(model)
    assert set(got) <= set(ref)
    for name, g in got.items():
        r = ref[name]
        err = float((g - r).abs().max())
        assert err <= TOL_GRAD * (float(r.abs().max()) + 1e-6), (name, err)
    # The LM head is never reached: no gradient, in either package.
    assert float(ref["lm_head.weight"].abs().max()) == 0.0
    assert model.lm_head.weight.grad is None


def test_float64_step_matches_kiri_tpu(setup, monkeypatch):
    """In float64 the port's losses and every gradient are kiri_tpu's to
    float64 rounding: kiri_tpu run under 64-bit types with its float32 casts
    made float64, as scripts/make_torch_smoke_train.py stores the float64
    step that the card's float32 step is held to."""
    jcfg, cfg, jtok, tok, var, batch = setup
    model = port_model(var, cfg).double()
    loss, _, m = T.hybrid_loss(model, to_torch(batch), None, cfg=cfg,
                               dtype=torch.float64, **_loss_kw(tok))
    loss.backward()
    spec = importlib.util.spec_from_file_location(
        "make_torch_smoke_train",
        Path(__file__).resolve().parent.parent / "scripts"
        / "make_torch_smoke_train.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    script.kiri_tpu_float32_as_float64(monkeypatch.setattr)
    monkeypatch.setattr(convert, "_f32", lambda x: np.asarray(x, np.float64))
    with jax.enable_x64(True):
        var64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), var)
        (_, (_, jm)), jg = _jax_value_and_grad(var64, batch, jcfg, jtok)
        ref = port_state({"params": jg, "batch_stats": var64["batch_stats"]},
                         cfg)
    assert loss.dtype == torch.float64
    for k in m:
        assert abs(float(m[k]) - float(jm[k])) <= TOL_F64 * abs(float(jm[k]))
    for name, g in grads_by_name(model).items():
        r = ref[name]
        assert g.dtype == r.dtype == torch.float64, name
        err = float((g - r).abs().max())
        assert err <= TOL_F64 * (float(r.abs().max()) + 1e-12), (name, err)


def test_hybrid_loss_bf16_matches_kiri_tpu(tmp_path):
    jcfg, cfg, jtok, tok = both(tmp_path, COMPUTE_DTYPE="bfloat16")
    var = jax_init(jcfg, jtok)
    batch = JT.collate(samples(8, seed=3), jtok)
    (jl, _), _ = _jax_value_and_grad(var, batch, jcfg, jtok)
    model = port_model(var, cfg)
    loss, _, _ = T.hybrid_loss(model, to_torch(batch), None, cfg=cfg,
                               dtype=torch.bfloat16, **_loss_kw(tok))
    assert abs(float(loss) - float(jl)) <= TOL_BF16 * abs(float(jl))


def _jax_dropout_shapes(var, batch, jcfg, jtok):
    """The shapes kiri_tpu's training forward draws dropout masks in
    (jax.random.bernoulli), the stem's Dropout2d mask as NCHW."""
    shapes = []
    real = jax.random.bernoulli

    def record(key, p, shape):
        shapes.append(tuple(shape))
        return real(key, p, shape)

    jax.random.bernoulli = record
    try:
        JT.hybrid_loss({**var}, {k: jnp.asarray(x) for k, x in batch.items()},
                       jax.random.PRNGKey(1), cfg=jcfg, **_loss_kw(jtok))
    finally:
        jax.random.bernoulli = real
    b, _, _, c = shapes[0]
    return [(b, c, 1, 1)] + shapes[1:]


def test_dropout_sites_and_masks(tmp_path):
    """Dropout at kiri_tpu's sites, in its mask shapes: the stem's Dropout2d
    keeps or drops whole channels; the encoder's attention weights, FFN
    hidden layer and residual branches; the CTC head after its LN; the
    decoder's embedding, both attentions, FFN and residuals."""
    jcfg, cfg, jtok, tok = both(tmp_path, DROPOUT=0.5)
    var = jax_init(jcfg, jtok)
    batch = JT.collate(samples(4), jtok)
    want = _jax_dropout_shapes(var, batch, jcfg, jtok)
    model = port_model(var, cfg)
    got, stem_out = [], []
    real = L.dropout

    def record(x, rate, gen, shape=None):
        got.append(tuple(x.shape if shape is None else shape))
        out = real(x, rate, gen, shape)
        if shape is not None:
            stem_out.append(out)
        return out

    L.dropout = record
    try:
        T.hybrid_loss(model, to_torch(batch),
                      torch.Generator().manual_seed(0), cfg=cfg,
                      dtype=torch.float32, **_loss_kw(tok))
    finally:
        L.dropout = real
    assert sorted(got) == sorted(want)
    (feat,) = stem_out                       # NCHW [B, C, H/8, W/4]
    dropped = (feat == 0).flatten(2).all(-1)
    kept = (feat != 0).flatten(2).all(-1)
    assert bool((dropped | kept).all())
    assert 0.3 < float(dropped.float().mean()) < 0.7


def _trainer(var, cfg, tok, **kw):
    tc = T.TrainConfig(**{"lr": 1e-3, "warmup_steps": 2, **kw})
    return T.Trainer(cfg, tok, tc, model=port_model(var, cfg), total_steps=20,
                     device="cpu")


def test_step_runs_without_tf32(setup, monkeypatch):
    """``run_step``'s forward and backward run with cuDNN's and cuBLAS's
    TF32 off whatever the global flags say, which come back after."""
    jcfg, cfg, jtok, tok, var, batch = setup
    flags = torch.backends.cudnn, torch.backends.cuda.matmul
    before = [f.allow_tf32 for f in flags]
    seen = []
    real = T.hybrid_loss

    def record(*args, **kw):
        seen.append([f.allow_tf32 for f in flags])
        return real(*args, **kw)

    monkeypatch.setattr(T, "hybrid_loss", record)
    tr = _trainer(var, cfg, tok)
    try:
        for f in flags:
            f.allow_tf32 = True
        tr.run_step(batch)
        assert seen == [[False, False]]
        assert [f.allow_tf32 for f in flags] == [True, True]
    finally:
        for f, on in zip(flags, before):
            f.allow_tf32 = on


def test_same_generator_seed_same_step(tmp_path):
    jcfg, cfg, jtok, tok = both(tmp_path, DROPOUT=0.15)
    var = jax_init(jcfg, jtok)
    batch = T.collate(samples(8), tok)
    runs = [_trainer(var, cfg, tok, seed=s, dec_input_noise=0.2)
            for s in (7, 7, 8)]
    metrics = [[tr.run_step(batch) for _ in range(2)] for tr in runs]
    assert metrics[0] == metrics[1]
    assert metrics[0][0]["loss"] != metrics[2][0]["loss"]
    for p, q in zip(runs[0].model.parameters(), runs[1].model.parameters()):
        assert torch.equal(p, q)


def test_decoder_only_mode(setup):
    """train_only="decoder": kiri_tpu's loss (CE of the decoder over the
    eval-mode encoder); everything outside the decode path, the BatchNorm
    statistics included, stays bit-identical; the LM head decays."""
    jcfg, cfg, jtok, tok, var, batch = setup
    (jl, (_, jm)), _ = _jax_value_and_grad(var, batch, jcfg, jtok,
                                           train_only="decoder")
    tr = _trainer(var, cfg, tok, train_only="decoder")
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    m = [tr.run_step(batch) for _ in range(3)]
    assert "ctc_loss" not in m[0]
    assert abs(m[0]["loss"] - float(jl)) <= TOL_LOSS * abs(float(jl))
    after = tr.model.state_dict()
    for k, v in before.items():
        top = k.split(".")[0]
        if top in T.DECODER_PARAM_KEYS:
            assert not torch.equal(v, after[k]), k
        else:
            assert torch.equal(v, after[k]), k
    trained = {n for n, _ in tr.trained}
    assert trained == {n for n, _ in tr.model.named_parameters()
                       if n.split(".")[0] in T.DECODER_PARAM_KEYS}
    # lm_head: zero gradients, decayed by AdamW alone.
    w0 = before["lm_head.weight"]
    assert float((after["lm_head.weight"] - w0).abs().max()) > 0


def test_decoder_input_noise(setup):
    """Noise replaces only real tokens (> eos) by ids in [3, dec_vocab)."""
    _, cfg, _, tok, var, batch = setup
    model = port_model(var, cfg)
    seen = []
    real = model.decoder_train_logits

    def capture(memp, ids, drop=0.0, gen=None):
        seen.append(ids)
        return real(memp, ids, drop, gen)

    model.decoder_train_logits = capture
    T.hybrid_loss(model, to_torch(batch), torch.Generator().manual_seed(0),
                  cfg=cfg, dtype=torch.float32, dec_input_noise=0.5,
                  dec_vocab=tok.dec_vocab, **_loss_kw(tok))
    ids, orig = seen[0].numpy(), batch["dec_inp"]
    changed = ids != orig
    assert changed.any()
    assert (orig[changed] > 2).all()
    assert ((ids[changed] >= 3) & (ids[changed] < tok.dec_vocab)).all()
    assert (ids[orig <= 2] == orig[orig <= 2]).all()


def test_init_weights_distributions(setup):
    """From-scratch init: kiri_tpu's distributions (the values differ)."""
    _, cfg, _, tok, _, _ = setup
    model = Recognizer(cfg, tok.vocab_size).init_weights(
        torch.Generator().manual_seed(0))
    lin = model.enc.layers[0].linear2
    assert float(lin.weight.abs().max()) <= lin.in_features ** -0.5
    assert float(lin.weight.abs().max()) > 0.9 * lin.in_features ** -0.5
    attn = model.dec.layers[0].self_attn.in_proj_weight
    assert float(attn.abs().max()) <= cfg.DEC_DIM ** -0.5
    conv = model.stem.net[3].weight
    assert float(conv.abs().max()) <= conv[0].numel() ** -0.5
    assert abs(float(model.dec_emb.weight.std()) - 1.0) < 0.1
    bn = model.stem.net[1]
    assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))
    assert torch.equal(model.enc_ln.weight, torch.ones_like(
        model.enc_ln.weight))
    again = Recognizer(cfg, tok.vocab_size).init_weights(
        torch.Generator().manual_seed(0))
    for p, q in zip(model.parameters(), again.parameters()):
        assert torch.equal(p, q)
