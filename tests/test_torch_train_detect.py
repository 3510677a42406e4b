"""The port's DB and CRAFT trainers against kiri_tpu's, over a
``generate_detector_dataset`` directory made here with kiri_tpu: ground
truth, batches, losses and gradients, a few training steps, and the saved
checkpoints in both packages."""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kiri_tpu.data import docsynth as JD
from kiri_tpu.detect.craft import load_craft_checkpoint as jload_craft
from kiri_tpu.detect.craft.net import init_craft_net
from kiri_tpu.detect.craft.train import craft_loss as jcraft_loss
from kiri_tpu.detect.db import load_db_checkpoint as jload_db
from kiri_tpu.detect.db.net import init_db_net
from kiri_tpu.detect.db.train import DBTrainConfig as JDBConfig
from kiri_tpu.detect.db.train import db_loss as jdb_loss
from kiri_tpu_torch.convert import flatten_params
from kiri_tpu_torch.data import docsynth as D
from kiri_tpu_torch.detect import TextDetector
from kiri_tpu_torch.detect.craft.net import CRAFTNet, state_dict_from_flat
from kiri_tpu_torch.detect.craft.train import (CRAFTTrainConfig, craft_loss,
                                               train_craft)
from kiri_tpu_torch.detect.db.net import DBNet, state_dict_from_jax
from kiri_tpu_torch.detect.db.train import DBTrainConfig, db_loss, train_db

SIZE = 160
TOL_LOSS = 1e-5     # relative
# Per parameter, x max |kiri_tpu grad|. On noisy pages kiri_tpu's float32
# gradients lie within 2e-6 of a float64 run of the port, the port's CPU
# float32 ones within 1.7e-3 (its sums over the 160 x 160 maps, largest for
# the first convs): the bound is the port's own rounding.
TOL_GRAD = 5e-3
TOL_STEPS = 2e-3    # relative, losses of a few training steps


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("det")
    JD.generate_detector_dataset(str(root), 3, width=SIZE, height=SIZE,
                                 seed=7)
    return root


def test_ground_truth_matches_kiri_tpu(dataset):
    ann = json.loads((dataset / "annotations.json").read_text())
    assert len(ann) == 3
    for rec in ann:
        shape = (SIZE, SIZE)
        for a, b in zip(D.db_ground_truth(shape, rec["lines"]),
                        JD.db_ground_truth(shape, rec["lines"])):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(D.craft_ground_truth(shape, rec["chars"]),
                        JD.craft_ground_truth(shape, rec["chars"])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["db", "craft"])
def test_batches_match_kiri_tpu(dataset, kind):
    want = JD.load_detector_batches(str(dataset), kind, 2)
    got = D.load_detector_batches(str(dataset / "annotations.json"), kind, 2)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_written_dataset_is_kiri_tpus(dataset, tmp_path):
    """smoke.write_detector_dataset (the card's fixture directory) lays out
    the same files from the pages and annotations."""
    from PIL import Image

    from kiri_tpu_torch.smoke import write_detector_dataset

    ann = json.loads((dataset / "annotations.json").read_text())
    imgs = np.stack([np.asarray(Image.open(dataset / "images" / a["image"]))
                     for a in ann])
    write_detector_dataset(tmp_path, imgs, ann)
    for p in sorted((dataset / "gt").iterdir()):
        np.testing.assert_array_equal(np.load(tmp_path / "gt" / p.name),
                                      np.load(p))
    for kind in ("db", "craft"):
        for a, b in zip(D.load_detector_batches(str(tmp_path), kind, 3),
                        JD.load_detector_batches(str(dataset), kind, 3)):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def _noisy(batch):
    """The batch with noise on the pages: GroupNorm's variances away from
    0, where either package's float32 rounding is magnified by
    rsqrt(eps)."""
    rng = np.random.default_rng(1)
    img = batch["image"] + rng.normal(0, 0.3, batch["image"].shape)
    return {**batch, "image": img.astype(np.float32)}


def _grads_close(net, ref_sd):
    for name, p in net.named_parameters():
        r = ref_sd[name]
        err = float((p.grad - r).abs().max())
        assert err <= TOL_GRAD * float(r.abs().max()), (name, err)


_DB_KW = dict(k=JDBConfig().k, alpha=JDBConfig().alpha,
              beta=JDBConfig().beta, neg_ratio=JDBConfig().neg_ratio)


@pytest.fixture(scope="module")
def db_grad():
    """kiri_tpu's jitted DB loss and gradient, compiled once (batch of 3)."""
    def f(params, batch):
        return jdb_loss({"params": params, "batch_stats": {}}, batch, **_DB_KW)
    return jax.jit(jax.value_and_grad(f, has_aux=True))


@pytest.fixture(scope="module")
def craft_grad():
    def f(params, batch):
        return jcraft_loss({"params": params, "batch_stats": {}}, batch)
    return jax.jit(jax.value_and_grad(f, has_aux=True))


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_db_loss_and_gradients_match_kiri_tpu(dataset, db_grad):
    var = init_db_net(jax.random.PRNGKey(0))
    batch = D.load_detector_batches(str(dataset), "db", 3)[0]
    for b, grads in ((batch, False), (_noisy(batch), True)):
        (jl, (_, jm)), jg = db_grad(var["params"], _jnp(b))
        net = DBNet()
        net.load_state_dict(state_dict_from_jax(flatten_params(var)))
        loss, m = db_loss(net, {k: torch.from_numpy(v)
                                for k, v in b.items()}, **_DB_KW)
        for k in m:
            assert abs(float(m[k]) - float(jm[k])) <= \
                TOL_LOSS * abs(float(jm[k])), k
        if grads:
            loss.backward()
            _grads_close(net, state_dict_from_jax(flatten_params(
                {"params": jg})))


def test_craft_loss_and_gradients_match_kiri_tpu(dataset, craft_grad):
    var = init_craft_net(jax.random.PRNGKey(0))
    batch = _noisy(D.load_detector_batches(str(dataset), "craft", 3)[0])
    (jl, _), jg = craft_grad(var["params"], _jnp(batch))
    net = CRAFTNet()
    net.load_state_dict(state_dict_from_flat(flatten_params(var)))
    loss, _ = craft_loss(net, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert abs(float(loss) - float(jl)) <= TOL_LOSS * abs(float(jl))
    loss.backward()
    _grads_close(net, state_dict_from_flat(flatten_params({"params": jg})))


def _same_weights(net, sd):
    """``net``'s weights equal the state dict ``sd`` read back from its
    checkpoint through kiri_tpu's loader."""
    mine = net.state_dict()
    assert set(sd) == set(mine)
    for k, v in mine.items():
        assert torch.equal(v, torch.as_tensor(np.asarray(sd[k]))), k


def _jax_steps(params, batch, steps, grad_fn, opt):
    """kiri_tpu's detector step (loss and gradient, then its optax chain)
    ``steps`` times on one batch; the per-step losses."""
    @jax.jit
    def update(g, state, params):
        upd, state = opt.update(g, state, params)
        return optax.apply_updates(params, upd), state

    state, losses = opt.init(params), []
    for _ in range(steps):
        (loss, _), g = grad_fn(params, batch)
        params, state = update(g, state, params)
        losses.append(float(loss))
    return params, losses


def test_train_db_tracks_kiri_tpu(dataset, db_grad, tmp_path):
    """A few steps of train_db against kiri_tpu's train_db chain (clip at
    5, AdamW under the cosine decay), one batch of the three pages."""
    steps, lr = 3, 1e-3
    var = init_db_net(jax.random.PRNGKey(0))
    net = DBNet()
    net.load_state_dict(state_dict_from_jax(flatten_params(var)))
    opt = optax.chain(optax.clip_by_global_norm(JDBConfig().grad_clip),
                      optax.adamw(optax.cosine_decay_schedule(
                          lr, steps, alpha=0.05), weight_decay=1e-4))
    batch = D.load_detector_batches(str(dataset), "db", 3)[0]
    _, want = _jax_steps(var["params"], _jnp(batch), steps, db_grad, opt)
    hist = []
    tc = DBTrainConfig(steps=steps, batch_size=3, lr=lr,
                       data_dir=str(dataset), out_dir=str(tmp_path))
    train_db(tc, verbose=False, net=net, device="cpu", history=hist)
    got = [h["loss"] for h in hist]
    assert np.allclose(got, want, rtol=TOL_STEPS, atol=0), (got, want)
    # The saved file loads in kiri_tpu (the same weights) and in the port's
    # detector.
    saved = tmp_path / "detector.safetensors"
    _same_weights(net, state_dict_from_jax(flatten_params(jload_db(saved))))
    page = (batch["image"][0, ..., 0] * 127.5 + 127.5).astype(np.uint8)
    assert isinstance(TextDetector("db", str(saved), device="cpu")
                      .detect_lines(page), list)


def test_train_craft_tracks_kiri_tpu(dataset, craft_grad, tmp_path):
    """A few steps of train_craft against kiri_tpu's (clip at 5, Adam)."""
    steps, lr = 3, 1e-3
    var = init_craft_net(jax.random.PRNGKey(0))
    net = CRAFTNet()
    net.load_state_dict(state_dict_from_flat(flatten_params(var)))
    opt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(lr))
    batch = D.load_detector_batches(str(dataset), "craft", 3)[0]
    _, want = _jax_steps(var["params"], _jnp(batch), steps, craft_grad, opt)
    hist = []
    tc = CRAFTTrainConfig(steps=steps, batch_size=3, lr=lr,
                          data_dir=str(dataset), out_dir=str(tmp_path))
    train_craft(tc, verbose=False, net=net, device="cpu", history=hist)
    got = [h["loss"] for h in hist]
    assert np.allclose(got, want, rtol=TOL_STEPS, atol=0), (got, want)
    for name in ("last", "best"):
        saved = tmp_path / f"{name}.safetensors"
        _same_weights(net, state_dict_from_flat(flatten_params(
            jload_craft(saved))))
    page = (batch["image"][0, ..., 0] * 127.5 + 127.5).astype(np.uint8)
    assert isinstance(TextDetector("craft", str(tmp_path / "last.safetensors"),
                                   device="cpu").detect_lines(page), list)


def test_live_generator_is_refused(tmp_path, db_grad, craft_grad):
    """The live document generator is no longer refused: train_db and
    train_craft without a data_dir pre-generate a pool as kiri_tpu's
    trainers do (conditions, and CRAFT's small-scale documents), draw the
    first batch from it by the same seed: step 0's loss is the port's loss
    on kiri_tpu's batch exactly, and kiri_tpu's within TOL_STEPS, the bound
    of the trainers' histories above. (CRAFT's pages are 224 px: at 160 the
    small-scale documents are too small for the sparse layout's margins.)"""
    from kiri_tpu.detect.craft.train import make_batch as jcraft_batch
    from kiri_tpu.detect.db.train import make_batch as jdb_batch

    seed, bs, n = 3, 3, 2
    for kind, size in (("db", SIZE), ("craft", 224)):
        jgen = JD.DocumentGenerator(size, size, seed=seed, khmer_ratio=0.3)
        kw = dict(steps=1, batch_size=bs, image_size=size, seed=seed,
                  pool_size=bs * n, aug_conditions=0.5,
                  out_dir=str(tmp_path / kind))
        if kind == "db":
            var = init_db_net(jax.random.PRNGKey(0))
            pool = [jdb_batch(jgen, bs, size, 0.5) for _ in range(n)]
            grad = db_grad
            net = DBNet()
            net.load_state_dict(state_dict_from_jax(flatten_params(var)))
            tc, train = DBTrainConfig(**kw), train_db

            def loss_of(n, b):
                return db_loss(n, b, **_DB_KW)
        else:
            var = init_craft_net(jax.random.PRNGKey(0))
            small = [JD.DocumentGenerator(round(size / f), round(size / f),
                                          seed=seed + 17 * i,
                                          fonts=jgen.fonts, khmer_ratio=0.3)
                     for i, f in enumerate((1.5, 2.0), 1)]
            pool = [jcraft_batch(jgen, bs, size, 0.5, None, 0.5, small)
                    for _ in range(n)]
            grad = craft_grad
            net = CRAFTNet()
            net.load_state_dict(state_dict_from_flat(flatten_params(var)))
            tc, train = CRAFTTrainConfig(**kw, scale_aug=0.5), train_craft
            loss_of = craft_loss
        first = pool[int(np.random.default_rng(seed).integers(n))]
        (jl, _), _ = grad(var["params"], _jnp(first))
        with torch.no_grad():
            mine = float(loss_of(net, {k: torch.from_numpy(v)
                                       for k, v in first.items()})[0])
        hist = []
        train(tc, verbose=False, net=net, device="cpu", history=hist)
        assert len(hist) == 1 and hist[0]["loss"] == mine, (kind, hist, mine)
        assert abs(mine - float(jl)) <= TOL_STEPS * abs(float(jl)), kind


def test_steps_run_without_tf32():
    """The detector trainers' forward and backward run with cuDNN's and
    cuBLAS's TF32 off whatever the global flags say, which come back
    after."""
    from kiri_tpu_torch.detect.db.train import run_steps

    flags = torch.backends.cudnn, torch.backends.cuda.matmul
    before = [f.allow_tf32 for f in flags]
    seen = []
    net = torch.nn.Linear(3, 1)

    def loss_fn(n, batch):
        seen.append([f.allow_tf32 for f in flags])
        loss = n(batch["x"]).square().mean()
        return loss, {"loss": loss}

    try:
        for f in flags:
            f.allow_tf32 = True
        run_steps(net, [{"x": torch.ones(2, 3)}], 2, 0, loss_fn,
                  torch.optim.Adam(net.parameters()), 5.0, None,
                  lambda step, loss: None, 0, False, None)
        assert seen == [[False, False]] * 2
        assert [f.allow_tf32 for f in flags] == [True, True]
    finally:
        for f, on in zip(flags, before):
            f.allow_tf32 = on
