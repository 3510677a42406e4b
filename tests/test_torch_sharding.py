"""The port on more than one device (``kiri_tpu_torch.parallel``): 2 and 4
gloo ranks on the CPU (``parallel.launch.spawn``), held to ``kiri_tpu``'s
single-device train step and engine on the same numpy-seeded inputs and
the same parameters (carried across by ``convert``), as
``tests/test_sharding.py`` holds ``kiri_tpu``'s mesh to its single device.

- train step, data axis 2 and 4 (DP) and model axis 2 (TP, DP 2 x TP 2):
  loss within 1e-4 (DP) / 1e-3 (TP), DP parameters within atol 1e-5, rtol
  1e-4 (``tests/test_sharding.py:73-89``);
- a batch of 7 on 2 and 4 ranks is padded with zero rows, which enter the
  global BatchNorm statistics as in ``kiri_tpu``: equal to its single
  device on the zero-padded batch;
- dropout and decoder-input noise are drawn whole and cut to each rank's
  rows and heads: two steps equal the port's own single-device steps;
- ``RecognizerEngine(mesh=)`` at model axis 1 and 2: "ctc" and "beam" texts
  equal ``kiri_tpu``'s and the single-device port's, confidences within
  1e-4; "decoder", "auto", ``recognize_crops`` (with ``enhance``), the
  streams (one-shot and windowed) and ``encode_batch`` equal the
  single-device port's;
- the DB trainer's data-parallel step equals its single-device step.
"""
from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kiri_tpu.engine import RecognizerEngine as JEngine
from kiri_tpu.train.trainer import TrainConfig as JTC
from kiri_tpu.train.trainer import collate as jcollate
from kiri_tpu.train.trainer import make_optimizer, make_train_step
from kiri_tpu_torch.checkpoints import build_model
from kiri_tpu_torch.engine import RecognizerEngine
from kiri_tpu_torch.parallel.launch import spawn

from torch_train import both, jax_init, port_state, to_numpy

TESTS = str(Path(__file__).resolve().parent)
TOL_DP = 1e-4
TOL_TP = 1e-3
TOL_CONF = 1e-4
TOL_SPREAD = 1e-5   # replicated gradients across the model axis, relative
DROP = dict(DROPOUT=0.2)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _samples(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 255, (48, 160), np.uint8),
             "text": "ab cde"} for _ in range(n)]


def _jax_step(jcfg, jtok, var, batch):
    """kiri_tpu's single-device step (``tests/test_sharding.py``'s
    ``_run_one_step`` with no mesh): (loss, new variables)."""
    tc = JTC(batch_size=8)
    optimizer, sched = make_optimizer(tc, 100)
    opt_state = optimizer.init(var["params"])
    step = make_train_step(jcfg, jtok, optimizer, tc, None)
    new, _, metrics = step(var, opt_state, {k: jnp.asarray(v) for k, v
                                            in batch.items()},
                           jax.random.PRNGKey(42), jnp.float32(sched(0)))
    return float(metrics["loss"]), jax.device_get(new)


def _db_case():
    from kiri_tpu_torch.detect.db.net import DBNet

    rng = np.random.default_rng(4)
    b, s = 4, 64
    prob = np.zeros((b, s, s), np.float32)
    for i in range(b):
        y, x = rng.integers(4, 40, 2)
        prob[i, y: y + 12, x: x + 20] = 1.0
    batch = {"image": rng.uniform(-1, 1, (b, s, s, 1)).astype(np.float32),
             "prob_gt": prob,
             "thresh_gt": rng.uniform(0.3, 0.7, (b, s, s)).astype(np.float32),
             "tmask": (rng.random((b, s, s)) < 0.2).astype(np.float32)}
    net = DBNet().init_weights(torch.Generator().manual_seed(2))
    return {"state": {k: v.numpy() for k, v in net.state_dict().items()},
            "batch": batch, "steps": 2}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharding")
    jcfg, cfg, jtok, tok = both(tmp)
    var = jax_init(jcfg, jtok)
    state = {k: v.numpy() for k, v in port_state(var, cfg).items()}
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 255, (6, 48, 160), np.uint8)
    widths = np.asarray([60, 160, 100, 160, 40, 90], np.int32)
    crops = [rng.integers(0, 255, (h, w), np.uint8)
             for h, w in ((30, 120), (22, 80), (48, 150), (40, 60))]
    sharpen = np.array([True, False, False, True])
    batch = jcollate(_samples(8), jtok)
    batch7 = jcollate(_samples(7, seed=1), jtok)
    db = _db_case()
    kw = dict(state=state, cfgd={**cfg.to_dict()}, vocab=str(tmp /
                                                             "vocab.json"),
              batch=batch, batch7=batch7,
              drop_cfgd={**cfg.to_dict(), **DROP}, imgs=imgs, widths=widths,
              crops=crops, sharpen=sharpen)
    two = spawn("torch_parallel_ranks:sharding", 2,
                {**kw, "db": db, "meshes": (1, 2)}, paths=[TESTS],
                threads=1, timeout=400)
    four = spawn("torch_parallel_ranks:sharding", 4,
                 {**kw, "db": None, "meshes": (1, 2)}, paths=[TESTS],
                 threads=1, timeout=400)
    return dict(jcfg=jcfg, cfg=cfg, jtok=jtok, tok=tok, var=to_numpy(var),
                state=state, imgs=imgs, widths=widths, crops=crops,
                sharpen=sharpen, batch=batch, batch7=batch7, db=db,
                runs={(2, 1): two[0][1], (2, 2): two[0][2], (4, 1): four[0][1],
                      (4, 2): four[0][2]},
                ranks={2: two, 4: four})


RUNS = [(2, 1), (2, 2), (4, 1), (4, 2)]


def _tol(mp):
    return TOL_DP if mp == 1 else TOL_TP


@pytest.mark.parametrize("world,mp", RUNS)
def test_train_step_matches_kiri_tpu(case, world, mp):
    want_loss, want = _jax_step(case["jcfg"], case["jtok"], case["var"],
                                case["batch"])
    (metrics,), got = case["runs"][world, mp]["step"]
    assert abs(metrics["loss"] - want_loss) <= _tol(mp), (metrics, want_loss)
    if mp == 1:
        ref = port_state(want, case["cfg"])
        for k, r in ref.items():
            if k.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(got[k], r.numpy(), atol=1e-5,
                                       rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_tp_replicated_gradients_agree_before_broadcast(case, world):
    """The ranks of a model axis compute the replicated parameters'
    gradients alike up to rounding (the embedding's scatter-add may add in
    another order), so ``sync_gradients``' broadcast from the first rank
    hides no rank whose gradients are wrong."""
    for rank in case["ranks"][world]:
        r = rank[2]
        for m in r["step"][0] + r["step7"][0] + r["drop"][0]:
            assert m["replica_grad_spread"] <= TOL_SPREAD, m


@pytest.mark.parametrize("world,mp", RUNS)
def test_padded_batch_matches_kiri_tpu_on_the_padded_batch(case, world, mp):
    """7 rows on a data axis of 2: one zero row is added, as kiri_tpu's
    ``pad_batch_to_devices`` adds it, and it enters the BatchNorm
    statistics; kiri_tpu's single device on the padded batch agrees."""
    dp = world // mp
    b = case["batch7"]
    rem = (-7) % dp
    padded = {k: np.concatenate([v, np.zeros((rem,) + v.shape[1:], v.dtype)])
              for k, v in b.items()}
    want_loss, want = _jax_step(case["jcfg"], case["jtok"], case["var"],
                                padded)
    (metrics,), got = case["runs"][world, mp]["step7"]
    assert abs(metrics["loss"] - want_loss) <= _tol(mp)
    ref = port_state(want, case["cfg"])
    for name in ("stem.net.1.running_mean", "stem.net.10.running_var"):
        np.testing.assert_allclose(got[name], ref[name].numpy(), atol=1e-5,
                                   rtol=1e-4)


def _single_steps(case, steps=2):
    from kiri_tpu_torch.config import CFG
    from kiri_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = CFG(**{**case["cfg"].to_dict(), **DROP})
    tr = Trainer(cfg, case["tok"], TrainConfig(dec_input_noise=0.2, lr=1e-3,
                                               warmup_steps=2),
                 model=build_model(case["state"], cfg), total_steps=10,
                 device="cpu")
    return [tr.run_step(case["batch"]) for _ in range(steps)], tr.model


@pytest.mark.parametrize("world,mp", RUNS)
def test_dropout_draws_match_one_device(case, world, mp):
    want, model = _single_steps(case)
    metrics, got = case["runs"][world, mp]["drop"]
    for a, b in zip(metrics, want):
        for k in b:
            assert abs(a[k] - b[k]) <= _tol(mp) * max(1.0, abs(b[k])), k
    if mp == 1:
        _close_after_adam(got, {k: v.numpy() for k, v in
                                model.state_dict().items()}, lr=1e-3)


def _close_after_adam(got, want, lr):
    """Two Adam steps move a weight whose gradients nearly cancel by a
    share of lr that magnifies the gradients' rounding (as in
    test_torch_train_optim.py::test_run_step_matches_kiri_tpu): every
    weight within 0.1 lr, all but 1 in 1000 within atol 1e-5, rtol 1e-4."""
    for k, want_k in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        err = np.abs(got[k] - want_k)
        tol = 1e-5 + 1e-4 * np.abs(want_k)
        assert float((err - tol).max()) <= 0.1 * lr, k
        assert int((err > tol).sum()) <= max(1, want_k.size // 1000), k


@pytest.fixture(scope="module")
def single(case):
    """The port's single-device engine and kiri_tpu's on the same
    weights."""
    eng = RecognizerEngine(build_model(case["state"], case["cfg"]),
                           case["cfg"], case["tok"], device="cpu")
    jeng = JEngine(jax_init(case["jcfg"], case["jtok"]), case["jcfg"],
                   case["jtok"])
    return eng, jeng


def _same(got, want, tol=TOL_CONF):
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose([c for _, c in got], [c for _, c in want],
                               atol=tol)


@pytest.mark.parametrize("world,mp", RUNS)
@pytest.mark.parametrize("method", ["ctc", "beam"])
def test_engine_matches_kiri_tpu_and_one_device(case, single, world, mp,
                                                method):
    eng, jeng = single
    got = case["runs"][world, mp][method]
    _same(got, eng.recognize_batch(case["imgs"], method, case["widths"]))
    _same(got, jeng.recognize_batch(case["imgs"], method,
                                    widths=case["widths"]))
    for rank in case["ranks"][world]:      # every rank returns the batch
        assert [t for t, _ in rank[mp][method]] == [t for t, _ in got]


@pytest.mark.parametrize("world,mp", RUNS)
def test_engine_other_methods_match_one_device(case, single, world, mp):
    eng, _ = single
    r = case["runs"][world, mp]
    for m in ("decoder", "auto"):
        _same(r[m], eng.recognize_batch(case["imgs"], m, case["widths"]))
    _same(r["crops"], eng.recognize_crops(case["crops"], "ctc", enhance=True,
                                          sharpen=case["sharpen"]))
    _same(r["crops_decoder"], eng.recognize_crops(case["crops"], "decoder"))


@pytest.mark.parametrize("world,mp", RUNS)
def test_crops_enhance_matches_kiri_tpu(case, single, world, mp):
    _, jeng = single
    want = jeng.recognize_crops(case["crops"], "ctc", enhance=True,
                                sharpen=case["sharpen"])
    _same(case["runs"][world, mp]["crops"], want)


def _same_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [{k: v for k, v in r.items() if k != "confidence"} for r in g] \
            == [{k: v for k, v in r.items() if k != "confidence"} for r in w]
        np.testing.assert_allclose([r["confidence"] for r in g],
                                   [r["confidence"] for r in w],
                                   atol=TOL_CONF)


@pytest.mark.parametrize("world,mp", RUNS)
def test_streams_and_encode_match_one_device(case, single, world, mp):
    eng, _ = single
    r = case["runs"][world, mp]
    for m in ("ctc", "decoder", "beam"):
        _same_records(r[f"stream_{m}"], [list(s) for s in
                                         eng.stream_records_batch(
                                             case["imgs"], m)])
    for m in ("decoder", "beam"):
        _same_records(r[f"stream_{m}_w2"], [list(s) for s in
                                            eng.stream_records_batch(
                                                case["imgs"], m, window=2)])
    memp, ctc, ids, conf, est, n = eng.encode_batch(case["imgs"])
    assert r["encode_n"] == n == 6
    got = r["encode"]
    np.testing.assert_allclose(got[1][:n], ctc[:n].numpy(), atol=1e-4)
    np.testing.assert_array_equal(got[2][:n], ids[:n].numpy())
    np.testing.assert_array_equal(got[4][:n], est[:n].numpy())
    assert got[1].shape[0] % (world // mp) == 0


def test_db_data_parallel_step_matches_one_device(case):
    from torch_parallel_ranks import db_steps

    want_hist, want = db_steps(**case["db"])
    got_hist, got = case["ranks"][2][0]["db"]
    for a, b in zip(got_hist, want_hist):
        for k in b:
            assert abs(a[k] - b[k]) <= 1e-4 * max(1.0, abs(b[k])), (k, a, b)
    _close_after_adam(got, want, lr=2e-3)
