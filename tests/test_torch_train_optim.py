"""The port's CTC loss, schedules, clipping + AdamW and ``Trainer.run_step``
against kiri_tpu's (and optax's) on inputs from a numpy seed."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kiri_tpu.ops.ctc import ctc_loss as jctc_loss
from kiri_tpu.train import trainer as JT
from kiri_tpu_torch.detect.db.train import cosine_decay_schedule
from kiri_tpu_torch.ops.ctc import ctc_loss
from kiri_tpu_torch.train import trainer as T

from torch_train import (both, jax_init, port_model, port_state, samples,
                         to_torch)

TOL_CTC = 1e-5
TOL_OPT = 1e-6      # relative, parameters after 5 optimizer steps


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _ctc_case():
    """Rows: a plain label, an empty label, a label padded past its length,
    an infeasible one (15 repeats need 29 frames of 20), a short one."""
    rng = np.random.default_rng(0)
    b, t, c = 5, 20, 9
    logits = rng.normal(0, 2, (b, t, c)).astype(np.float32)
    labels = np.zeros((b, 16), np.int32)
    lens = np.array([3, 0, 5, 15, 2], np.int32)
    labels[0, :3] = [2, 3, 4]
    labels[2, :8] = [5, 5, 6, 2, 3, 7, 7, 7]     # 3 pad values past len 5
    labels[3, :15] = 4
    labels[4, :2] = [8, 2]
    frames = np.array([t, t, t, t, 17], np.int32)
    return logits, frames, labels, lens


def test_ctc_loss_matches_kiri_tpu():
    logits, frames, labels, lens = _ctc_case()
    jl, jg = jax.value_and_grad(jctc_loss)(
        jnp.asarray(logits), jnp.asarray(frames), jnp.asarray(labels),
        jnp.asarray(lens))
    x = torch.from_numpy(logits).requires_grad_()
    loss = ctc_loss(x, torch.from_numpy(frames), torch.from_numpy(labels),
                    torch.from_numpy(lens))
    loss.backward()
    assert abs(float(loss) - float(jl)) <= TOL_CTC * abs(float(jl))
    assert float((x.grad - torch.from_numpy(np.asarray(jg))).abs().max()) \
        <= TOL_CTC
    # The infeasible row and the empty one add nothing and get no gradient.
    assert float(x.grad[1].abs().max()) == 0.0
    assert float(x.grad[3].abs().max()) == 0.0
    only = ctc_loss(torch.from_numpy(logits[3:4]),
                    torch.from_numpy(frames[3:4]),
                    torch.from_numpy(labels[3:4]), torch.from_numpy(lens[3:4]))
    assert float(only) == 0.0


@pytest.mark.parametrize("total,warmup", [(100, 4000), (37, 3), (1000, 50)])
def test_onecycle_schedule_matches_optax(total, warmup):
    tc = JT.TrainConfig(warmup_steps=warmup)
    _, ref = JT.make_optimizer(tc, total)
    ours = T.onecycle_schedule(total, tc.lr, T.warmup_steps(tc, total))
    for step in range(total + 3):
        want = float(ref(step))
        got = float(np.float32(ours(step)))
        # float32 rounding of the rate, against the peak: near the end
        # (1 + cos) cancels and one ulp of cos is a large share of the rate.
        assert abs(got - want) <= 1e-6 * tc.lr, (step, got, want)


def test_cosine_decay_schedule_matches_optax():
    ref = optax.cosine_decay_schedule(2e-3, 50, alpha=0.05)
    ours = cosine_decay_schedule(2e-3, 50, alpha=0.05)
    for step in range(55):
        want = float(ref(step))
        assert abs(ours(step) - want) <= 1e-6 * 2e-3, step


@pytest.mark.parametrize("grad_scale", [30.0, 0.01])
def test_clip_and_adamw_match_optax(grad_scale):
    """5 steps with the global norm above (30) and below (0.01) the clip:
    optax's clip_by_global_norm -> scale_by_adam -> add_decayed_weights ->
    * -lr, against the port's clipping and torch's AdamW. A parameter with
    zero gradients (as lm_head has) decays in both."""
    tc = JT.TrainConfig(lr=1e-2, warmup_steps=1)
    rng = np.random.default_rng(1)
    shapes = {"a": (7, 5), "b": (5,), "lm_head": (3, 4)}
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (np.zeros(s, np.float32) if k == "lm_head" else
                  (rng.normal(0, 1, s) * grad_scale).astype(np.float32))
              for k, s in shapes.items()} for _ in range(5)]
    opt, sched = JT.make_optimizer(tc, 5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    for step, g in enumerate(grads):
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        lr = jnp.float32(float(sched(step)))
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: u * -lr, upd))

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    torch_opt = T.make_optimizer(list(tp.values()), tc, torch.device("cpu"))
    ours = T.onecycle_schedule(5, tc.lr, T.warmup_steps(tc, 5))
    for step, g in enumerate(grads):
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = T.clip_by_global_norm([p.grad for p in tp.values()],
                                     tc.grad_clip)
        assert abs(float(norm) - float(optax.global_norm(g))) <= \
            1e-6 * float(norm)
        for group in torch_opt.param_groups:
            group["lr"] = float(np.float32(ours(step)))
        torch_opt.step()
    for k, p in tp.items():
        ref = np.asarray(jp[k])
        err = float(np.abs(p.detach().numpy() - ref).max())
        assert err <= TOL_OPT * np.abs(ref).max(), (k, err)
    assert not np.array_equal(np.asarray(jp["lm_head"]), params["lm_head"])


@pytest.fixture(scope="module")
def run_step_pair(tmp_path_factory):
    """kiri_tpu's Trainer and the port's from one init, two steps on one
    batch each."""
    jcfg, cfg, jtok, tok = both(tmp_path_factory.mktemp("step"))
    var = jax_init(jcfg, jtok)
    tc = dict(lr=1e-3, warmup_steps=2, log_every=0)
    batch = JT.collate(samples(8), jtok)
    tr = T.Trainer(cfg, tok, T.TrainConfig(**tc), model=port_model(var, cfg),
                   total_steps=10, device="cpu")
    # kiri_tpu's step donates (deletes) the variables it is given.
    jtr = JT.Trainer(jcfg, jtok, JT.TrainConfig(**tc), variables=var,
                     total_steps=10, use_mesh=False)
    jm = [jtr.run_step(batch) for _ in range(2)]
    tm = [tr.run_step(batch) for _ in range(2)]
    return jtr, jm, tr, tm, cfg


def test_run_step_matches_kiri_tpu(run_step_pair):
    jtr, jm, tr, tm, cfg = run_step_pair
    for a, b in zip(tm, jm):
        assert set(a) == set(b)
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-5 * abs(b[k]), (k, a[k], b[k])
    ref = port_state(jtr.variables, cfg)
    lr = tr.tc.lr
    for name, t in tr.model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        r = ref[name]
        # Adam's first steps move each weight by about lr whatever its
        # gradient's size, and where two steps' gradients nearly cancel in
        # the first moment the gradients' rounding (1e-5) is magnified:
        # 1e-3 of lr on top of the weights' own scale for all but a few
        # weights, and 0.1 lr for every weight (measured: at most 0.018 lr),
        # so a weight that moved the wrong way or not at all (an error of
        # about lr) fails.
        tol = 2e-5 * float(r.abs().max()) + 1e-3 * lr
        err = (t - r).abs()
        assert float(err.max()) <= tol + 0.1 * lr, (name, float(err.max()))
        if name.endswith("in_proj_bias"):
            # The key bias's gradient is rounding noise in either package
            # (test_attention_key_bias_gradient_is_rounding), so its third
            # is held by the bound above alone.
            d = r.shape[0] // 3
            err = torch.cat([err[:d], err[2 * d:]])
        bad = int((err > tol).sum())
        assert bad <= max(1, r.numel() // 1000), (name, bad)


def test_attention_key_bias_gradient_is_rounding(tmp_path):
    """The key bias shifts every score of a query alike, which the softmax
    ignores: its gradient is rounding noise next to the query's and value's
    in both packages."""
    jcfg, cfg, jtok, tok = both(tmp_path)
    var = jax_init(jcfg, jtok)
    batch = JT.collate(samples(8), jtok)

    def f(params):
        loss, _ = JT.hybrid_loss(
            {**var, "params": params},
            {k: jnp.asarray(x) for k, x in batch.items()},
            jax.random.PRNGKey(1), cfg=jcfg, dec_pad=jtok.dec_pad,
            ctc_weight=0.5, dec_weight=0.5)
        return loss
    jg = port_state({"params": jax.jit(jax.grad(f))(var["params"]),
                     "batch_stats": var["batch_stats"]}, cfg)
    model = port_model(var, cfg)
    loss, _, _ = T.hybrid_loss(model, to_torch(batch), None, cfg=cfg,
                               dtype=torch.float32, dec_pad=tok.dec_pad,
                               ctc_weight=0.5, dec_weight=0.5)
    loss.backward()
    names = [n for n, _ in model.named_parameters()
             if n.endswith("in_proj_bias")]
    assert len(names) == 3
    for g in ([dict(model.named_parameters())[n].grad for n in names],
              [jg[n] for n in names]):
        for t in g:
            d = t.shape[0] // 3
            key = float(t[d:2 * d].abs().max())
            assert key <= 1e-6 * float(t.abs().max()), key


def test_unreached_lm_head_decays(run_step_pair):
    """lm_head gets zero gradients, so AdamW decays it as optax does."""
    jtr, _, tr, _, cfg = run_step_pair
    ref = port_state(jtr.variables, cfg)["lm_head.weight"]
    assert torch.allclose(tr.model.lm_head.weight.detach(), ref, rtol=0,
                          atol=1e-7)
    assert tr.model.lm_head.weight.grad is not None


def test_multi_device_raises(tmp_path):
    """More than one device is one process per device: without the process
    group of ``parallel.initialize`` the trainer says so."""
    _, cfg, _, tok = both(tmp_path)
    for kw in ({"n_devices": 2}, {"model_parallel": 2}):
        with pytest.raises(RuntimeError, match="parallel.initialize"):
            T.Trainer(cfg, tok, T.TrainConfig(**kw), device="cpu")
