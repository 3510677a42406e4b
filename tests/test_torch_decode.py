"""kiri_tpu_torch's decode ops (CTC alignment scores, the penalty stack, beam
search) against kiri_tpu at float32 on the CPU. Inputs come from numpy seeds;
beam search runs on the small random model of
tests/test_torch_decoder_layers.py. Tokens and lengths must be identical,
scores and confidences agree within 1e-4. The speculative and the greedy
decode are held in tests/test_torch_spec_decode.py."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decoder_layers import few_torch_threads, make_small_model  # noqa: F401

from kiri_tpu.engine import RecognizerEngine as JEngine
from kiri_tpu.ops import ctc as JC
from kiri_tpu.ops import decode as JD
from kiri_tpu_torch.config import CFG
from kiri_tpu_torch.ops import ctc as C
from kiri_tpu_torch.ops import decode as D

ATOL = 1e-4
CFG_PEN = CFG()
V = 12


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------------ CTC
def _ctc_case(seed, n=6, t=23, c=9, lmax=7):
    rng = np.random.default_rng(seed)
    lp = jax.nn.log_softmax(rng.normal(0, 2, (n, t, c)).astype(np.float32))
    labels = rng.integers(2, c, (n, lmax)).astype(np.int32)
    lens = rng.integers(0, lmax + 1, n).astype(np.int32)
    return np.asarray(lp), labels, lens


@pytest.mark.parametrize("case", ["ragged", "empty", "repeated", "full",
                                  "longer_than_frames"])
def test_ctc_alignment_scores_match_jax(case):
    lp, labels, lens = _ctc_case(3)
    if case == "empty":
        lens[:] = 0
    elif case == "repeated":            # no skip between equal labels
        labels[:, 1::2] = labels[:, 0:-1:2]
        labels[2] = 4
        lens[:] = [7, 6, 7, 2, 1, 4]
    elif case == "full":
        lens[:] = labels.shape[1]
    elif case == "longer_than_frames":  # infeasible: stays finite (NEG_INF)
        lp, labels = lp[:, :5], np.tile(labels[:, :1], (1, 7))
        lens[:] = 7
    want = np.asarray(JC.ctc_alignment_scores(lp, labels, lens))
    got = C.ctc_alignment_scores(_t(lp), _t(labels), _t(lens)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)
    ll = C._ctc_forward_ll(_t(lp), _t(labels), _t(lens), 0).numpy()
    np.testing.assert_allclose(
        ll, np.asarray(JC._ctc_forward_ll(lp, labels, lens, 0)), rtol=1e-5,
        atol=ATOL)


def test_ctc_rows_do_not_interact():
    """Two candidates per line scored in one call, as ``spec_decode`` does."""
    lp, labels, lens = _ctc_case(4)
    lp2, labels2, lens2 = _ctc_case(5)
    both = C.ctc_alignment_scores(
        _t(np.concatenate([lp, lp])), _t(np.concatenate([labels, labels2])),
        _t(np.concatenate([lens, lens2])))
    a = C.ctc_alignment_scores(_t(lp), _t(labels), _t(lens))
    b = C.ctc_alignment_scores(_t(lp), _t(labels2), _t(lens2))
    assert torch.equal(both, torch.cat([a, b]))


# ------------------------------------------------------------ penalties
# Prefixes (after bos = 1) whose last tokens trigger each branch; 0 pads.
PENALTY_ROWS = {
    "none":        [1, 4, 5, 6, 7, 8, 9],
    "aaa":         [1, 4, 5, 6, 7, 7, 7],
    "abab":        [1, 4, 5, 6, 7, 6, 7],       # AB-AB and A-B-A-B (double)
    "aaaa_s1==s2": [1, 4, 5, 7, 7, 7, 7],       # AAA + AB-AB with s1 == s2
    "abcabc":      [1, 9, 8, 7, 9, 8, 7],
    "aaaaaa":      [1, 5, 5, 5, 5, 5, 5],       # every branch, all one token
    "short":       [1, 4, 4, 0, 0, 0, 0],
}


def _penalty_inputs(seed, width=7):
    """The rows of PENALTY_ROWS, continued from their start to ``width``."""
    rng = np.random.default_rng(seed)
    tokens = np.asarray(list(PENALTY_ROWS.values()), np.int32)
    tokens = np.concatenate([tokens, tokens[:, 1:width - 6]], axis=1)
    logp = rng.normal(-3, 1, (len(tokens), tokens.shape[1], V)).astype(
        np.float32)
    tl = np.asarray([0, 3, 9, 4, 0, 2, 6], np.int32)
    return logp, tokens, tl


@pytest.mark.parametrize("eos_bias,counter", [
    pytest.param(False, "host", id="False"),
    pytest.param(True, "host", id="True"),
    pytest.param(False, "device", id="False-device"),
    pytest.param(True, "device", id="True-device")])
def test_apply_penalties_match_jax_and_each_other(eos_bias, counter):
    """The step's stack at each t, the sequence's, and the JAX package's
    agree bit for bit; with the step loops' counter (an int32 scalar
    tensor) each t = 0..9 gives the host integer's bits."""
    cfg = (CFG_PEN.replace(EOS_LOGP_BIAS=1.5, EOS_LOGP_BOOST=2.0,
                           EOS_BIAS_UNTIL_LEN=3) if eos_bias else CFG_PEN)
    logp, tokens, tl = _penalty_inputs(0, 10 if counter == "device" else 7)
    seq = D.apply_penalties_seq(_t(logp), _t(tokens), cfg, _t(tl), 2, 3)
    want_seq = np.asarray(JD.apply_penalties_seq(
        jnp.asarray(logp), jnp.asarray(tokens), cfg, jnp.asarray(tl), 2, 3))
    np.testing.assert_array_equal(seq.numpy(), want_seq)
    for t in range(tokens.shape[1]):
        at = torch.tensor(t, dtype=torch.int32) if counter == "device" else t
        step = D.apply_penalties(_t(logp[:, t]), _t(tokens), at, cfg, _t(tl),
                                 2, 3)
        if counter == "device":
            assert torch.equal(step, D.apply_penalties(
                _t(logp[:, t]), _t(tokens), t, cfg, _t(tl), 2, 3))
        want = np.asarray(JD.apply_penalties(
            jnp.asarray(logp[:, t]), jnp.asarray(tokens), t, cfg,
            jnp.asarray(tl), 2, 3))
        np.testing.assert_array_equal(step.numpy(), want)
        np.testing.assert_array_equal(step.numpy(), seq[:, t].numpy())


def test_penalties_that_name_one_token_twice_both_land():
    """At the last position of 'aaaa' s1 == s2 == 7: AAA (3.0), AB-AB on s1
    and on s2 (2.5 each) and A-B-A-B (2.5) all fall on token 7."""
    logp, tokens, tl = _penalty_inputs(1)
    row, t = list(PENALTY_ROWS).index("aaaa_s1==s2"), tokens.shape[1] - 1
    out = D.apply_penalties(_t(logp[:, t]), _t(tokens), t, CFG_PEN, _t(tl),
                            2, 3).numpy()
    delta = out[row] - logp[row, t]
    np.testing.assert_allclose(delta[7], -(3.0 + 3 * 2.5), atol=1e-5)
    np.testing.assert_allclose(delta[3], -10.0, atol=1e-5)        # <unk>
    assert np.count_nonzero(np.abs(delta) > 1e-6) == 2
    # The input is left as it was.
    inp = _t(logp[:, t])
    D.apply_penalties(inp, _t(tokens), t, CFG_PEN, _t(tl), 2, 3)
    assert torch.equal(inp, _t(logp[:, t]))


# -------------------------------------------------------- small helpers
def test_labels_from_tokens_and_step_budgets_match_jax():
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 10, (9, 14)).astype(np.int32)
    lengths = rng.integers(0, 16, 9).astype(np.int32)
    labels, lens = D._labels_from_tokens(_t(tokens), _t(lengths), 2, 3)
    jl, jn = JD._labels_from_tokens(jnp.asarray(tokens),
                                    jnp.asarray(lengths), 2, 3)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jn))
    tl = np.arange(0, 600, dtype=np.int32)
    for mem_len in (40, 160, 600):
        want = np.asarray(JD.max_decode_steps(CFG_PEN, jnp.asarray(tl),
                                              mem_len))
        np.testing.assert_array_equal(
            D.max_decode_steps(CFG_PEN, _t(tl), mem_len).numpy(), want)
        np.testing.assert_array_equal(
            D.max_decode_steps_host(CFG_PEN, tl, mem_len), want)
    for steps in (1, 32, 33, 500, 9999):
        assert D.pick_l_cap(CFG_PEN, steps) == JD.pick_l_cap(CFG_PEN, steps)
    assert D.pick_l_cap(CFG_PEN, 20, (16, 24)) == 24


def test_top_k_takes_equal_values_by_rising_index():
    x = np.asarray([[1.0, 3.0, 3.0, -1e30, 3.0, -1e30],
                    [-1e30, -1e30, -1e30, 0.5, -1e30, 0.5]], np.float32)
    for k in (1, 2, 3, 5):
        v, i = D._top_k(_t(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


# ------------------------------------------------- beam search, small model
@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return make_small_model(tmp_path_factory.mktemp("small"))


@pytest.fixture(scope="module")
def small_eos(tmp_path_factory):
    """The EOS bias holds the random model's beams open for a few steps (it
    would otherwise end every line at once) and then pushes them to end."""
    return make_small_model(tmp_path_factory.mktemp("small_eos"),
                            EOS_LOGP_BIAS=6.0, EOS_LOGP_BOOST=2.0,
                            EOS_BIAS_UNTIL_LEN=7)


def _encoded(variables, jcfg, jtok, seed, n=6):
    imgs = np.random.default_rng(seed).integers(0, 255, (n, 48, 160),
                                                dtype=np.uint8)
    eng = JEngine(variables, jcfg, jtok)
    memp, ctc, ids, conf, est, _ = eng.encode_batch(imgs)
    est_np = np.asarray(est)
    l_cap = eng._step_cap(est_np, memp.shape[0], memp.shape[1])
    tl = np.where(est_np > 0, est_np, 0).astype(np.int32)
    tl[::3] = 0           # some rows without a length estimate
    kw = dict(l_cap=l_cap, eos_id=jtok.dec_eos,
              unk_dec_id=jtok.unk_id + jtok.dec_offset,
              dec_offset=jtok.dec_offset, bos_id=jtok.dec_bos)
    return tuple(np.asarray(a) for a in (memp, ctc, ids, conf)) + (tl, kw)


def _same(got: D.DecodeOut, want, hist: bool = False):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    np.testing.assert_array_equal(got.hist_steps.numpy(),
                                  np.asarray(want.hist_steps))
    for name in ("dec_conf", "final_conf", "ctc_conf"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), atol=ATOL)
    if want.converged is not None:
        np.testing.assert_array_equal(got.converged.numpy(),
                                      np.asarray(want.converged))
    if hist:
        np.testing.assert_allclose(got.hist_extra.numpy(),
                                   np.asarray(want.hist_extra), atol=ATOL)


@pytest.mark.parametrize("which,k_beam,seed", [
    ("small", 1, 0), ("small", 3, 0), ("small_eos", 1, 0),
    ("small_eos", 3, 0), ("small_eos", 3, 1)])
def test_beam_search_matches_jax(request, which, k_beam, seed):
    variables, jcfg, jtok, model, cfg, _ = request.getfixturevalue(which)
    memp, ctc, ids, conf, tl, kw = _encoded(variables, jcfg, jtok, seed)
    want = JD.beam_search(variables, memp, ctc, tl, conf, cfg=jcfg,
                          k_beam=k_beam, **kw)
    with torch.inference_mode():
        got = D.beam_search(model, _t(memp), _t(ctc), _t(tl), _t(conf),
                            cfg=cfg, k_beam=k_beam, **kw)
        _same(got, want)
        if which == "small_eos":
            assert int(got.lengths.max()) > 4     # the beams did run
        if (which, k_beam, seed) != ("small_eos", 3, 0):
            return
        # Without CTC logits: no fusion, the decoder's confidence alone.
        want = JD.beam_search(variables, memp, None, tl, conf, cfg=jcfg,
                              k_beam=k_beam, **kw)
        _same(D.beam_search(model, _t(memp), None, _t(tl), _t(conf), cfg=cfg,
                            k_beam=k_beam, **kw), want)


@pytest.mark.parametrize("k_beam,cut", [
    pytest.param(1, None, id="1"), pytest.param(3, None, id="3"),
    pytest.param(1, 5, id="1-cut"), pytest.param(3, 5, id="3-cut")])
def test_beam_result_does_not_depend_on_polling(small_eos, k_beam, cut):
    """Finished lines are frozen, so neither how often the host looks at
    ``finished`` nor a larger step bound changes a bit of the result. With
    a step bound ``cut`` that stops lines still running, chunks of 2, 4 and
    7 steps run past it (the last chunk partial) and give what one chunk
    of ``cut`` steps gives."""
    variables, jcfg, jtok, model, cfg, _ = small_eos
    memp, ctc, ids, conf, tl, kw = _encoded(variables, jcfg, jtok, 2)
    polls = (((0, None), (1, None), (4, None), (7, kw["l_cap"]),
              (0, kw["l_cap"] + 50)) if cut is None else
             ((0, cut), (1, cut), (2, cut), (4, cut), (7, cut)))
    with torch.inference_mode():
        runs = [D.beam_search(model, _t(memp), _t(ctc), _t(tl), _t(conf),
                              cfg=cfg, k_beam=k_beam, poll_every=p,
                              step_bound=b, **kw)
                for p, b in polls]
    for other in runs[1:]:
        for a, b in zip(runs[0][:6], other[:6]):
            assert torch.equal(a, b)
    if cut is None:
        assert int(runs[0].hist_steps.max()) < kw["l_cap"]  # ended early
    else:
        assert int(runs[0].hist_steps.max()) == cut         # cut short
