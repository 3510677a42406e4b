"""kiri_tpu_torch's CTC-drafted speculative decode and its greedy decode
against kiri_tpu at float32 on the CPU, on the small random model of
tests/test_torch_decoder_layers.py: identical tokens, lengths and
``converged``, scores, confidences and the per-step history within 1e-4."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_decode import (ATOL, _encoded, _same, _t,  # noqa: F401
                               few_torch_threads, small, small_eos)

from kiri_tpu.ops import decode as JD
from kiri_tpu_torch.ops import decode as D


@pytest.mark.parametrize("which", ["small", "small_eos"])
@pytest.mark.parametrize("raw_select,rescore", [
    (False, False), (False, True), (True, False)])
def test_spec_decode_matches_jax(request, which, raw_select, rescore):
    variables, jcfg, jtok, model, cfg, _ = request.getfixturevalue(which)
    memp, ctc, ids, conf, tl, kw = _encoded(variables, jcfg, jtok, 3)
    want = JD.spec_decode(variables, memp, ids, tl,
                          None if raw_select else conf, cfg=jcfg,
                          raw_select=raw_select,
                          ctc_logits=ctc if rescore else None, **kw)
    with torch.inference_mode():
        got = D.spec_decode(model, _t(memp), _t(ids), _t(tl),
                            None if raw_select else _t(conf), cfg=cfg,
                            raw_select=raw_select,
                            ctc_logits=_t(ctc) if rescore else None, **kw)
    _same(got, want, hist=True)
    assert bool(got.converged.all())


def test_spec_decode_equals_the_step_loop(small_eos):
    """Without the rescore the drafted loop gives beam search's K = 1 tokens,
    and with the raw selection greedy decode's and its history."""
    variables, jcfg, jtok, model, cfg, _ = small_eos
    memp, ctc, ids, conf, tl, kw = _encoded(variables, jcfg, jtok, 4)
    with torch.inference_mode():
        args = (model, _t(memp))
        beam = D.beam_search(*args, _t(ctc), _t(tl), _t(conf), cfg=cfg,
                             k_beam=1, **kw)
        spec = D.spec_decode(*args, _t(ids), _t(tl), _t(conf), cfg=cfg, **kw)
        for a, b in ((spec.tokens, beam.tokens), (spec.lengths, beam.lengths)):
            assert torch.equal(a, b)
        np.testing.assert_allclose(spec.final_conf.numpy(),
                                   beam.final_conf.numpy(), atol=ATOL)
        kw.pop("dec_offset")
        greedy = D.greedy_decode(*args, _t(tl), cfg=cfg, **kw)
        raw = D.spec_decode(*args, _t(ids), _t(tl), None, cfg=cfg,
                            raw_select=True, dec_offset=3, **kw)
        assert torch.equal(raw.tokens, greedy.tokens)
        for i, s in enumerate(greedy.hist_steps.tolist()):
            np.testing.assert_allclose(raw.hist_extra[i, :s].numpy(),
                                       greedy.hist_extra[i, :s].numpy(),
                                       atol=ATOL)


def test_spec_decode_empty_perfect_and_cut_drafts(small_eos):
    variables, jcfg, jtok, model, cfg, _ = small_eos
    memp, ctc, ids, conf, tl, kw = _encoded(variables, jcfg, jtok, 5, n=4)
    with torch.inference_mode():
        args = (model, _t(memp))
        beam = D.beam_search(*args, _t(ctc), _t(tl), _t(conf), cfg=cfg,
                             k_beam=1, **kw)
        # No draft at all (None) and an all-blank one: one pass per token.
        for draft in (None, np.zeros_like(ids)):
            got = D.spec_decode(*args, None if draft is None else _t(draft),
                                _t(tl), _t(conf), cfg=cfg, **kw)
            want = JD.spec_decode(variables, memp, draft, tl, conf, cfg=jcfg,
                                  **kw)
            _same(got, want)
            assert torch.equal(got.tokens, beam.tokens)
        # The model's own output as the draft (blanks between, so repeats
        # survive the collapse): accepted whole, still the same tokens.
        fake = np.zeros_like(ids)
        for i, (row, ln) in enumerate(zip(beam.tokens.numpy(),
                                          beam.lengths.numpy())):
            seq = row[1:ln]
            seq = seq[seq != jtok.dec_eos]
            fake[i, 1:2 * len(seq):2] = seq - 1
        got = D.spec_decode(*args, _t(fake), _t(tl), _t(conf), cfg=cfg,
                            max_rounds=2, **kw)
        assert torch.equal(got.tokens, beam.tokens)
        assert bool(got.converged.all())
        # One round only: rows whose draft needed a correction stay open.
        got = D.spec_decode(*args, _t(ids), _t(tl), _t(conf), cfg=cfg,
                            max_rounds=1, ctc_logits=_t(ctc), **kw)
        want = JD.spec_decode(variables, memp, ids, tl, conf, cfg=jcfg,
                              max_rounds=1, ctc_logits=ctc, **kw)
        _same(got, want)
        assert not bool(got.converged.any())


@pytest.mark.parametrize("which", ["small", "small_eos"])
def test_greedy_decode_matches_jax(request, which):
    variables, jcfg, jtok, model, cfg, _ = request.getfixturevalue(which)
    memp, ctc, ids, conf, tl, kw = _encoded(variables, jcfg, jtok, 6)
    kw.pop("dec_offset")
    want = JD.greedy_decode(variables, memp, tl, cfg=jcfg, **kw)
    with torch.inference_mode():
        got = D.greedy_decode(model, _t(memp), _t(tl), cfg=cfg, **kw)
        _same(got, want, hist=True)
        again = D.greedy_decode(model, _t(memp), _t(tl), cfg=cfg,
                                poll_every=0, step_bound=kw["l_cap"], **kw)
    for a, b in zip(got[:7], again[:7]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cut", [None, 5])
def test_greedy_result_does_not_depend_on_polling(small_eos, cut):
    """As ``test_beam_result_does_not_depend_on_polling`` for the greedy
    loop: chunks of 1, 2, 4 and 7 steps, the last one partial, give the
    bits of one chunk, the history too; ``cut`` stops lines still
    running."""
    variables, jcfg, jtok, model, cfg, _ = small_eos
    memp, ctc, ids, conf, tl, kw = _encoded(variables, jcfg, jtok, 2)
    kw.pop("dec_offset")
    bounds = (None, None, kw["l_cap"], None, kw["l_cap"] + 50)
    with torch.inference_mode():
        runs = [D.greedy_decode(model, _t(memp), _t(tl), cfg=cfg,
                                poll_every=p, step_bound=cut or b, **kw)
                for p, b in zip((0, 1, 2, 4, 7), bounds)]
    for other in runs[1:]:
        for a, b in zip(runs[0][:7], other[:7]):
            assert torch.equal(a, b)
    steps = int(runs[0].hist_steps.max())
    assert steps == cut if cut else steps < kw["l_cap"]
