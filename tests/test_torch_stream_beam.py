"""kiri_tpu_torch's beam streaming against kiri_tpu's, both live on the
CPU at float32 over the small random model (the fixtures and checks of
tests/test_torch_stream.py): ``stream_records_batch(..., "beam")`` one-shot
and windowed, ``beam_search(record_history=True)``, and the beam record
maker fed a hand-built visual-order Khmer history.

``token`` is held to the port's rule (what the text adds past its longest
common prefix with the previous text; kiri_tpu takes ``text[len(prev):]``),
every other key to kiri_tpu's, ``confidence`` within 1e-5."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decoder_layers import few_torch_threads  # noqa: F401
from test_torch_stream import (_ids, assert_records_equal,  # noqa: F401
                               check_stream, imgs, khmer_engines, small)

from kiri_tpu.ops import decode as JD
from kiri_tpu_torch.ops import decode as D


@pytest.mark.parametrize("n", [3, 5])
@pytest.mark.parametrize("window", [None, 1, 3, 64])
def test_stream_records_match_kiri_tpu(small, imgs, window, n):
    check_stream(small, imgs, "beam", window, n)


def test_beam_history_matches_kiri_tpu(small, imgs):
    """``record_history`` changes nothing else, and its snapshots are
    kiri_tpu's."""
    jeng, eng = small
    jm, jctc, _, jconf, jest, _ = jeng.encode_batch(imgs)
    e = eng._encode_u8(imgs)
    tl = e.est.clamp(min=0)
    kw = dict(k_beam=3, l_cap=16, eos_id=eng.tok.dec_eos,
              unk_dec_id=eng._ids["unk_dec_id"], bos_id=eng.tok.dec_bos)
    ref = JD.beam_search(jeng.variables, jm, jctc, jnp.asarray(tl.numpy()),
                         jconf, cfg=jeng.cfg, record_history=True, **kw)
    with torch.inference_mode():
        plain = D.beam_search(eng.model, e.memp, e.ctc, tl, e.conf,
                              cfg=eng.cfg, **kw)
        hist = D.beam_search(eng.model, e.memp, e.ctc, tl, e.conf,
                             cfg=eng.cfg, record_history=True, **kw)
    assert plain.hist_tokens is None
    for a, b in zip(plain[:6], hist[:6]):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(hist.hist_steps.numpy(),
                                  np.asarray(ref.hist_steps))
    assert int(hist.hist_steps.max()) > 4
    for field in ("hist_tokens", "hist_len", "hist_finished"):
        np.testing.assert_array_equal(getattr(hist, field).numpy(),
                                      np.asarray(getattr(ref, field)))
    np.testing.assert_allclose(hist.hist_score.numpy(),
                               np.asarray(ref.hist_score), atol=1e-4)


def test_beam_records_of_a_hand_built_history(khmer_engines):
    """The best beam after each step, in visual order: a pre-base vowel that
    arrives before its base reorders the logical text inside its prefix, so
    the two token rules differ there; the other keys are kiri_tpu's."""
    jeng, eng = khmer_engines
    tok = eng.tok
    texts = ["ក", "កេ", "េក", "េកា", "េកាត", "កោ", "កោះ"]
    s, l_buf = len(texts), 12
    toks = np.zeros((2, s, l_buf), np.int32)
    lens = np.zeros((2, s), np.int32)
    for j, t in enumerate(texts):
        ids = [tok.dec_bos] + _ids(tok, t) + ([tok.dec_eos] if j == s - 1
                                               else [])
        toks[0, j, :len(ids)] = ids
        lens[0, j] = len(ids)
    toks[1], lens[1] = toks[0], lens[0]
    scores = -np.linspace(0.1, 3.0, 2 * s, dtype=np.float32).reshape(2, s)
    fins = np.zeros((2, s), bool)
    fins[0, -1] = True
    steps = np.asarray([s, s - 2], np.int32)
    ours = D.DecodeOut(None, None, None, None, None, steps, hist_tokens=toks,
                       hist_len=lens, hist_score=scores, hist_finished=fins)
    ref = JD.DecodeOut(None, None, None, None, None, toks, lens, scores, fins,
                       steps, None)
    got = [list(eng._stream_beam(ours, row)) for row in range(2)]
    want = [list(jeng._stream_beam(ref, row)) for row in range(2)]
    # Row 0 reads "កេាត" then "កោ": kiri_tpu's rule gives "" there, the
    # port's "ោ". Row 1 stops before it.
    assert assert_records_equal(got, want, beam=True, tol=0.0) == 1
    assert [r["token"] for r in got[0]][5:] == ["ោ", "ះ"]
    assert got[0][-1]["finished"] and len(got[1]) == s - 2
