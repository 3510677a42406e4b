"""kiri_tpu_torch's streaming against kiri_tpu's, both live on the CPU at
float32 over the small random model of tests/test_torch_decoder_layers.py:
``stream_records_batch`` for "ctc", "decoder" and "auto", one-shot and
windowed, on batches that are no batch bucket; the port's windowed records
against its one-shot ones; the laziness of windows; and the greedy record
maker fed a hand-built history (an ``<unk>`` step, an EOS, a budget that
runs out, a visual-order Khmer cluster). tests/test_torch_stream_beam.py
holds "beam".

Every key must be equal and ``confidence`` within 1e-5, but ``token`` of a
beam record: the port takes what the text adds past its longest common
prefix with the previous text (kiri_tpu: ``text[len(prev):]``), so the
reference's records are held to the port's rule."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
from test_torch_decoder_layers import few_torch_threads, make_small_model  # noqa: F401

from kiri_tpu.config import CFG as JCFG
from kiri_tpu.engine import RecognizerEngine as JEngine
from kiri_tpu.ops import decode as JD
from kiri_tpu.tokenizer import CharTokenizer as JTok
from kiri_tpu_torch.config import CFG
from kiri_tpu_torch.engine import RecognizerEngine
from kiri_tpu_torch.ops import decode as D
from kiri_tpu_torch.tokenizer import CharTokenizer

REPO = Path(__file__).resolve().parent.parent
TOL_CONF = 1e-5


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    variables, jcfg, jtok, model, cfg, tok = make_small_model(
        tmp_path_factory.mktemp("small"), EOS_LOGP_BIAS=6.0,
        EOS_LOGP_BOOST=2.0, EOS_BIAS_UNTIL_LEN=7)
    return (JEngine(variables, jcfg, jtok),
            RecognizerEngine(model, cfg, tok, device="cpu"))


@pytest.fixture(scope="module")
def imgs():
    return np.random.default_rng(9).integers(0, 255, (5, 48, 160),
                                             dtype=np.uint8)


def lcp_tokens(records):
    """A line's beam records with ``token`` under the port's rule."""
    out, prev = [], ""
    for r in records:
        n = 0
        while n < min(len(prev), len(r["text"])) and prev[n] == r["text"][n]:
            n += 1
        out.append(dict(r, token=r["text"][n:]))
        prev = r["text"]
    return out


def assert_records_equal(ours, ref, beam: bool, tol: float = TOL_CONF):
    """Returns how many lines' reference tokens differ under the two
    rules."""
    assert len(ours) == len(ref)
    differ = 0
    for o, r in zip(ours, ref):
        o = list(o)
        if beam:
            differ += lcp_tokens(r) != r
            r = lcp_tokens(r)
        assert len(o) == len(r)
        for a, b in zip(o, r):
            assert set(a) == set(b)
            assert {k: v for k, v in a.items() if k != "confidence"} == {
                k: v for k, v in b.items() if k != "confidence"}
            assert isinstance(a["confidence"], float)
            assert abs(a["confidence"] - b["confidence"]) <= tol
    return differ


@pytest.mark.parametrize("n", [3, 5])
@pytest.mark.parametrize("window", [None, 1, 3, 64])
@pytest.mark.parametrize("method", ["ctc", "decoder", "auto"])
def test_stream_records_match_kiri_tpu(small, imgs, method, window, n):
    check_stream(small, imgs, method, window, n)


def check_stream(small, imgs, method, window, n):
    jeng, eng = small
    ref = [list(r) for r in jeng.stream_records_batch(imgs[:n], method,
                                                      window=window)]
    ours = eng.stream_records_batch(imgs[:n], method, window=window)
    assert len(ours) == n
    assert_records_equal(ours, ref, method == "beam")
    assert all(r[-1]["finished"] for r in ref if method != "beam")


# One-shot "decoder" takes its probabilities from spec_decode's pass over
# whole sequences, the windows from the cached step: float32 rounding apart.
WINDOW_TOL = {"decoder": 1e-6, "beam": 0.0}


@pytest.mark.parametrize("method", ["decoder", "beam"])
def test_windowed_records_equal_the_one_shot_records(small, imgs, method):
    _, eng = small
    one_shot = eng.stream_records_batch(imgs, method)
    for window in (1, 2, 3, 8, 64):
        assert_records_equal(eng.stream_records_batch(imgs, method,
                                                      window=window),
                             one_shot, beam=False, tol=WINDOW_TOL[method])


def test_a_line_streams_after_one_window(small, imgs):
    """Line 0's first record is there after the encode and one window: the
    decode of the other windows waits until someone reads past it."""
    _, eng = small
    gens = eng.stream_records_batch(imgs, "decoder", window=1)
    first = next(iter(gens[0]))
    runner = gens[0].gi_frame.f_locals["self"]
    assert first["step"] == 1 and runner.windows == 1 and not runner.done
    rest = [list(g) for g in gens]
    assert runner.done and runner.windows > 1
    assert_records_equal([[first] + rest[0]], [list(eng.stream_records(
        imgs[0], "decoder"))], beam=False, tol=WINDOW_TOL["decoder"])


def test_stream_records_of_one_line_and_of_none(small, imgs):
    jeng, eng = small
    for method in ("ctc", "decoder", "beam"):
        ours = list(eng.stream_records(imgs[2], method, window=3))
        assert_records_equal([ours], [list(jeng.stream_records(
            imgs[2], method, window=3))], method == "beam")
    assert eng.stream_records_batch(imgs[:0], "beam") == []
    with pytest.raises(ValueError, match="method"):
        eng.stream_records_batch(imgs, "greedy")


# ------------------------------------------------ hand-built histories
@pytest.fixture(scope="module")
def khmer_engines(small):
    """Both engines with the committed checkpoint's tokenizer (visual-order
    Khmer, 207 characters): the record makers read only the tokenizer."""
    jeng, eng = small
    vocab = str(REPO / "models" / "vocab.json")
    jtok = JTok(vocab, JCFG(KHMER_VISUAL_ORDER=True))
    tok = CharTokenizer(vocab, CFG(KHMER_VISUAL_ORDER=True))
    assert tok.visual_order and jtok.visual_order
    return (JEngine(jeng.variables, jeng.cfg, jtok),
            RecognizerEngine(eng.model, eng.cfg, tok, device="cpu"))


def _ids(tok, text):
    return [tok.token_to_id[c] + tok.dec_offset for c in text]


def test_greedy_records_of_a_hand_built_history(khmer_engines):
    """Row 0: a cluster with a pre-base vowel (held back until it closes),
    an <unk> step, EOS. Row 1: the budget runs out on an open cluster (the
    flush record). Row 2: pad, bos and an id past the vocabulary."""
    jeng, eng = khmer_engines
    tok = eng.tok
    unk = tok.unk_id + tok.dec_offset
    visual = tok._to_visual("ក្ខេ ខា")
    rows = [_ids(tok, visual[:4]) + [unk] + _ids(tok, visual[4:])
            + [tok.dec_eos],
            _ids(tok, tok._to_visual("ស្រី ក្រុ")),
            [tok.dec_pad, tok.dec_bos, tok.dec_vocab + 4]
            + _ids(tok, "ab") + [tok.dec_eos]]
    s = max(map(len, rows)) + 2
    extra = np.zeros((3, s, 2), np.float32)
    steps = np.asarray([len(r) for r in rows], np.int32)
    rng = np.random.default_rng(0)
    for i, r in enumerate(rows):
        extra[i, :len(r), 0] = rng.uniform(0.2, 1.0, len(r))
        extra[i, :len(r), 1] = r
    ours = D.DecodeOut(None, None, None, None, None, steps, extra)
    ref = JD.DecodeOut(None, None, None, None, None, None, None, None, None,
                       steps, extra)
    for row in range(3):
        o = list(eng._stream_greedy(ours, row))
        r = list(jeng._stream_greedy(ref, row))
        assert o == r
    recs = list(eng._stream_greedy(ours, 0))
    assert recs[4]["token"] == tok.unk_token
    assert recs[4]["text"] == recs[3]["text"]
    assert recs[-1]["finished"] and recs[-1]["text"] == "ក្ខេ ខា"
    tail = list(eng._stream_greedy(ours, 1))[-1]
    assert tail["token_id"] == -1 and not tail["finished"]
    assert tail["step"] == steps[1] + 1 and tail["text"] == "ស្រី ក្រុ"
