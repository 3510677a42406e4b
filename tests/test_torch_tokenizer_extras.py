"""The tokenizer functions the port added last (kiri_tpu_torch/tokenizer.py:
``dec_to_ctc_id``, ``decode_dec_batch``, ``decode_ctc_batch(lengths=)``,
``save``, ``full_charset``, ``build_full_vocab``,
``build_vocab_from_hf_dataset``) against kiri_tpu's: the same strings and
ids, and the same file bytes."""
from __future__ import annotations

import json
import random
from pathlib import Path

import numpy as np
import pytest

from kiri_tpu import tokenizer as JT
from kiri_tpu.config import CFG as JCFG
from kiri_tpu.data.synth import sample_khmer_text, sample_text
from kiri_tpu_torch import tokenizer as T
from kiri_tpu_torch.config import CFG

REPO = Path(__file__).resolve().parent.parent
VOCAB = REPO / "models" / "vocab.json"


@pytest.fixture(scope="module", params=[False, True], ids=["logical",
                                                           "visual"])
def toks(request):
    kw = dict(KHMER_VISUAL_ORDER=request.param)
    return T.CharTokenizer(VOCAB, CFG(**kw)), JT.CharTokenizer(VOCAB,
                                                               JCFG(**kw))


def _ids(tok, n, width, seed):
    """Id matrices with specials, <unk>, repeats and characters."""
    rng = np.random.default_rng(seed)
    hi = tok.vocab_size + 3
    ids = rng.integers(0, hi, (n, width))
    ids[:, ::3] = rng.integers(0, 3, ids[:, ::3].shape)
    ids[:, 1::7] = ids[:, 0::7][:, : ids[:, 1::7].shape[1]]
    return ids


def test_dec_to_ctc_id(toks):
    ours, ref = toks
    for i in range(-2, ours.dec_vocab + 3):
        assert ours.dec_to_ctc_id(i) == ref.dec_to_ctc_id(i)


def test_decode_dec_batch(toks):
    ours, ref = toks
    ids = _ids(ours, 40, 30, 1)
    ids = np.minimum(ids, ours.dec_vocab - 1)
    ids[3] = ours.unk_id + ours.dec_offset
    lengths = np.random.default_rng(2).integers(0, 31, 40)
    assert ours.decode_dec_batch(ids, lengths) == \
        ref.decode_dec_batch(ids, lengths)
    # Each row as decode_dec of its first lengths[i] ids.
    assert ours.decode_dec_batch(ids, lengths) == [
        ours.decode_dec(r[:n]) for r, n in zip(ids, lengths)]


@pytest.mark.parametrize("with_lengths", [False, True])
def test_decode_ctc_batch_lengths(toks, with_lengths):
    ours, ref = toks
    ids = np.minimum(_ids(ours, 40, 50, 3), ours.ctc_classes - 1)
    lengths = (np.random.default_rng(4).integers(0, 51, 40) if with_lengths
               else None)
    assert ours.decode_ctc_batch(ids, lengths) == \
        ref.decode_ctc_batch(ids, lengths)
    if with_lengths:
        assert ours.decode_ctc_batch(ids, lengths) == [
            ours.decode_ctc(r[:n]) for r, n in zip(ids, lengths)]


def test_save_bytes(toks, tmp_path):
    ours, ref = toks
    ours.save(tmp_path / "a.json")
    ref.save(tmp_path / "b.json")
    assert (tmp_path / "a.json").read_bytes() == \
        (tmp_path / "b.json").read_bytes()
    # A vocab without <unk>, with gaps: saved re-densified, <unk> last.
    (tmp_path / "gaps.json").write_text(json.dumps({"b": 7, "a": 2,
                                                    "ក": 40}))
    T.CharTokenizer(tmp_path / "gaps.json").save(tmp_path / "c.json")
    JT.CharTokenizer(tmp_path / "gaps.json").save(tmp_path / "d.json")
    assert (tmp_path / "c.json").read_bytes() == \
        (tmp_path / "d.json").read_bytes()


@pytest.mark.parametrize("include_khmer", [True, False])
def test_full_vocab_bytes(include_khmer, tmp_path):
    assert T.full_charset(include_khmer) == JT.full_charset(include_khmer)
    rng = random.Random(5)
    texts = [sample_khmer_text(rng, 1, 5) for _ in range(30)] + [
        sample_text(rng, 1, 5) for _ in range(30)] + ["é ß €\n"]
    T.build_full_vocab(tmp_path / "a.json", include_khmer, texts)
    JT.build_full_vocab(tmp_path / "b.json", include_khmer, texts)
    assert (tmp_path / "a.json").read_bytes() == \
        (tmp_path / "b.json").read_bytes()


def test_vocab_from_hf_dataset(tmp_path):
    """A list of rows stands in for the dataset (rows by index, a column by
    name), as kiri_tpu's build_vocab_from_hf_dataset reads it."""
    rows = [{"text": "abc ក", "label": "zz"}, {"text": "ខ!", "label": "y"}]
    for col in ("text", "label"):
        T.build_vocab_from_hf_dataset(rows, tmp_path / "a.json", col)
        JT.build_vocab_from_hf_dataset(rows, tmp_path / "b.json", col)
        assert (tmp_path / "a.json").read_bytes() == \
            (tmp_path / "b.json").read_bytes()
