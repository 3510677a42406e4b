"""kiri_tpu_torch's CFG, Khmer reordering and tokenizer against kiri_tpu's."""
from __future__ import annotations

import dataclasses
import json
import random
from pathlib import Path

import numpy as np
import pytest

from kiri_tpu.config import CFG as JCFG
from kiri_tpu.data import khmer_order as JK
from kiri_tpu.data.synth import sample_khmer_text, sample_text
from kiri_tpu.tokenizer import CharTokenizer as JTok
from kiri_tpu_torch.config import CFG
from kiri_tpu_torch.data import khmer_order as K
from kiri_tpu_torch.tokenizer import CharTokenizer

REPO = Path(__file__).resolve().parent.parent
META = json.loads((REPO / "models" / "model_meta.json").read_text())
VOCAB = REPO / "models" / "vocab.json"


def test_cfg_from_meta_matches_kiri_tpu():
    ours, ref = CFG.from_dict(META["config"]), JCFG.from_dict(META["config"])
    assert [f.name for f in dataclasses.fields(CFG)] == \
        [f.name for f in dataclasses.fields(JCFG)]
    assert ours.to_dict() == ref.to_dict() | {
        "BEAM_STEP_BUCKETS": list(ref.BEAM_STEP_BUCKETS)}
    assert hash(ours) == hash(CFG.from_dict(ours.to_dict()))


def test_cfg_beam_step_buckets_list_stays_hashable(tmp_path):
    """Recorded difference: kiri_tpu's from_dict keeps a BEAM_STEP_BUCKETS
    list as a list, which leaves its frozen CFG unhashable; the port turns
    every tuple field back into a tuple."""
    data = dict(META["config"], BEAM_STEP_BUCKETS=[16, 32, 64])
    with pytest.raises(TypeError):
        hash(JCFG.from_dict(data))
    cfg = CFG.from_dict(data)
    assert cfg.BEAM_STEP_BUCKETS == (16, 32, 64)
    cfg.save_json(tmp_path / "cfg.json")
    back = CFG.load_json(tmp_path / "cfg.json")
    assert back == cfg and hash(back) == hash(cfg)


def _strings():
    rng = random.Random(7)
    out = [sample_khmer_text(rng, 1, 6) for _ in range(60)]
    out += [sample_text(rng, 1, 8) for _ in range(30)]
    # Arbitrary codepoint soup, including malformed Khmer order.
    pool = [chr(c) for c in range(0x1780, 0x17DE)] + list("ab 1.")
    out += ["".join(rng.choice(pool) for _ in range(rng.randint(1, 20)))
            for _ in range(60)]
    return out


@pytest.mark.parametrize("fn", ["to_visual_order", "to_logical_order"])
def test_khmer_order_matches_kiri_tpu(fn):
    for s in _strings():
        assert getattr(K, fn)(s) == getattr(JK, fn)(s), repr(s)


def test_khmer_order_round_trip_on_sampled_lines():
    rng = random.Random(3)
    for _ in range(100):
        t = sample_khmer_text(rng, 1, 6)
        assert K.to_logical_order(K.to_visual_order(t)) == t


@pytest.mark.parametrize("visual", [True, False])
def test_tokenizer_matches_kiri_tpu(visual):
    cfg = CFG(KHMER_VISUAL_ORDER=visual)
    ours, ref = CharTokenizer(VOCAB, cfg), JTok(VOCAB, JCFG(
        KHMER_VISUAL_ORDER=visual))
    for attr in ("vocab_size", "ctc_classes", "dec_vocab", "unk_id",
                 "token_to_id"):
        assert getattr(ours, attr) == getattr(ref, attr)
    for s in _strings():
        assert ours.encode_raw(s) == ref.encode_raw(s)
        assert ours.encode_ctc(s) == ref.encode_ctc(s)
        assert ours.encode_dec(s) == ref.encode_dec(s)
        assert ours.encode_dec(s, False, False) == ref.encode_dec(
            s, False, False)
        assert ours.decode_ctc(ours.encode_ctc(s)) == ref.decode_ctc(
            ref.encode_ctc(s))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, ours.ctc_classes, (40, 60))
    ids[:, ::3] = ids[:, 1::3]                    # repeats to collapse
    assert ours.decode_ctc_batch(ids) == ref.decode_ctc_batch(ids)
    assert ours.decode_ctc_batch(ids) == [ours.decode_ctc(r) for r in ids]
    dec = rng.integers(0, ours.dec_vocab, (40, 30))
    assert [ours.decode_dec(r) for r in dec] == [ref.decode_dec(r)
                                                 for r in dec]
