"""kiri_tpu_torch's streaming visual -> logical reordering
(``stable_visual_prefix``, ``IncrementalLogical``) against kiri_tpu's, on
seeded random Khmer and mixed strings pushed in random pieces. Equality is
exact."""
from __future__ import annotations

import random

import pytest

from kiri_tpu.data import khmer_order as JK
from kiri_tpu_torch.data import khmer_order as K

# Bases, coeng, pre-base vowels (full and split), marks above, below and to
# the right, the invisible signs, digits, Latin and a space.
ALPHABET = ([chr(c) for c in range(0x1780, 0x17A3)]
            + ["្"] * 6
            + [chr(c) for c in (0x17c1, 0x17c2, 0x17c3, 0x17be, 0x17bf,
                                0x17c0, 0x17c4, 0x17c5)] * 3
            + [chr(c) for c in range(0x17b6, 0x17be)]
            + [chr(c) for c in (0x17c6, 0x17c7, 0x17c8, 0x17c9, 0x17cb,
                                0x17b4, 0x17b5, 0x17dd, 0x17d3)]
            + list("0123abcXY ."))


def _strings(seed: int, n: int):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        if i % 3 == 0:      # well-formed Khmer in visual order
            logical = "".join(rng.choice(ALPHABET[:35]) + rng.choice(
                ["", "េ", "ោ", "្" + rng.choice(ALPHABET[:35]),
                 "ា", "ំ"]) for _ in range(rng.randint(1, 8)))
            out.append(JK.to_visual_order(logical))
        else:               # anything, malformed model output included
            out.append("".join(rng.choice(ALPHABET)
                               for _ in range(rng.randint(0, 24))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stable_visual_prefix_matches_kiri_tpu(seed):
    for s in _strings(seed, 300):
        for j in range(len(s) + 1):
            assert K.stable_visual_prefix(s[:j]) == JK.stable_visual_prefix(
                s[:j]), repr(s[:j])


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_incremental_logical_matches_kiri_tpu(seed):
    rng = random.Random(seed)
    for s in _strings(seed, 300):
        ours, ref = K.IncrementalLogical(), JK.IncrementalLogical()
        i = 0
        while i < len(s):
            piece = s[i: i + rng.randint(1, 3)]
            i += len(piece)
            assert ours.push(piece) == ref.push(piece)
            assert ours.emitted == ref.emitted
            assert ref.emitted == JK.to_logical_order(s[:i])[
                : len(ref.emitted)]
        assert ours.flush() == ref.flush()
        assert ours.emitted == ref.emitted == JK.to_logical_order(s)
