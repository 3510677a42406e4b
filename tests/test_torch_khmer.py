"""Khmer grapheme clusters and cluster CER in kiri_tpu_torch
(``utils/khmer.py``) against kiri_tpu's: the cases of
tests/test_khmer_clusters.py, run through both packages, and both packages
on the smoke lines' ground truth against kiri_tpu's stored answers, equal to
the value stored in ``smoke_models.npz``."""
from __future__ import annotations

import pytest

from kiri_tpu.utils import khmer as J
from kiri_tpu_torch.smoke import load_smoke_lines, load_smoke_models
from kiri_tpu_torch.utils import khmer as K

KA, KHA, COENG = "ក", "ខ", "្"
AA, I, U = "ា", "ិ", "ុ"
E, OO, NIKA = "េ", "ោ", "ំ"


@pytest.mark.parametrize("text,clusters", [
    (KA + KHA, [KA, KHA]),
    (KA + AA + KHA + I, [KA + AA, KHA + I]),
    (KA + COENG + KHA + AA, [KA + COENG + KHA + AA]),
    (KA + COENG + KHA + COENG + KA + U, [KA + COENG + KHA + COENG + KA + U]),
    ("ab 1", ["a", "b", " ", "1"]),
    ("a" + KA + AA + "b", ["a", KA + AA, "b"]),
    (KA + COENG, [KA + COENG]),
    (KA + COENG + " x", [KA + COENG, " ", "x"]),
    (AA + KA, [AA, KA]),
    ("", []),
    ("១២" + KA + I, ["១", "២", KA + I]),
    (E + KA + OO + NIKA + KHA, [E, KA + OO + NIKA, KHA]),
])
def test_grapheme_clusters(text, clusters):
    assert K.grapheme_clusters(text) == J.grapheme_clusters(text) == clusters


@pytest.mark.parametrize("ref,hyp,want", [
    (KA + COENG + KHA + AA, KA + AA, 1.0),
    (KA + COENG + KHA + AA, KA + COENG + KHA + AA, 0.0),
    ("hello", "hallo", 1 / 5),
    ("abc", "abcd", 1 / 3),
    ("", "", 0.0),
    ("", KA, 1.0),
    (KA + AA, "ក" + "ា", 0.0),
])
def test_cluster_cer(ref, hyp, want):
    assert K.cluster_cer(ref, hyp) == J.cluster_cer(ref, hyp) == want


def test_corpus_cluster_cer_pools():
    refs = [KA + AA + " " + KHA, "ab"]
    hyps = [KA + AA + " " + KHA, "ax"]
    assert (K.corpus_cluster_cer(refs, hyps)
            == J.corpus_cluster_cer(refs, hyps) == 1 / 5)


@pytest.mark.parametrize("key", ["batch_texts_f32", "batch_decoder_texts_f32",
                                 "batch_beam_texts_f32", "batch_texts_bf16"])
def test_smoke_lines_both_packages(key):
    d, _ = load_smoke_lines()
    refs = [str(t) for t in d["texts"]]
    hyps = [str(t) for t in d[key]]
    assert K.corpus_cluster_cer(refs, hyps) == J.corpus_cluster_cer(refs,
                                                                    hyps)
    for r, h in zip(refs, hyps):
        assert K.cluster_cer(r, h) == J.cluster_cer(r, h)
        assert K.grapheme_clusters(r) == J.grapheme_clusters(r)
    if key == "batch_texts_f32":
        stored = float(load_smoke_models()["khmer_cluster_cer"])
        assert K.corpus_cluster_cer(refs, hyps) == stored
