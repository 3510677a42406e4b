"""Khmer grapheme-cluster segmentation and cluster-level CER (a copy of
``kiri_tpu/utils/khmer.py``, pure Python).

Khmer text is perceived (and shaped) in orthographic clusters: a base
consonant or independent vowel plus its subscript (coeng) consonants,
dependent vowel, and diacritic signs. Codepoint-level CER under-weights
errors that destroy a whole cluster (one dropped coeng corrupts the
visual syllable but costs 1/N codepoints) and over-weights reordering
slips inside a cluster the reader never sees. The reference evaluates
codepoint CER only (reference: benchmark/run_benchmark.py:15-39);
cluster CER is the script-faithful companion metric (VERDICT r3 #6).

Cluster rule (logical-order text, matching Unicode's treatment of Khmer
in UAX #29 extended grapheme clusters, tailored so COENG binds the
following letter into the cluster — UAX #29 does this via
GB9/Extend+Prepend for Khmer's combining marks):

    cluster := base (COENG base | vowel | sign)*

where ``base`` is a consonant (U+1780..17A2) or independent vowel
(U+17A3..17B3), ``vowel``/``sign`` are the dependent marks
U+17B4..17D1, U+17D3, U+17DD, and COENG is U+17D2. Every non-Khmer
codepoint (Latin, digits, spaces, Khmer digits/symbols) is its own
cluster, so cluster CER degenerates to codepoint CER on non-Khmer text.
"""
from __future__ import annotations

import unicodedata
from typing import List, Sequence

_COENG = 0x17D2
_BASE_LO, _BASE_HI = 0x1780, 0x17B3          # consonants + indep vowels
# Dependent vowels + signs that extend a cluster (not COENG itself,
# handled explicitly; not the Khmer digits/symbols 17E0.. which stand
# alone). 17DD (ATTHACAN) behaves as a sign.
_EXTEND = (set(range(0x17B4, 0x17D2)) | {0x17D3, 0x17DD})


def _is_base(cp: int) -> bool:
    return _BASE_LO <= cp <= _BASE_HI


def grapheme_clusters(text: str) -> List[str]:
    """Split ``text`` into Khmer orthographic clusters.

    Non-Khmer codepoints are singleton clusters; a COENG at end-of-text
    or before a non-base char stays attached to the preceding cluster
    (malformed sequences never raise).
    """
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        cp = ord(text[i])
        if not _is_base(cp):
            out.append(text[i])
            i += 1
            continue
        j = i + 1
        while j < n:
            cpj = ord(text[j])
            if cpj == _COENG:
                # COENG + base joins the subscript into this cluster.
                if j + 1 < n and _is_base(ord(text[j + 1])):
                    j += 2
                else:
                    j += 1  # dangling coeng: keep with the cluster
            elif cpj in _EXTEND:
                j += 1
            else:
                break
        out.append(text[i:j])
        i = j
    return out


def _levenshtein(a: Sequence, b: Sequence) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for x, ca in enumerate(a, 1):
        cur = [x]
        for y, cb in enumerate(b, 1):
            cur.append(min(prev[y] + 1, cur[y - 1] + 1,
                           prev[y - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def cluster_cer(ref: str, hyp: str) -> float:
    """Cluster-level CER: Levenshtein over grapheme-cluster sequences,
    normalized by the reference's cluster count. NFC-normalizes both
    sides first, like the reference's codepoint CER
    (reference: benchmark/run_benchmark.py:111-112)."""
    ref_c = grapheme_clusters(unicodedata.normalize("NFC", ref))
    hyp_c = grapheme_clusters(unicodedata.normalize("NFC", hyp))
    if not ref_c:
        return 0.0 if not hyp_c else 1.0
    return _levenshtein(ref_c, hyp_c) / len(ref_c)


def corpus_cluster_cer(refs: Sequence[str], hyps: Sequence[str]) -> float:
    """Pooled cluster CER over a corpus: total edit distance / total
    reference clusters (the aggregation run_benchmark uses for CER)."""
    errs = tot = 0
    for ref, hyp in zip(refs, hyps):
        ref_c = grapheme_clusters(unicodedata.normalize("NFC", ref))
        hyp_c = grapheme_clusters(unicodedata.normalize("NFC", hyp))
        errs += _levenshtein(ref_c, hyp_c)
        tot += len(ref_c)
    return errs / max(1, tot)
