# Frozen copy of kiri_tpu_torch/data/khmer_order.py at commit
# 0bc739aac3bff3542a3b3238ea9226e557ccfdbd, for the benchmark's traffic and
# reference; later changes to the program do not reach it.
"""Logical <-> visual codepoint reordering for Khmer pre-base vowels.

A copy of ``kiri_tpu/data/khmer_order.py`` together with the Khmer block
classification it takes from ``kiri_tpu/data/pseudofont.py`` (importing
either module there would load the JAX package).

Khmer stores text in logical order (base consonant, then dependent vowel),
but fonts draw the vowels E/AE/AI and the left part of the two-part vowels
before the base glyph. Checkpoints trained with ``KHMER_VISUAL_ORDER`` emit
CTC labels in that visual order; the tokenizer maps them back:

    to_visual_order(label)   — move each pre-base vowel to the front of its
                               orthographic cluster (before base + coengs).
    to_logical_order(hyp)    — exact inverse on well-formed text.

Both are the identity on text with no pre-base vowels. As in the JAX
package, visual -> logical round-trips only canonical cluster order.
``IncrementalLogical`` reorders a stream of visual-order characters as they
arrive (streaming decodes), holding back a cluster until it closes.
"""
from __future__ import annotations

_INVISIBLE = {0x17B4, 0x17B5}
_RIGHT_MARKS = {0x17B6, 0x17C7, 0x17C8}
_ABOVE_MARKS = ({0x17B7, 0x17B8, 0x17B9, 0x17BA, 0x17C6}
                | set(range(0x17C9, 0x17D2)) | {0x17D3, 0x17DD})
_BELOW_MARKS = {0x17BB, 0x17BC, 0x17BD, 0x17D2}
_TWO_PART = set(range(0x17BE, 0x17C6))
_COENG = 0x17D2
_PREBASE_FULL = {0x17C1, 0x17C2, 0x17C3}                    # e, ae, ai
_PREBASE_SPLIT = {0x17BE, 0x17BF, 0x17C0, 0x17C4, 0x17C5}   # oe ya ie o au
# Marks that extend a cluster (dependent vowels, signs, the invisible
# combiners); COENG is handled explicitly.
_CLUSTER_EXTEND = set(range(0x17B4, 0x17D2)) | {0x17D3, 0x17DD}
_PREBASE = _PREBASE_FULL | _PREBASE_SPLIT


def _khmer_class(cp: int) -> str:
    """'base' | 'above' | 'below' | 'right' | 'skip' for Khmer codepoints,
    'base' for everything else printable."""
    if cp in _INVISIBLE:
        return "skip"
    if cp in _ABOVE_MARKS:
        return "above"
    if cp in _BELOW_MARKS:
        return "below"
    if cp in _RIGHT_MARKS or cp in _TWO_PART:
        return "right"
    return "base"


def _is_base(ch: str) -> bool:
    return _khmer_class(ord(ch)) == "base"


def _cluster_end(text: str, i: int, visual: bool = False) -> int:
    """End index (exclusive) of the orthographic cluster whose base starts
    at ``i``. In VISUAL-order text a pre-base vowel never extends a cluster:
    one that follows a base belongs to the next cluster."""
    n = len(text)
    j = i + 1
    while j < n:
        cpj = ord(text[j])
        if visual and cpj in _PREBASE:
            break
        if cpj == _COENG and j + 1 < n and _is_base(text[j + 1]):
            j += 2
        elif cpj == _COENG or cpj in _CLUSTER_EXTEND:
            j += 1
        else:
            break
    return j


def to_visual_order(text: str) -> str:
    """Reorder each cluster's pre-base vowels to the cluster front."""
    out = []
    i, n = 0, len(text)
    while i < n:
        if not _is_base(text[i]):
            out.append(text[i])
            i += 1
            continue
        j = _cluster_end(text, i)
        cluster = text[i:j]
        out.extend(c for c in cluster if ord(c) in _PREBASE)
        out.extend(c for c in cluster if ord(c) not in _PREBASE)
        i = j
    return "".join(out)


def to_logical_order(text: str) -> str:
    """Inverse of :func:`to_visual_order` on well-formed visual text.

    A run of pre-base vowels immediately preceding a base consonant moves
    to just after that base and its coeng-subscript pairs. Dangling
    pre-base vowels with no following base stay in place, so the function
    is total on arbitrary model output.
    """
    out = []
    i, n = 0, len(text)
    while i < n:
        if ord(text[i]) in _PREBASE:
            k = i
            while k < n and ord(text[k]) in _PREBASE:
                k += 1
            if k < n and _is_base(text[k]):
                j = _cluster_end(text, k, visual=True)
                cluster = text[k:j]
                p = 1
                while (p + 1 < len(cluster) and ord(cluster[p]) == _COENG
                       and _is_base(cluster[p + 1])):
                    p += 2
                out += [cluster[:p], text[i:k], cluster[p:]]
                i = j
            else:
                out.append(text[i:k])
                i = k
        elif _is_base(text[i]):
            j = _cluster_end(text, i, visual=True)
            out.append(text[i:j])
            i = j
        else:
            out.append(text[i])
            i += 1
    return "".join(out)


def stable_visual_prefix(text: str) -> int:
    """Length of the visual-order prefix whose logical transform can no
    longer change as more characters arrive.

    The last visual unit (a run of pre-base vowels with the cluster after
    it, which may still grow, or a lone character) is held back: a later
    mark or coeng pair could extend it, and a held pre-base vowel's logical
    place moves as coeng pairs arrive. Everything before it is final,
    because ``to_logical_order`` treats units one by one.
    """
    i, n = 0, len(text)
    last_start = 0
    while i < n:
        start = i
        while i < n and ord(text[i]) in _PREBASE:
            i += 1
        if i < n and _is_base(text[i]):
            i = _cluster_end(text, i, visual=True)
        elif i == start:
            i += 1
        last_start = start
    return last_start


class IncrementalLogical:
    """Visual -> logical reordering of a stream that only ever appends.

    ``push`` takes visual-order characters and returns the logical
    characters that became final ("" while a cluster is open, several once
    it closes); ``flush`` returns the rest at the end of the stream.
    ``emitted`` is always ``to_logical_order(everything pushed)[:
    len(emitted)]``.
    """

    def __init__(self) -> None:
        self._raw = ""
        # Characters of _raw already emitted: the transform is a
        # permutation, so logical and visual lengths agree.
        self._stable = 0

    @property
    def emitted(self) -> str:
        return to_logical_order(self._raw[: self._stable])

    def push(self, chars: str) -> str:
        self._raw += chars
        j = stable_visual_prefix(self._raw)
        if j <= self._stable:
            return ""
        out = to_logical_order(self._raw[: j])[self._stable:]
        self._stable = j
        return out

    def flush(self) -> str:
        out = to_logical_order(self._raw)[self._stable:]
        self._stable = len(self._raw)
        return out
