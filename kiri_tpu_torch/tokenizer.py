"""Character tokenizer with dual CTC / decoder id-spaces, a copy of
``kiri_tpu.tokenizer.CharTokenizer`` (host-only, numpy):

* one ``vocab.json`` mapping character -> raw id, re-densified by sorting on
  the stored id; ``<unk>`` is appended if absent;
* CTC id-space:     blank=0, pad=1, char = raw + 2;
* decoder id-space: pad=0, bos=1, eos=2, char = raw + 3;
* ``decode_ctc`` collapses repeats then drops blanks/specials/<unk>;
  ``decode_dec`` drops specials and maps <unk> to "".

With ``cfg.KHMER_VISUAL_ORDER`` the model's tokens are visual-order Khmer:
encoding applies ``to_visual_order`` and every decode its inverse. That
inverse is exact only on canonical cluster order, so ``canonical_text`` gives
the text a label decodes back to; training replaces each label by it once, at
load (a difference from the JAX package, which trains and scores the label
as given).

``build_vocab_from_texts`` writes a vocab of the characters of some texts,
``build_vocab_from_hf_dataset`` of a dataset's text column, and
``build_full_vocab`` of ``full_charset`` (printable ASCII and the Khmer
block) with any further texts.
"""
from __future__ import annotations

import json
import string
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

from .data.khmer_order import to_logical_order, to_visual_order


def _identity(s: str) -> str:
    return s


class CharTokenizer:
    def __init__(self, vocab_path: Union[str, Path], cfg=None):
        unk_token = getattr(cfg, "UNK_TOKEN", "<unk>")
        self.visual_order = bool(getattr(cfg, "KHMER_VISUAL_ORDER", False))
        self._to_visual = to_visual_order if self.visual_order else _identity
        self._to_logical = to_logical_order if self.visual_order else _identity
        with open(vocab_path, "r", encoding="utf-8") as f:
            vocab_raw: Dict[str, int] = json.load(f)
        if unk_token not in vocab_raw:
            vocab_raw[unk_token] = max(vocab_raw.values(), default=-1) + 1

        items = sorted(vocab_raw.items(), key=lambda kv: kv[1])
        self.token_to_id = {tok: i for i, (tok, _) in enumerate(items)}
        self.id_to_token = {i: tok for i, (tok, _) in enumerate(items)}

        self.unk_token = unk_token
        self.unk_id = self.token_to_id[unk_token]
        self.blank_id = 0
        self.pad_id = 1
        self.ctc_offset = 2
        self.vocab_size = len(self.token_to_id)
        self.ctc_classes = self.vocab_size + self.ctc_offset

        self.dec_pad = 0
        self.dec_bos = 1
        self.dec_eos = 2
        self.dec_offset = 3
        self.dec_vocab = self.vocab_size + self.dec_offset

        # CTC and decoder id -> character (specials and <unk> -> "").
        self._ctc_id_to_char = [""] * self.ctc_classes
        self._dec_id_to_char = [""] * self.dec_vocab
        for raw, tok in self.id_to_token.items():
            if tok != self.unk_token:
                self._ctc_id_to_char[raw + self.ctc_offset] = tok
                self._dec_id_to_char[raw + self.dec_offset] = tok

    # ------------------------------------------------------------- decoding
    def decode_ctc(self, ids: Sequence[int]) -> str:
        """Decode CTC ids: collapse repeats, drop blank/pad/<unk>."""
        chars = []
        prev_id = None
        for idx in ids:
            idx = int(idx)
            if idx == prev_id:
                continue
            prev_id = idx
            if self.ctc_offset <= idx < self.ctc_classes:
                chars.append(self._ctc_id_to_char[idx])
        return self._to_logical("".join(chars))

    def decode_ctc_batch(self, ids: np.ndarray,
                         lengths: Optional[np.ndarray] = None) -> List[str]:
        """Vectorized ``decode_ctc`` over the rows of an [N, T] id matrix;
        with ``lengths``, row i's frames from ``lengths[i]`` on are left
        out."""
        ids = np.asarray(ids)
        keep = np.ones(ids.shape, dtype=bool)
        keep[:, 1:] = ids[:, 1:] != ids[:, :-1]
        if lengths is not None:
            keep &= (np.arange(ids.shape[1])[None]
                     < np.asarray(lengths)[:, None])
        keep &= (ids >= self.ctc_offset) & (ids < self.ctc_classes)
        table = np.array(self._ctc_id_to_char, dtype=object)
        return [self._to_logical("".join(table[row[k]]))
                for row, k in zip(ids, keep)]

    def decode_dec_batch(self, ids: np.ndarray,
                         lengths: np.ndarray) -> List[str]:
        """``decode_dec`` of each row of an [N, L] decoder-id matrix up to
        its ``lengths`` entry (eos left out)."""
        ids = np.asarray(ids)
        keep = np.arange(ids.shape[1])[None] < np.asarray(lengths)[:, None]
        keep &= (ids >= self.dec_offset) & (ids < self.dec_vocab)
        table = np.array(self._dec_id_to_char, dtype=object)
        return [self._to_logical("".join(table[row[k]]))
                for row, k in zip(ids, keep)]

    def decode_dec(self, ids: Sequence[int]) -> str:
        out = []
        for x in ids:
            y = int(x) - self.dec_offset
            if 0 <= y < self.vocab_size:
                t = self.id_to_token[y]
                out.append("" if t == self.unk_token else t)
        return self._to_logical("".join(out))

    def dec_to_ctc_id(self, dec_id: int) -> int:
        """A decoder id in the CTC id-space: specials -> blank, a character
        -> its CTC id, anything past the vocab -> <unk>'s."""
        if dec_id in (self.dec_pad, self.dec_bos, self.dec_eos):
            return self.blank_id
        raw_id = dec_id - self.dec_offset
        if 0 <= raw_id < self.vocab_size:
            return raw_id + self.ctc_offset
        return self.unk_id + self.ctc_offset

    def save(self, path: Union[str, Path]) -> None:
        """Write the (re-densified) vocab as ``vocab.json``."""
        Path(path).write_text(json.dumps(dict(self.token_to_id),
                                         ensure_ascii=False, indent=0))

    # ------------------------------------------------------------- encoding
    def canonical_text(self, text: str) -> str:
        """The text that ``text`` decodes back to once encoded: the round
        trip through visual order, the identity without it."""
        return self._to_logical(self._to_visual(text))

    def encode_raw(self, text: str) -> List[int]:
        """Text -> raw char ids (<unk> for unknown characters)."""
        return [self.token_to_id.get(ch, self.unk_id)
                for ch in self._to_visual(text)]

    def encode_ctc(self, text: str) -> List[int]:
        return [i + self.ctc_offset for i in self.encode_raw(text)]

    def encode_dec(self, text: str, add_bos: bool = True,
                   add_eos: bool = True) -> List[int]:
        ids = [i + self.dec_offset for i in self.encode_raw(text)]
        return ([self.dec_bos] if add_bos else []) + ids + (
            [self.dec_eos] if add_eos else [])


def build_vocab_from_texts(texts: Iterable[str], out_path: Union[str, Path],
                           unk_token: str = "<unk>") -> str:
    """Write a vocab of the characters of ``texts`` (newline left out):
    ``unk_token`` gets id 0, the characters 1.. in sorted order."""
    chars = set()
    for t in texts:
        chars.update(t)
    chars.discard("\n")
    vocab = {unk_token: 0}
    for i, ch in enumerate(sorted(chars), start=1):
        vocab[ch] = i
    Path(out_path).write_text(json.dumps(vocab, ensure_ascii=False, indent=0))
    return str(out_path)


def build_vocab_from_hf_dataset(ds, out_path: Union[str, Path],
                                text_col: str = "text") -> str:
    """Vocab of a Hugging Face dataset's ``text_col`` column."""
    return build_vocab_from_texts((row[text_col] for row in ds), out_path)


def full_charset(include_khmer: bool = True) -> str:
    """Every printable ASCII character (digits, letters, punctuation,
    space) and, with ``include_khmer``, the assigned Khmer block without
    the two invisible inherent vowels (U+17B4, U+17B5), the Khmer digits
    and the lunar-date digits."""
    chars = string.digits + string.ascii_letters + string.punctuation + " "
    if include_khmer:
        khmer = [chr(c) for c in range(0x1780, 0x17DE)
                 if c not in (0x17B4, 0x17B5)]
        khmer += [chr(c) for c in range(0x17E0, 0x17EA)]
        khmer += [chr(c) for c in range(0x17F0, 0x17FA)]
        chars += "".join(khmer)
    return chars


def build_full_vocab(out_path: Union[str, Path], include_khmer: bool = True,
                     extra_texts: Iterable[str] = (),
                     unk_token: str = "<unk>") -> str:
    """Vocab of ``full_charset`` and the characters of ``extra_texts``."""
    texts = [full_charset(include_khmer)]
    texts.extend(extra_texts)
    return build_vocab_from_texts(texts, out_path, unk_token)
