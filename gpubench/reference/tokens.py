"""The reference's vocabulary: ``vocab.json`` (character -> id, ordered by
id, ``<unk>`` appended when absent); CTC ids are blank 0, pad 1, character
id + 2; decoder ids are pad 0, bos 1, eos 2, character id + 3. With visual
order (the v13 checkpoint) the model's tokens are visual-order Khmer and
texts are logical order."""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import List, Sequence

from traffic.khmer_order import to_logical_order, to_visual_order

BLANK, PAD = 0, 1
CTC_OFFSET = 2
BOS, EOS = 1, 2
DEC_OFFSET = 3


class Vocab:
    def __init__(self, path, visual_order: bool, unk: str = "<unk>"):
        raw = json.loads(Path(path).read_text(encoding="utf-8"))
        if unk not in raw:
            raw[unk] = max(raw.values(), default=-1) + 1
        items = sorted(raw.items(), key=lambda kv: kv[1])
        self.chars = [tok for tok, _ in items]
        self.index = {tok: i for i, tok in enumerate(self.chars)}
        self.unk_id = self.index[unk]
        self.size = len(self.chars)
        self.visual = visual_order

    def _logical(self, s: str) -> str:
        return to_logical_order(s) if self.visual else s

    def _char(self, raw: int) -> str:
        return "" if raw == self.unk_id else self.chars[raw]

    def text_of_ctc_path(self, path: Sequence[int]) -> str:
        """Frame ids -> text: repeats collapsed, then blank, pad and <unk>
        dropped."""
        out, prev = [], None
        for i in path:
            i = int(i)
            if i != prev and CTC_OFFSET <= i < CTC_OFFSET + self.size:
                out.append(self._char(i - CTC_OFFSET))
            prev = i
        return self._logical("".join(out))

    def text_of_dec(self, ids: Sequence[int]) -> str:
        return self._logical("".join(
            self._char(int(i) - DEC_OFFSET) for i in ids
            if DEC_OFFSET <= int(i) < DEC_OFFSET + self.size))

    def visual_forms(self, text: str) -> List[str]:
        """Visual-order sequences that read back as ``text``. Model output
        need not be in canonical cluster order, and then
        ``to_visual_order`` is no inverse. Tried: ``to_visual_order`` of the
        whole text, the text as it is, and piecewise (split before each
        space, as a space is a cluster's base): each piece's
        ``to_visual_order`` where that reads back, else the piece as it is.
        Returns those that read back, or the piecewise form."""
        if not self.visual:
            return [text]
        pieces = re.split(r"(?= )", text)
        piecewise = "".join(
            to_visual_order(p) if to_logical_order(to_visual_order(p)) == p
            else p for p in pieces)
        forms: List[str] = []
        for cand in (to_visual_order(text), text, piecewise):
            if cand not in forms and to_logical_order(cand) == text:
                forms.append(cand)
        return forms or [piecewise]

    def ids_of(self, visual: str) -> List[int]:
        """Raw ids of a visual-order sequence (<unk> for unknown
        characters)."""
        return [self.index.get(ch, self.unk_id) for ch in visual]
