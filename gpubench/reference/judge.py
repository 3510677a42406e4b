"""What decides ``correct``: the served answers held to the plain reference.

* ``char_diff`` (%): the characters by which the served texts differ from
  the float32 reference's reading of the same inputs (Levenshtein edits
  over the sample, over the reference's characters); ``line_diff`` (%):
  the lines whose served text differs. The reference reads a line at its
  width bucket: greedy CTC ("ctc", the fast method), or the
  configuration's accurate rule ("decoder"): beam search with one beam
  over the decoder's log-probabilities fused with the LM head's (x
  ``LM_FUSION_ALPHA``), with the repeat and <unk> penalties, whose
  transcript A competes with the greedy CTC draft B (with eos) by ``score
  / L ** BEAM_LENP + CTC_FUSION_ALPHA * (CTC log-likelihood / label
  count)`` where speculative decoding from the draft reaches A within
  ``SPEC_MAX_ROUNDS`` rounds (elsewhere the step loop gives A). A page's
  lines are the crops of the reference's own boxes, each paired with the
  served row that ``align`` matches to it.
* ``dec_gap`` of an accurate line (``BlockDecoder.gap``): how far the
  served tokens lie below the rule's choice, teacher-forced on the served
  prefix; texts map back to the model's visual-order tokens through
  ``Vocab.visual_forms``, which is not always unique.
* ``det_gap`` and ``box_gap`` of a page (``page_checks``): the served
  boxes against the reference detector's own (``reference/detectors/``;
  DB's in ``reference/boxes.py``), matched in order; the widest over the
  sampled pages.

The same functions read for the control (``read_lines`` on a reference in
float8), so its answers are judged as the program's.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from traffic.preprocess import width_bucket

from .boxes import crop_lines
from .recognizer import RefRecognizer
from .tokens import BLANK, BOS, CTC_OFFSET, DEC_OFFSET, EOS, Vocab

#: The gap given to an answer that never came.
MISSING = 1e6
#: A served box and a reference box pair when their IoU reaches this: the
#: match rule of detection benchmarks (ICDAR, PASCAL VOC).
MATCH_IOU = 0.5


# ---------------------------------------------------------------- encoding
def encode_lines(ref: RefRecognizer, cfg: Dict, imgs: np.ndarray,
                 widths: Sequence[int], block: int = 64) -> List[Dict]:
    """Each line encoded at its width bucket, in blocks of lines of one
    bucket: [{"mem": [T, D], "ctc": [T, C]}] in input order."""
    out: List = [None] * len(imgs)
    groups: Dict[int, List[int]] = {}
    for i, w in enumerate(widths):
        groups.setdefault(width_bucket(cfg, int(w)), []).append(i)
    for bw, idx in sorted(groups.items()):
        for s in range(0, len(idx), block):
            rows = idx[s:s + block]
            x = torch.from_numpy(np.ascontiguousarray(
                imgs[rows][:, :, :bw])).to(ref.dev)
            mem, ctc = ref.encode(x)
            for r, i in enumerate(rows):
                out[i] = {"mem": mem[r], "ctc": ctc[r]}
    return out


# --------------------------------------------------------------------- CTC
def decode_ctc(vocab: Vocab, ctc: torch.Tensor) -> str:
    return vocab.text_of_ctc_path(ctc.argmax(-1).tolist())


def edits(a: str, b: str) -> int:
    """Levenshtein distance of two texts."""
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


# ----------------------------------------------------------------- decoder
def penalty_at(cfg: Dict, tok: List[int], p: int, target_len: int,
               unk_dec: int, row: torch.Tensor) -> None:
    """Add the penalties of position ``p`` of ``tok`` (it predicts token
    p + 1; its prefix ends with tok[p]) to ``row`` [V], in place."""
    n = p + 1
    s = [tok[max(p - k, 0)] for k in range(6)]
    if n >= 4 and s[0] == s[1] == s[2]:
        row[s[0]] -= cfg["REPEAT_LAST_PENALTY"]
    if n >= 4 and s[1] == s[3] and s[0] == s[2]:
        for k in (0, 1, 0):
            row[s[k]] -= cfg["REPEAT_BIGRAM_PENALTY"]
    if n >= 6 and s[2] == s[5] and s[1] == s[4] and s[0] == s[3]:
        for k in (0, 1, 2):
            row[s[k]] -= cfg["REPEAT_TRIGRAM_PENALTY"]
    row[unk_dec] -= cfg["UNK_LOGP_PENALTY"]
    if target_len > 0:
        lo = min(max(int(target_len * 0.5), 1), cfg["EOS_BIAS_UNTIL_LEN"])
        if p < lo:
            row[EOS] -= cfg["EOS_LOGP_BIAS"]
        elif p >= target_len:
            row[EOS] += cfg["EOS_LOGP_BOOST"]
    elif p < cfg["EOS_BIAS_UNTIL_LEN"]:
        row[EOS] -= cfg["EOS_LOGP_BIAS"]


class BlockDecoder:
    """The accurate decode rule over a block of lines of one width bucket
    (one memory length), all lines stepping together."""

    def __init__(self, ref: RefRecognizer, vocab: Vocab, cfg: Dict,
                 encs: Sequence[Dict]):
        self.ref, self.vocab, self.cfg = ref, vocab, cfg
        self.ctc = torch.stack([e["ctc"] for e in encs])
        self.memp = ref.mem_project(torch.stack([e["mem"] for e in encs]))
        self.unk_dec = vocab.unk_id + DEC_OFFSET
        t_mem = self.ctc.shape[1]
        self.drafts, self.target, self.budget = [], [], []
        for ids in self.ctc.argmax(-1).tolist():
            prev, draft = -1, []
            for i in ids:
                if i != prev and i >= CTC_OFFSET:
                    draft.append(i)
                prev = i
            # The CTC length estimate, the draft in decoder ids (<unk>'s
            # frames stay in it, as a CTC id past the blanks) and the step
            # budget, in float32 as the configuration's decoder takes it.
            self.drafts.append([i + 1 for i in draft])
            tl = len(draft)
            self.target.append(tl)
            ratio = np.float32(tl) * np.float32(cfg["DEC_MAX_LEN_RATIO"])
            self.budget.append(
                min(int(ratio) + cfg["DEC_MAX_LEN_PAD"], cfg["MAX_DEC_LEN"])
                if tl > 0 else
                min(int(t_mem * cfg["MEM_MAX_LEN_RATIO"])
                    + cfg["DEC_MAX_LEN_PAD"], cfg["MAX_DEC_LEN"]))

    def fused(self, tokens: torch.Tensor, rows=None) -> torch.Tensor:
        """[B, L, V] fused log-probabilities (float64) at every position of
        ``tokens`` [B, L] (bos first; the block's lines, or its ``rows``),
        penalties not yet added."""
        memp = self.memp if rows is None else self.memp[rows]
        dec, lm = self.ref.decoder_logits(memp, tokens)
        logp = torch.log_softmax(dec.double(), -1)
        if self.cfg["USE_LM"] and self.cfg["USE_LM_FUSION_EVAL"]:
            logp = logp + self.cfg["LM_FUSION_ALPHA"] * torch.log_softmax(
                lm.double(), -1)
        return logp

    def greedy(self) -> List[List[int]]:
        b = len(self.drafts)
        seqs = [[BOS] for _ in range(b)]
        done = [False] * b
        while not all(done):
            toks = torch.tensor(seqs, device=self.ref.dev)
            last = self.fused(toks)[:, -1].cpu()
            for r in range(b):
                if done[r]:
                    seqs[r].append(EOS)
                    continue
                penalty_at(self.cfg, seqs[r], len(seqs[r]) - 1,
                           self.target[r], self.unk_dec, last[r])
                nxt = int(last[r].argmax())
                seqs[r].append(nxt)
                done[r] = nxt == EOS or len(seqs[r]) - 1 >= self.budget[r]
        out = []
        for s in seqs:
            s = s[:s.index(EOS) + 1] if EOS in s else s + [EOS]
            out.append(s)
        return out

    def combined(self, seqs: List[List[int]], rows=None) -> List[float]:
        """Beam's final ranking of each row's ``seqs`` (bos first, eos
        last); the rows are the block's lines, or ``rows``."""
        rows = list(range(len(seqs))) if rows is None else rows
        width = max(len(s) for s in seqs)
        toks = torch.tensor([s + [EOS] * (width - len(s)) for s in seqs],
                            device=self.ref.dev)
        logp = self.fused(toks[:, :-1], rows).cpu()
        lp = torch.log_softmax(self.ctc[rows].double(), -1).cpu()
        out = []
        for j, s in enumerate(seqs):
            r = rows[j]
            score = 0.0
            for p in range(len(s) - 1):
                penalty_at(self.cfg, s, p, self.target[r], self.unk_dec,
                           logp[j, p])
                score += float(logp[j, p, s[p + 1]])
            labels = [x - 1 for x in s[1:] if x >= DEC_OFFSET]
            if labels:
                nll = F.ctc_loss(lp[j][:, None], torch.tensor([labels]),
                                 torch.tensor([lp.shape[1]]),
                                 torch.tensor([len(labels)]), blank=BLANK,
                                 reduction="none", zero_infinity=False)
                align = float(-nll[0]) / len(labels)
            else:
                align = float(lp[j, :, BLANK].mean())
            length = max(len(s) - 1, 1)
            out.append(score / length ** self.cfg["BEAM_LENP"]
                       + self.cfg["CTC_FUSION_ALPHA"] * align)
        return out

    def converges(self, a: List[int], r: int) -> bool:
        """Does speculative decoding reach A within ``SPEC_MAX_ROUNDS``
        rounds from row r's draft? A round accepts the proposal while it
        agrees with A, then writes A's token at the first disagreement;
        the draft's tail stays proposed where it was. Rows that do not
        converge are decoded again by the step loop, where B is not
        considered."""
        prop = [BOS] + self.drafts[r]
        acc, rounds, budget = 1, 0, self.budget[r]
        while rounds < self.cfg["SPEC_MAX_ROUNDS"]:
            if acc - 1 >= budget or a[acc - 1] == EOS:
                return True
            p = acc - 1
            while (p + 1 < len(prop) and p < budget and p + 1 < len(a)
                   and prop[p + 1] == a[p + 1]):
                p += 1
            if p < budget and p + 1 < len(a):
                prop = prop + [0] * (p + 2 - len(prop))
                prop[p + 1] = a[p + 1]
                acc = p + 2
            else:
                acc = p + 1
            rounds += 1
        return acc - 1 >= budget or a[acc - 1] == EOS

    def decide(self) -> List[str]:
        """Each line's answer: A, or the draft B where speculative decoding
        converged and B ranks higher."""
        a = self.greedy()
        b = [[BOS] + d + [EOS] for d in self.drafts]
        comb_a, comb_b = self.combined(a), self.combined(b)
        self.comb_a = comb_a
        self.answers = [self.vocab.text_of_dec(
            sb if d and len(d) <= bud and cb > ca and self.converges(sa, r)
            else sa)
            for r, (sa, sb, ca, cb, d, bud) in enumerate(zip(
                a, b, comb_a, comb_b, self.drafts, self.budget))]
        return self.answers

    def gap(self, r: int, text: str) -> float:
        """How far row r's served ``text`` lies from the rule's choice under
        the reference (after ``decide``): 0 where it is the reference's
        answer; else the smaller of the widest step at which a served token
        lies below the best (its fused, penalised log-probability,
        teacher-forced on the served prefix: the served text as A) and the
        served text's widest CTC frame gap plus the amount by which its
        final score lies below the reference's A (the served text as B)."""
        if text == self.answers[r]:
            return 0.0
        best = MISSING
        lp = torch.log_softmax(self.ctc[r].double(), -1).cpu().numpy()
        for visual in self.vocab.visual_forms(text):
            raw = self.vocab.ids_of(visual)
            if self.vocab.unk_id in raw:
                continue
            served = [BOS] + [i + DEC_OFFSET for i in raw] + [EOS]
            logp = self.fused(torch.tensor([served[:-1]],
                                           device=self.ref.dev), [r])[0].cpu()
            for p in range(len(served) - 1):
                penalty_at(self.cfg, served, p, self.target[r], self.unk_dec,
                           logp[p])
            chosen = logp[torch.arange(len(served) - 1),
                          torch.tensor(served[1:])]
            as_a = float((logp.max(-1).values - chosen).max())
            as_b = (ctc_frame_gap(lp, [i + CTC_OFFSET for i in raw],
                                  self.vocab.unk_id + CTC_OFFSET)
                    + max(0.0, self.comb_a[r]
                          - self.combined([served], [r])[0]))
            best = min(best, as_a, as_b)
        return best


def decode_accurate(ref, vocab, cfg, encs: Sequence[Dict],
                    texts: Optional[Sequence] = None, block: int = 64
                    ) -> Tuple[List[str], List[float]]:
    """The accurate reading of lines, in blocks of one memory length, and,
    given the served ``texts``, each one's ``BlockDecoder.gap``."""
    out: List = [None] * len(encs)
    gaps: List = [0.0] * len(encs)
    groups: Dict[int, List[int]] = {}
    for i, e in enumerate(encs):
        groups.setdefault(e["ctc"].shape[0], []).append(i)
    for idx in groups.values():
        for s in range(0, len(idx), block):
            rows = idx[s:s + block]
            dec = BlockDecoder(ref, vocab, cfg, [encs[i] for i in rows])
            for j, (i, t) in enumerate(zip(rows, dec.decide())):
                out[i] = t
                if texts is not None:
                    gaps[i] = (MISSING if texts[i] is None
                               else dec.gap(j, texts[i]))
    return out, gaps


def ctc_frame_gap(lp: np.ndarray, labels: List[int], unk: int) -> float:
    """The widest gap, over the frames of the best alignment of ``labels``
    (CTC ids; blank, pad and <unk> frames read as nothing), between the
    frame's best log-probability and the aligned label's."""
    t, s = lp.shape[0], 2 * len(labels) + 1
    if len(labels) > t:
        return MISSING
    nothing = np.maximum(np.maximum(lp[:, BLANK], lp[:, 1]), lp[:, unk])
    emit = np.empty((t, s))
    emit[:, 0::2] = nothing[:, None]
    if labels:
        emit[:, 1::2] = lp[:, labels]
    skip = np.zeros(s, bool)
    for k in range(1, len(labels)):
        skip[2 * k + 1] = labels[k] != labels[k - 1]
    neg = -1e30
    alpha = np.full(s, neg)
    alpha[0] = emit[0, 0]
    if s > 1:
        alpha[1] = emit[0, 1]
    back = np.zeros((t, s), np.int64)
    idx = np.arange(s)
    for ti in range(1, t):
        cand = np.stack([alpha, np.r_[neg, alpha[:-1]],
                         np.where(skip, np.r_[neg, neg, alpha[:-2]], neg)])
        step = cand.argmax(0)
        back[ti] = idx - step
        alpha = cand[step, idx] + emit[ti]
    state = s - 1 if s == 1 or alpha[-1] >= alpha[-2] else s - 2
    if alpha[state] <= neg / 2:
        return MISSING
    best = lp.max(-1)
    worst = 0.0
    for ti in range(t - 1, -1, -1):
        worst = max(worst, float(best[ti] - emit[ti, state]))
        state = back[ti, state]
    return worst


def read_lines(ref: RefRecognizer, vocab: Vocab, cfg: Dict, method: str,
               imgs: np.ndarray, widths: Sequence[int],
               texts: Optional[Sequence] = None
               ) -> Tuple[List[str], List[float]]:
    """The reference's reading of each line, and for "decoder", given the
    served ``texts``, each one's gap (``BlockDecoder.gap``; 0 for
    "ctc")."""
    encs = encode_lines(ref, cfg, imgs, widths)
    if method == "ctc":
        return [decode_ctc(vocab, e["ctc"]) for e in encs], [0.0] * len(encs)
    if method == "decoder":
        return decode_accurate(ref, vocab, cfg, encs, texts)
    raise ValueError(f"no reading for method {method!r}")


def text_edits(ref: RefRecognizer, vocab: Vocab, cfg: Dict, method: str,
               imgs: np.ndarray, widths: Sequence[int],
               texts: Sequence) -> Tuple[np.ndarray, List[float]]:
    """([edits of the served texts from the reference's readings, the
    readings' characters, lines whose served text differs, lines], each
    line's gap); a text never served counts all its characters."""
    want, gaps = read_lines(ref, vocab, cfg, method, imgs, widths, texts)
    e = [len(w) if t is None else edits(t, w) for t, w in zip(texts, want)]
    return np.array([sum(e), sum(len(w) for w in want),
                     sum(x > 0 for x in e), len(want)], np.int64), gaps


# ------------------------------------------------------------------- pages
def iou(a, b) -> float:
    """Intersection over union of two boxes (x, y, w, h)."""
    iw = min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0])
    ih = min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1])
    inter = max(iw, 0) * max(ih, 0)
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else 0.0


def align(served: Sequence, mine: Sequence) -> List[Tuple[int, int, float]]:
    """The two box sequences matched in order, as two texts are aligned:
    the most pairs whose IoU is at least ``MATCH_IOU``, then the largest
    sum of IoU. Returns (served index, reference index, IoU)."""
    n, m = len(served), len(mine)
    o = np.array([[iou(a, b) for b in mine] for a in served]).reshape(n, m)
    best = np.zeros((n + 1, m + 1))
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            best[i, j] = max(best[i - 1, j], best[i, j - 1])
            if o[i - 1, j - 1] >= MATCH_IOU:
                best[i, j] = max(best[i, j], best[i - 1, j - 1] + 1000.0
                                 + o[i - 1, j - 1])
    pairs, i, j = [], n, m
    while i and j:
        if best[i, j] == best[i - 1, j]:
            i -= 1
        elif best[i, j] == best[i, j - 1]:
            j -= 1
        else:
            pairs.append((i - 1, j - 1, float(o[i - 1, j - 1])))
            i, j = i - 1, j - 1
    return pairs[::-1]


def page_checks(ref: RefRecognizer, detector, vocab: Vocab, cfg: Dict,
                det: Dict, method: str, pages: Sequence[np.ndarray],
                served: Sequence) -> Dict:
    """The pages' checks, for pages whose served results (a list of result
    dicts, None: never served) are given. The reference ``detector`` (of
    ``reference/detectors/``) draws each page's boxes in reading order and
    the reference reads its own crops of them; the served rows are aligned
    with its boxes (``align``). A page with no reference box (a blank one)
    pairs nothing: each served row there is unpaired. Returns
    {"det_gap": [per page], "box_gap": [per page], "counts":
    ``text_edits``'s counts, "gaps": per line}:

    * det_gap: the widest |det_confidence - the reference's score| over
      the pairs, 1 for each box or row left without a pair;
    * box_gap: the widest 1 - IoU over the pairs, 1 likewise;
    * the texts: each pair's served text against the reference's reading
      of its own crop; a reference line without a pair counts all its
      characters, a served row without one all of its own.
    """
    out = {"det_gap": [], "box_gap": [], "counts": np.zeros(4, np.int64),
           "gaps": []}
    for page, rows in zip(pages, served):
        if rows is None:
            out["det_gap"].append(MISSING)
            out["box_gap"].append(MISSING)
            continue
        mine = detector.boxes(page)
        lines, widths, kept = crop_lines(cfg, page, [b["box"] for b in mine],
                                         det["crop_padding"])
        mine = [mine[k] for k in kept]
        pairs = align([r["box"] for r in rows], [b["box"] for b in mine])
        lone = len(rows) + len(mine) - 2 * len(pairs)
        out["det_gap"].append(max(
            [abs(rows[i]["det_confidence"] - mine[j]["score"])
             for i, j, _ in pairs] + [1.0] * bool(lone), default=0.0))
        out["box_gap"].append(max([1.0 - o for _, _, o in pairs]
                                  + [1.0] * bool(lone), default=0.0))
        texts: List = [None] * len(mine)
        for i, j, _ in pairs:
            texts[j] = rows[i]["text"]
        c, g = text_edits(ref, vocab, cfg, method, lines, widths, texts)
        extra = [rows[i]["text"] for i in sorted(
            set(range(len(rows))) - {i for i, _, _ in pairs})]
        out["counts"] += c + [sum(map(len, extra)), 0, len(extra),
                              len(extra)]
        out["gaps"] += g + [MISSING] * len(extra)
    return out
