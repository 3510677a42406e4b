"""Autoregressive decoding (beam, CTC-drafted speculative, greedy) over
dense batches, the port of ``kiri_tpu/ops/decode.py``.

* beam state is dense: tokens [N, K, L], scores [N, K], lengths, finished;
* the decoder runs one KV-cached step per iteration for all N*K rows;
* penalties (EOS bias, AAA / AB-AB / A-B-A-B / ABC-ABC repeats, <unk>) are
  indexed adds, one statement per term in the JAX package's order;
* pruning uses the length-normalized score ``score / ((5+L)^p / 6^p)`` and
  the final ranking adds the CTC forward-algorithm alignment score.

Where the JAX package has ``lax.while_loop``, here the loop is Python's and
the step counter a host integer. A loop's end condition lives on the device,
so ``beam_search`` and ``greedy_decode`` run to a bound the host knows and
look at the device's condition only every few steps: lines that are finished
or past their own budget are frozen bit for bit, so steps past the end
change nothing (``poll_every``). Under a profiler each step loop is one
``decode.step_loop`` span and each ``spec_decode`` round a ``decode.round``
span; every look at the device counts in ``host_waits``
(``utils/profiling.py``).

The same steps run a window at a time for streaming
(``beam_stream_window``, ``greedy_stream_window``: the state stays on the
device between windows), and ``beam_search(record_history=True)`` keeps the
best beam after each step for one-shot streaming. ``beam_spec_certificate``
proves, line by line, that beam search would return ``spec_decode``'s
transcript.

Everything runs under the caller's ``torch.inference_mode()`` on the device
of ``mem_proj``; ``model`` is a ``models.recognizer.Recognizer``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import annotate, count
from .ctc import NEG_INF, ctc_alignment_scores

#: Steps between two looks at the device's end-of-loop condition.
POLL_EVERY = 4


class DecodeOut(NamedTuple):
    """Device results of a batched decode (the host makes text of tokens)."""
    tokens: torch.Tensor        # [N, L_buf] best token ids (with bos/eos)
    lengths: torch.Tensor       # [N] tokens incl. bos (and eos if emitted)
    dec_conf: torch.Tensor      # [N] exp(mean step logp) of the best beam
    final_conf: torch.Tensor    # [N] 0.6 * dec + 0.4 * ctc
    ctc_conf: torch.Tensor      # [N]
    hist_steps: torch.Tensor    # [N] steps executed per line
    # [N, l_cap, 2] (raw prob, token id) per step; greedy selection only.
    hist_extra: Optional[torch.Tensor] = None
    # [N] bool; None = always (the step loops run to completion;
    # ``spec_decode`` sets False past its round budget).
    converged: Optional[torch.Tensor] = None
    # ``beam_search(record_history=True)``: the best beam after each step
    # (``_stream_best``), [N, l_cap, L_buf] / [N, l_cap]; zero where a line
    # took no step. None otherwise.
    hist_tokens: Optional[torch.Tensor] = None
    hist_len: Optional[torch.Tensor] = None
    hist_score: Optional[torch.Tensor] = None
    hist_finished: Optional[torch.Tensor] = None


def _repeat_terms(cfg, n, s):
    """The repeat penalties as (token, amount) in the order they are added;
    ``n`` is len(seq) (a host integer or a tensor) and ``s[k]`` the token k
    places back. The A-B-A-B term repeats AB-AB's condition on s[0]: the
    original penalizes that token twice, which is kept."""
    c1 = (n >= 4) & (s[0] == s[1]) & (s[1] == s[2])
    big = (n >= 4) & (s[1] == s[3]) & (s[0] == s[2])
    tri = (n >= 6) & (s[2] == s[5]) & (s[1] == s[4]) & (s[0] == s[3])
    return ((s[0], -cfg.REPEAT_LAST_PENALTY * c1),
            (s[0], -cfg.REPEAT_BIGRAM_PENALTY * big),
            (s[1], -cfg.REPEAT_BIGRAM_PENALTY * big),
            (s[0], -cfg.REPEAT_BIGRAM_PENALTY * big),
            (s[0], -cfg.REPEAT_TRIGRAM_PENALTY * tri),
            (s[1], -cfg.REPEAT_TRIGRAM_PENALTY * tri),
            (s[2], -cfg.REPEAT_TRIGRAM_PENALTY * tri))


def _eos_bias(cfg, pos, target_len: torch.Tensor) -> torch.Tensor:
    """The EOS bias at step ``pos`` (host integer or tensor that broadcasts
    against ``target_len``)."""
    pos = torch.as_tensor(pos, device=target_len.device)
    min_len = (target_len.float() * 0.5).to(torch.int32).clamp(min=1).clamp(
        max=cfg.EOS_BIAS_UNTIL_LEN)
    zero = torch.zeros((), device=target_len.device)
    with_tl = torch.where(pos < min_len, zero - cfg.EOS_LOGP_BIAS,
                          torch.where(pos >= target_len,
                                      zero + cfg.EOS_LOGP_BOOST, zero))
    without = torch.where(pos < cfg.EOS_BIAS_UNTIL_LEN,
                          zero - cfg.EOS_LOGP_BIAS, zero)
    return torch.where(target_len > 0, with_tl, without)


def apply_penalties(logp: torch.Tensor, tokens: torch.Tensor, t: int, cfg,
                    target_len: torch.Tensor, eos_id: int, unk_dec_id: int
                    ) -> torch.Tensor:
    """The penalty stack on the next-token log-probs of step ``t``.

    logp [R, V] fused log-probs, tokens [R, L] the prefixes (tokens[:, t] is
    the newest), ``t`` the host's step counter (len(seq) = t + 1),
    target_len [R] the CTC length estimate (0 = none). Returns a new tensor.

    Two terms may name the same token (s1 == s2 is legal): each term is its
    own ``scatter_add_`` of one element per row, in the JAX package's order,
    so both land and no two adds of a launch meet in one element.
    """
    logp = logp.clone()
    n = t + 1
    if cfg.EOS_LOGP_BIAS != 0.0 or cfg.EOS_LOGP_BOOST != 0.0:
        logp[:, eos_id] += _eos_bias(cfg, t, target_len)
    if n >= 4:      # below that every repeat condition is false: adds of -0
        tokens = tokens.long()
        s = [tokens[:, max(t - back, 0)] for back in range(6)]
        for tok, amount in _repeat_terms(cfg, n, s):
            logp.scatter_add_(1, tok[:, None], amount[:, None])
    logp[:, unk_dec_id] -= cfg.UNK_LOGP_PENALTY
    return logp


def apply_penalties_seq(logp: torch.Tensor, tokens: torch.Tensor, cfg,
                        target_len: torch.Tensor, eos_id: int,
                        unk_dec_id: int) -> torch.Tensor:
    """``apply_penalties`` at every position of a sequence at once.

    logp [N, L, V]: logp[:, p] predicts the token at position p + 1 (step
    t = p); tokens [N, L]: tokens[:, p] is the newest token of step p's
    prefix. Position p gets what ``apply_penalties(logp[:, p], tokens, p)``
    gives. Returns a new tensor.
    """
    logp = logp.clone()
    nrow, lbuf, _ = logp.shape
    dev = logp.device
    pos = torch.arange(lbuf, device=dev)[None, :]
    if cfg.EOS_LOGP_BIAS != 0.0 or cfg.EOS_LOGP_BOOST != 0.0:
        logp[:, :, eos_id] += _eos_bias(cfg, pos, target_len[:, None])
    tokens = tokens.long()
    s = [tokens.gather(1, (pos - back).clamp(min=0).expand(nrow, lbuf))
         for back in range(6)]
    for tok, amount in _repeat_terms(cfg, pos + 1, s):
        logp.scatter_add_(2, tok[..., None], amount[..., None])
    logp[:, :, unk_dec_id] -= cfg.UNK_LOGP_PENALTY
    return logp


def _fused_logp(dec_logits: torch.Tensor, lm_logits: Optional[torch.Tensor],
                cfg) -> torch.Tensor:
    logp = torch.log_softmax(dec_logits, dim=-1)
    if lm_logits is not None and cfg.USE_LM and cfg.USE_LM_FUSION_EVAL:
        logp = logp + cfg.LM_FUSION_ALPHA * torch.log_softmax(lm_logits,
                                                              dim=-1)
    return logp


def max_decode_steps(cfg, target_len: torch.Tensor, mem_len: int
                     ) -> torch.Tensor:
    """Per-line step budget: from the CTC length estimate where there is
    one, else from the memory's length."""
    with_tl = ((target_len.float() * cfg.DEC_MAX_LEN_RATIO).to(torch.int32)
               + cfg.DEC_MAX_LEN_PAD).clamp(max=cfg.MAX_DEC_LEN)
    without = min(cfg.MAX_DEC_LEN,
                  int(mem_len * cfg.MEM_MAX_LEN_RATIO) + cfg.DEC_MAX_LEN_PAD)
    return torch.where(target_len > 0, with_tl,
                       torch.full_like(with_tl, without))


def max_decode_steps_host(cfg, target_len: np.ndarray, mem_len: int
                          ) -> np.ndarray:
    """``max_decode_steps`` on the host, in the device's float32, so that a
    loop bound taken from it is the device's own budget."""
    tl = np.asarray(target_len)
    with_tl = np.minimum(
        cfg.MAX_DEC_LEN,
        (tl.astype(np.float32) * np.float32(cfg.DEC_MAX_LEN_RATIO)
         ).astype(np.int32) + cfg.DEC_MAX_LEN_PAD)
    without = min(cfg.MAX_DEC_LEN,
                  int(mem_len * cfg.MEM_MAX_LEN_RATIO) + cfg.DEC_MAX_LEN_PAD)
    return np.where(tl > 0, with_tl, without).astype(np.int32)


def _scatter_drop(rows: int, width: int, dest: torch.Tensor,
                  values: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """zeros [rows, width] with values[r, j] written at [r, dest[r, j]] where
    ``keep``; the others are dropped: they go to a spare last column that is
    cut off."""
    buf = torch.zeros((rows, width + 1), dtype=torch.int32,
                      device=values.device)
    dest = torch.where(keep & (dest < width), dest,
                       torch.full_like(dest, width))
    buf.scatter_(1, dest, values.to(torch.int32))
    return buf[:, :width]


def _labels_from_tokens(tokens: torch.Tensor, lengths: torch.Tensor,
                        eos_id: int, dec_offset: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense decoder sequences -> left-compacted CTC label rows: keeps ids
    >= dec_offset at positions [1, length) (drops bos/pad/eos) and maps
    decoder id -> CTC id (id - 1, the offsets being 3 and 2)."""
    r, lbuf = tokens.shape
    pos = torch.arange(lbuf, device=tokens.device)[None, :]
    keep = (pos >= 1) & (pos < lengths[:, None]) & (tokens >= dec_offset)
    dest = keep.cumsum(1) - 1
    labels = _scatter_drop(r, lbuf, dest, tokens - 1, keep)
    return labels, keep.sum(1).to(torch.int32)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, equal values by rising index (what
    ``lax.top_k`` gives; ``torch.topk`` promises no order among equals, and
    the beam's candidate pool holds exact ties at NEG_INF)."""
    if k == 1:
        v, i = x.max(dim=-1, keepdim=True)
        return v, i
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _norm_penalty(cfg, length: torch.Tensor) -> torch.Tensor:
    lf = length.clamp(min=1).float()
    return (5.0 + lf) ** cfg.BEAM_LENP / (5.0 + 1.0) ** cfg.BEAM_LENP


def _step_bound(max_steps: torch.Tensor, step_bound: Optional[int]) -> int:
    """The number of steps the host loops for: the caller's, else the
    largest budget, fetched."""
    return int(max_steps.max()) if step_bound is None else int(step_bound)


def _poll(t: int, poll_every: int) -> bool:
    """Whether a step loop asks the device after step ``t`` if any line is
    still active: a host wait, counted."""
    if not (poll_every and (t + 1) % poll_every == 0):
        return False
    count("host_waits")
    return True


# ==========================================================================
# Beam search
# ==========================================================================
def _beam_step(model, cross_kvs, target_len, max_steps, t: int, tokens,
               scores, lengths, finished, cache, steps_done, *, cfg,
               eos_id: int, unk_dec_id: int):
    """One beam-search step for all N lines. Returns the updated (tokens,
    scores, lengths, finished, cache, steps_done) and the lines that took
    the step; lines past their step budget or with every beam finished are
    frozen bit for bit.

    The K/V cache rows follow their beams: after the step the cache is
    gathered by parent (``index_select`` over its row axis)."""
    n, K, l_buf = tokens.shape
    dev = tokens.device
    line_active = (t < max_steps) & ~finished.all(dim=1)              # [N]

    cur_tok = tokens.gather(
        2, (lengths - 1).clamp(min=0).long()[..., None])[..., 0]
    dec_logits, lm_logits = model.decoder_step(cur_tok.reshape(n * K), t,
                                               cache, cross_kvs)
    logp = _fused_logp(dec_logits, lm_logits, cfg)                # [N*K, V]
    logp = apply_penalties(logp, tokens.reshape(n * K, l_buf), t, cfg,
                           target_len.repeat_interleave(K), eos_id,
                           unk_dec_id)
    logp = logp.view(n, K, -1)
    topv, topi = _top_k(logp, K)                                  # [N, K, K]

    # Candidate pool per line: K parents x K expansions. A finished parent
    # contributes itself once (slot 0) and NEG_INF dummies.
    parent_fin = finished[..., None]                              # [N, K, 1]
    self_slot = (torch.arange(K, device=dev) == 0)[None, None, :]
    cand_scores = torch.where(
        parent_fin,
        torch.where(self_slot, scores[..., None], NEG_INF),
        scores[..., None] + topv).clamp(min=NEG_INF)
    cand_len = torch.where(parent_fin, lengths[..., None],
                           lengths[..., None] + 1).expand(n, K, K)
    cand_fin = parent_fin | (topi == eos_id)
    cand_tok = torch.where(parent_fin, 0, topi)

    normed = cand_scores / _norm_penalty(cfg, cand_len - 1)
    _, sel_idx = _top_k(normed.reshape(n, K * K), K)              # [N, K]
    parent = sel_idx // K

    def g(x):
        return x.reshape(n, K * K).gather(1, sel_idx)

    new_scores, new_lengths = g(cand_scores), g(cand_len)
    new_finished, new_tok_ids = g(cand_fin), g(cand_tok)

    parent_tokens = tokens.gather(1, parent[..., None].expand(n, K, l_buf))
    write_pos = lengths.gather(1, parent).clamp(max=l_buf - 1).long()[
        ..., None]
    was_fin = finished.gather(1, parent)[..., None]
    new_tokens = parent_tokens.scatter(
        2, write_pos, torch.where(was_fin, parent_tokens.gather(2, write_pos),
                                  new_tok_ids[..., None].to(tokens.dtype)))
    if K > 1:
        flat_parent = (torch.arange(n, device=dev)[:, None] * K
                       + parent).reshape(-1)
        cache = cache.index_select(1, flat_parent)

    la = line_active[:, None]
    tokens = torch.where(la[..., None], new_tokens, tokens)
    scores = torch.where(la, new_scores, scores)
    lengths = torch.where(la, new_lengths, lengths)
    finished = torch.where(la, new_finished, finished)
    steps_done = steps_done + line_active.to(torch.int32)
    return tokens, scores, lengths, finished, cache, steps_done, line_active


def _stream_best(cfg, tokens, scores, lengths, finished):
    """Each line's best beam as streaming ranks beams: by the score over
    plain ``L^p`` (not the pruning norm), the first of equals. Returns its
    (tokens [N, L_buf], length, score, finished)."""
    normed = scores / (lengths - 1).clamp(min=1).float() ** cfg.BEAM_LENP
    best = normed.argmax(dim=1, keepdim=True)
    l_buf = tokens.shape[2]
    return (tokens.gather(1, best[..., None].expand(-1, 1, l_buf))[:, 0],
            lengths.gather(1, best)[:, 0], scores.gather(1, best)[:, 0],
            finished.gather(1, best)[:, 0])


def _record(hist, row, active, snapshot) -> None:
    """Write a step's best-beam ``snapshot`` into row ``row`` of the history
    buffers (tokens, len, score, finished) for the ``active`` lines."""
    for buf, val in zip(hist, snapshot):
        keep = active.view(-1, *([1] * (val.dim() - 1)))
        buf[:, row] = torch.where(keep, val, buf[:, row])


def _new_history(n: int, steps: int, l_buf: int, dev):
    """Zeroed best-beam history buffers (tokens, len, score, finished)."""
    return (torch.zeros((n, steps, l_buf), dtype=torch.int32, device=dev),
            torch.zeros((n, steps), dtype=torch.int32, device=dev),
            torch.zeros((n, steps), device=dev),
            torch.zeros((n, steps), dtype=torch.bool, device=dev))


def beam_search(model, mem_proj: torch.Tensor,
                ctc_logits: Optional[torch.Tensor], target_len: torch.Tensor,
                ctc_conf: torch.Tensor, *, cfg, k_beam: int, l_cap: int,
                eos_id: int = 2, unk_dec_id: int = 3, dec_offset: int = 3,
                bos_id: int = 1, step_bound: Optional[int] = None,
                poll_every: int = POLL_EVERY,
                record_history: bool = False) -> DecodeOut:
    """Batched beam search over N lines with K beams each.

    mem_proj [N, T, D] projected memory in the compute dtype; ctc_logits
    [N, T, C] or None (the final fusion rescoring); target_len [N] int32 CTC
    length estimates (0 = none); l_cap the decode-step budget of the batch.

    The loop runs ``step_bound`` steps: an upper bound of every line's own
    budget that the host knows (``max_decode_steps_host``; None fetches the
    largest budget from the device). A line that is finished or past its
    budget is frozen bit for bit, so the steps after the last line's end
    change nothing; every ``poll_every`` steps the host asks the device
    whether any line is still active and stops when none is (0 = never
    asks). The result does not depend on ``poll_every`` or on a larger
    ``step_bound``.

    The K/V cache is written in place at the step's position and read up to
    it; for K > 1 its rows are gathered by beam parent after each step.

    ``record_history`` keeps each line's best beam after every step it took
    (``hist_*`` of the result), what one-shot beam streaming replays.
    """
    n, t_mem, _ = mem_proj.shape
    K = k_beam
    l_buf = l_cap + 2
    dev = mem_proj.device
    target_len = target_len.to(torch.int32)
    max_steps = max_decode_steps(cfg, target_len, t_mem).clamp(max=l_cap)

    cross_kvs = model.decode_prepare(mem_proj)     # per line, shared by beams
    cache = model.init_decode_cache(n * K, l_buf, mem_proj.dtype)
    tokens = torch.zeros((n, K, l_buf), dtype=torch.int32, device=dev)
    tokens[:, :, 0] = bos_id
    scores = torch.full((n, K), NEG_INF, device=dev)
    scores[:, 0] = 0.0
    lengths = torch.ones((n, K), dtype=torch.int32, device=dev)
    finished = torch.zeros((n, K), dtype=torch.bool, device=dev)
    steps_done = torch.zeros((n,), dtype=torch.int32, device=dev)
    hist = _new_history(n, l_cap, l_buf, dev) if record_history else None

    with annotate("decode.step_loop"):
        for t in range(min(_step_bound(max_steps, step_bound), l_cap)):
            (tokens, scores, lengths, finished, cache, steps_done,
             active) = _beam_step(
                model, cross_kvs, target_len, max_steps, t, tokens, scores,
                lengths, finished, cache, steps_done, cfg=cfg, eos_id=eos_id,
                unk_dec_id=unk_dec_id)
            if hist is not None:
                _record(hist, t, active,
                        _stream_best(cfg, tokens, scores, lengths, finished))
            if _poll(t, poll_every) and not bool(
                    ((t + 1 < max_steps) & ~finished.all(dim=1)).any()):
                break

    # ---- final scoring with CTC fusion ----
    L = (lengths - 1).clamp(min=1).float()
    dec_score = scores / L ** cfg.BEAM_LENP
    dec_conf = torch.where(lengths > 1, torch.exp(scores / L),
                           torch.zeros_like(scores)).clamp(0.0, 1.0)
    if ctc_logits is not None and cfg.CTC_FUSION_ALPHA > 0:
        log_probs = torch.log_softmax(ctc_logits, dim=-1)
        labels, lab_lens = _labels_from_tokens(
            tokens.reshape(n * K, l_buf), lengths.reshape(-1), eos_id,
            dec_offset)
        ctc_scores = ctc_alignment_scores(
            log_probs.repeat_interleave(K, dim=0), labels, lab_lens
        ).view(n, K)
        combined = dec_score + cfg.CTC_FUSION_ALPHA * ctc_scores
    else:
        combined = dec_score

    best = combined.argmax(dim=1, keepdim=True)
    best_tokens = tokens.gather(1, best[..., None].expand(n, 1, l_buf))[:, 0]
    best_dec_conf = dec_conf.gather(1, best)[:, 0]
    final_conf = (0.6 * best_dec_conf + 0.4 * ctc_conf
                  if ctc_logits is not None else best_dec_conf)
    out = DecodeOut(best_tokens, lengths.gather(1, best)[:, 0],
                    best_dec_conf, final_conf, ctc_conf, steps_done)
    if hist is not None:
        out = out._replace(hist_tokens=hist[0], hist_len=hist[1],
                           hist_score=hist[2], hist_finished=hist[3])
    return out


# ==========================================================================
# Speculative decode (CTC-drafted) for the single-hypothesis paths
# ==========================================================================
def spec_decode(model, mem_proj: torch.Tensor,
                ctc_ids: Optional[torch.Tensor], target_len: torch.Tensor,
                ctc_conf: Optional[torch.Tensor], *, cfg, l_cap: int,
                eos_id: int = 2, unk_dec_id: int = 3, dec_offset: int = 3,
                bos_id: int = 1, raw_select: bool = False,
                max_rounds: int = 0,
                ctc_logits: Optional[torch.Tensor] = None) -> DecodeOut:
    """Speculative decode: the greedy-CTC transcript drafts the output and
    teacher-forced passes over whole sequences verify it.

    The token chosen at a step is a deterministic function of the prefix,
    so holding a proposal against the per-position choice reproduces the
    step loop:

    * a round is one ``decoder_forward_heads`` pass over the proposal
      (accepted prefix + the rest of the CTC draft) -> fused and penalized
      logp at every position -> accept the longest prefix whose per-step
      choice equals the proposal, then append the model's choice at the
      first divergence (a substitution keeps the rest of the draft aligned,
      so the next round usually accepts everything);
    * every round accepts at least one token per active row. The host
      fetches one flag per round (is any row still active), which the round
      budget keeps to a handful.

    raw_select=False is "decoder"/accurate mode, i.e. beam search with one
    beam: the choice is the argmax of the fused and penalized logp.
    raw_select=True is greedy streaming's selection: the argmax of the raw
    decoder logits (penalties and LM fusion change only the recorded logp);
    ``hist_extra`` then carries (raw prob, token id) per step.

    ctc_ids [N, T] per-frame greedy CTC ids, or None for an empty draft (one
    full pass per token, still exact). max_rounds 0 = run to completion;
    > 0 bounds the rounds: rows still unfinished return ``converged=False``
    and the caller decodes them again with the step loop. ctc_logits
    [N, T, C]: when given (and not raw_select, and cfg.CTC_FUSION_ALPHA > 0)
    the output is chosen between two candidates, the accepted transcript and
    the CTC draft itself, by beam's final formula (length-normalized decoder
    logp + alpha * CTC alignment score); the draft's decoder score is read
    off round 1, which teacher-forces every draft position. Both candidates
    are aligned in one ``ctc_alignment_scores`` call.
    """
    n, t_mem, _ = mem_proj.shape
    l_buf = l_cap + 2
    dev = mem_proj.device
    target_len = target_len.to(torch.int32)
    max_steps = max_decode_steps(cfg, target_len, t_mem).clamp(max=l_cap)

    # ---- CTC draft -> decoder-space proposal (dedup, drop blanks/pad) ----
    # A frame equal to the one before is skipped (blanks count as "before"),
    # then blank/pad ids; CTC id -> decoder id is +1.
    if ctc_ids is not None:
        ctc_ids = ctc_ids.to(torch.int32)
        prev = torch.cat([torch.full_like(ctc_ids[:, :1], -1),
                          ctc_ids[:, :-1]], dim=1)
        keep = (ctc_ids != prev) & (ctc_ids >= dec_offset - 1)
        tokens0 = _scatter_drop(n, l_buf, keep.cumsum(1), ctc_ids + 1, keep)
        draft_len = keep.sum(1).clamp(max=l_buf - 1).to(torch.int32)
    else:
        tokens0 = torch.zeros((n, l_buf), dtype=torch.int32, device=dev)
        draft_len = torch.zeros((n,), dtype=torch.int32, device=dev)
    tokens0[:, 0] = bos_id
    prop_len0 = 1 + draft_len

    tokens, prop_len = tokens0.clone(), prop_len0
    acc_len = torch.ones((n,), dtype=torch.int32, device=dev)
    score = torch.zeros((n,), device=dev)
    finished = torch.zeros((n,), dtype=torch.bool, device=dev)
    hist_prob = torch.zeros((n, l_buf), device=dev)
    draft_score = torch.full((n,), NEG_INF, device=dev)
    rescore = (ctc_logits is not None and not raw_select
               and cfg.CTC_FUSION_ALPHA > 0 and ctc_ids is not None)
    pos = torch.arange(l_buf, device=dev)[None, :]
    rows_n = torch.arange(n, device=dev)

    rounds = 0
    while max_rounds <= 0 or rounds < max_rounds:
        with annotate("decode.round"):
            active = ~finished & (acc_len - 1 < max_steps)
            count("host_waits")
            if not bool(active.any()):
                break
            dec_logits, lm_logits = model.decoder_forward_heads(mem_proj,
                                                                tokens)
            logp = apply_penalties_seq(_fused_logp(dec_logits, lm_logits, cfg),
                                       tokens, cfg, target_len, eos_id,
                                       unk_dec_id)
            if raw_select:
                chosen = dec_logits.argmax(dim=-1)
                chosen_prob = torch.softmax(dec_logits, dim=-1).amax(dim=-1)
            else:
                chosen = logp.argmax(dim=-1)
                chosen_prob = torch.zeros_like(hist_prob)
            chosen_logp = logp.gather(2, chosen[..., None])[..., 0]
            chosen = chosen.to(torch.int32)

            # Accept while the choice equals the proposed next token; stop at
            # the first divergence / end of proposal / step budget and append
            # the model's own choice there.
            prop_next = torch.cat([tokens[:, 1:],
                                   torch.zeros_like(tokens[:, :1])], dim=1)
            in_prop = pos + 1 < prop_len[:, None]
            if rescore and rounds == 0:
                # Round 1's proposal is the CTC draft, teacher-forced at
                # every position: its step-loop score (the penalized logp of
                # each draft token, plus eos after the whole draft) is read
                # off here.
                tok_logp = logp.gather(2, prop_next.long()[..., None])[..., 0]
                eos_pos = (prop_len - 1).clamp(min=0).long()[:, None]
                eos_lp = logp[..., eos_id].gather(1, eos_pos)[:, 0]
                draft_score = (torch.where(in_prop, tok_logp, 0.0).sum(1)
                               + eos_lp)
            good = in_prop & (pos < max_steps[:, None]) & (chosen == prop_next)
            bad = (pos >= (acc_len - 1)[:, None]) & ~good
            p_stop = bad.to(torch.int8).argmax(dim=1).to(torch.int32)
            can_append = p_stop < max_steps
            corr = chosen.gather(1, p_stop.long()[:, None])[:, 0]

            new_acc_len = torch.where(active,
                                      p_stop + 1 + can_append.to(torch.int32),
                                      acc_len)
            stepm = ((pos >= (acc_len - 1)[:, None])
                     & (pos < (new_acc_len - 1)[:, None]))
            score = torch.where(
                active, score + torch.where(stepm, chosen_logp, 0.0).sum(1),
                score)
            wr = active & can_append
            wpos = (p_stop + 1).clamp(max=l_buf - 1).long()
            tokens[rows_n, wpos] = torch.where(wr, corr, tokens[rows_n, wpos])
            finished = torch.where(wr, corr == eos_id, finished)
            # A substitution leaves the draft's tail after the corrected
            # position proposed as it was, so prop_len only grows.
            prop_len = torch.where(active,
                                   torch.maximum(prop_len, new_acc_len),
                                   prop_len)
            hist_prob = torch.where(active[:, None], chosen_prob, hist_prob)
            acc_len = new_acc_len
            rounds += 1
    converged = finished | (acc_len - 1 >= max_steps)

    if rescore:
        # Candidate A is the accepted transcript, B the CTC draft with eos
        # appended. B is considered only where the loop converged (other
        # rows go to the caller's step loop) and the draft fits the budget.
        log_probs = torch.log_softmax(ctc_logits, dim=-1)
        tokens_b = tokens0.clone()
        tokens_b[rows_n, prop_len0.clamp(max=l_buf - 1).long()] = eos_id
        len_b = (prop_len0 + 1).clamp(max=l_buf)
        labels, lab_lens = _labels_from_tokens(
            torch.cat([tokens, tokens_b]), torch.cat([acc_len, len_b]),
            eos_id, dec_offset)
        align_a, align_b = ctc_alignment_scores(
            torch.cat([log_probs, log_probs]), labels, lab_lens).split(n)
        l_a = (acc_len - 1).clamp(min=1).float()
        l_bn = (len_b - 1).clamp(min=1).float()
        comb_a = score / l_a ** cfg.BEAM_LENP + cfg.CTC_FUSION_ALPHA * align_a
        comb_b = (draft_score / l_bn ** cfg.BEAM_LENP
                  + cfg.CTC_FUSION_ALPHA * align_b)
        use_b = ((comb_b > comb_a) & (prop_len0 > 1) & converged
                 & (prop_len0 - 1 <= max_steps))
        tokens = torch.where(use_b[:, None], tokens_b, tokens)
        acc_len = torch.where(use_b, len_b, acc_len)
        score = torch.where(use_b, draft_score, score)

    L = (acc_len - 1).clamp(min=1).float()
    dec_conf = torch.where(acc_len > 1, torch.exp(score / L),
                           torch.zeros_like(score)).clamp(0.0, 1.0)
    if ctc_conf is not None:
        final_conf, ctc_conf_out = 0.6 * dec_conf + 0.4 * ctc_conf, ctc_conf
    else:
        final_conf, ctc_conf_out = dec_conf, torch.zeros_like(dec_conf)
    # Step s is the prediction at position s -> the token at position s + 1.
    # The last round verifies every accepted prefix again with the same
    # logits, so its probabilities hold for every step.
    hist_extra = torch.stack([hist_prob[:, :l_cap],
                              tokens[:, 1:l_cap + 1].float()], dim=-1)
    return DecodeOut(tokens, acc_len, dec_conf, final_conf, ctc_conf_out,
                     (acc_len - 1).to(torch.int32), hist_extra, converged)


# ==========================================================================
# Greedy decode (the choice is the argmax of the raw decoder logits)
# ==========================================================================
def _greedy_step(model, cross_kvs, target_len, max_steps, t: int, tokens,
                 lengths, score, finished, cache, steps_done, *, cfg,
                 eos_id: int, unk_dec_id: int):
    """One greedy step for all N lines. The token is the argmax of the raw
    decoder logits; penalties and LM fusion change only the recorded logp.
    Returns the updated state and (active, best_prob, best_id, best_logp)."""
    n, l_buf = tokens.shape
    active = (t < max_steps) & ~finished
    cur_tok = tokens.gather(1, (lengths - 1).clamp(min=0).long()[:, None])[:, 0]
    dec_logits, lm_logits = model.decoder_step(cur_tok, t, cache, cross_kvs)
    logp = apply_penalties(_fused_logp(dec_logits, lm_logits, cfg), tokens, t,
                           cfg, target_len, eos_id, unk_dec_id)
    best_prob, best_id = torch.softmax(dec_logits, dim=-1).max(dim=-1)
    best_logp = logp.gather(1, best_id[:, None])[:, 0]
    best_id = best_id.to(torch.int32)

    wpos = lengths.clamp(max=l_buf - 1).long()[:, None]
    new_tokens = tokens.scatter(
        1, wpos, torch.where(active[:, None], best_id[:, None],
                             tokens.gather(1, wpos)))
    new_lengths = torch.where(active, lengths + 1, lengths)
    new_finished = torch.where(active, best_id == eos_id, finished)
    new_score = torch.where(active, score + best_logp, score)
    steps_done = steps_done + active.to(torch.int32)
    return (new_tokens, new_lengths, new_score, new_finished, steps_done,
            active, best_prob, best_id, best_logp)


def greedy_decode(model, mem_proj: torch.Tensor, target_len: torch.Tensor,
                  *, cfg, l_cap: int, eos_id: int = 2, unk_dec_id: int = 3,
                  bos_id: int = 1, step_bound: Optional[int] = None,
                  poll_every: int = POLL_EVERY) -> DecodeOut:
    """Greedy decode of N lines with the per-step history (raw softmax
    probability, token id) in ``hist_extra``. ``step_bound`` and
    ``poll_every`` as in ``beam_search``."""
    n, t_mem, _ = mem_proj.shape
    l_buf = l_cap + 2
    dev = mem_proj.device
    target_len = target_len.to(torch.int32)
    max_steps = max_decode_steps(cfg, target_len, t_mem).clamp(max=l_cap)
    cross_kvs = model.decode_prepare(mem_proj)
    cache = model.init_decode_cache(n, l_buf, mem_proj.dtype)

    tokens = torch.zeros((n, l_buf), dtype=torch.int32, device=dev)
    tokens[:, 0] = bos_id
    lengths = torch.ones((n,), dtype=torch.int32, device=dev)
    finished = torch.zeros((n,), dtype=torch.bool, device=dev)
    score = torch.zeros((n,), device=dev)
    steps_done = torch.zeros((n,), dtype=torch.int32, device=dev)
    hist_extra = torch.zeros((n, l_cap, 2), device=dev)

    with annotate("decode.step_loop"):
        for t in range(min(_step_bound(max_steps, step_bound), l_cap)):
            (tokens, lengths, score, finished, steps_done, active, best_prob,
             best_id, _) = _greedy_step(
                model, cross_kvs, target_len, max_steps, t, tokens, lengths,
                score, finished, cache, steps_done, cfg=cfg, eos_id=eos_id,
                unk_dec_id=unk_dec_id)
            hist_extra[:, t] = torch.where(
                active[:, None],
                torch.stack([best_prob, best_id.float()], -1),
                hist_extra[:, t])
            if _poll(t, poll_every) and not bool(
                    ((t + 1 < max_steps) & ~finished).any()):
                break

    L = (lengths - 1).clamp(min=1).float()
    dec_conf = torch.where(lengths > 1, torch.exp(score / L),
                           torch.zeros_like(score)).clamp(0.0, 1.0)
    return DecodeOut(tokens, lengths, dec_conf, dec_conf,
                     torch.zeros_like(dec_conf), steps_done, hist_extra)


# ==========================================================================
# Certificate-gated speculative beam
# ==========================================================================
def beam_spec_certificate(model, mem_proj: torch.Tensor,
                          ctc_logits: Optional[torch.Tensor],
                          target_len: torch.Tensor, tokens: torch.Tensor,
                          lengths: torch.Tensor, *, cfg, k_beam: int,
                          l_cap: int, eos_id: int = 2, unk_dec_id: int = 3,
                          dec_offset: int = 3) -> torch.Tensor:
    """[N] bool: True where ``beam_search(k_beam)`` provably returns the
    single-hypothesis transcript ``tokens`` [N, L_buf] (``spec_decode``'s,
    ``lengths`` [N]), from one teacher-forced pass over it.

    The argument (the JAX package's, ``kiri_tpu/ops/decode.py``): every
    step's score term is <= 0 when ``EOS_LOGP_BOOST == 0``,
    ``EOS_LOGP_BIAS >= 0`` and ``BEAM_LENP >= 0`` (else all False). A beam
    that leaves the path g first takes a runner-up token v at some step t';
    its score stays <= D = S(t') + logp_t'[v], S being g's prefix sum. (A)
    If max D over the pruning norm at the largest length stays below g's
    own normed trajectory, g is the top beam at every step; (B) if max D
    over ``max_steps^BEAM_LENP`` (alignment term <= 0) stays below g's final
    CTC-fused score, the final choice is g. g must also be the strict
    argmax of this pass at every step (by a margin) and max D < 0; a margin
    in normed-score space absorbs the drift between this pass and the
    cached steps.

    With LM fusion on (the committed checkpoint's setting) every chosen
    token costs ~1.4 nats of LM entropy that the bound cannot charge to a
    competitor, and the JAX package measured 0 of 24 clean lines certified;
    with ``USE_LM_FUSION_EVAL=False`` rows do certify.
    """
    n, l_buf = tokens.shape
    dev = tokens.device
    K = k_beam
    if (K < 2 or cfg.EOS_LOGP_BOOST != 0.0 or cfg.EOS_LOGP_BIAS < 0.0
            or cfg.BEAM_LENP < 0.0):
        return torch.zeros((n,), dtype=torch.bool, device=dev)
    # Margins for the drift between the whole-sequence pass and the cached
    # step path: in normed-score space and between the top two tokens.
    eps_norm, eps_tok = 0.1, 0.05
    target_len = target_len.to(torch.int32)
    max_steps = max_decode_steps(cfg, target_len, mem_proj.shape[1]).clamp(
        max=l_cap)
    dec_logits, lm_logits = model.decoder_forward_heads(mem_proj, tokens)
    logp = apply_penalties_seq(_fused_logp(dec_logits, lm_logits, cfg),
                               tokens, cfg, target_len, eos_id, unk_dec_id)
    topv, topi = _top_k(logp, K)                             # [N, L, K]

    pos = torch.arange(l_buf, device=dev)[None, :]
    n_steps = (lengths - 1).clamp(min=0)
    step_mask = pos < n_steps[:, None]
    nxt = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    chosen_lp = logp.gather(2, nxt.long()[..., None])[..., 0]
    path_ok = (~step_mask | ((topi[..., 0] == nxt)
                             & (topv[..., 0] - topv[..., 1] > eps_tok))
               ).all(dim=1)

    step_lp = torch.where(step_mask, chosen_lp, 0.0)
    S = step_lp.cumsum(dim=1)                             # after step t
    s_final = S.gather(1, (n_steps - 1).clamp(min=0).long()[:, None])[:, 0]
    s_final = torch.where(n_steps > 0, s_final, 0.0)
    # Branch roots: the K - 1 runner-up expansions of g at each step.
    D = (S - step_lp)[..., None] + topv[..., 1:]
    D = torch.where(step_mask[..., None], D, NEG_INF)
    max_d = D.reshape(n, -1).amax(dim=1)

    g_norm = torch.where(step_mask, S / _norm_penalty(cfg, pos + 1),
                         float("inf"))
    cond_a = (max_d / _norm_penalty(cfg, max_steps)
              < g_norm.amin(dim=1) - eps_norm)

    comb_g = s_final / n_steps.clamp(min=1).float() ** cfg.BEAM_LENP
    if ctc_logits is not None and cfg.CTC_FUSION_ALPHA > 0:
        labels, lab_lens = _labels_from_tokens(tokens, lengths, eos_id,
                                               dec_offset)
        comb_g = comb_g + cfg.CTC_FUSION_ALPHA * ctc_alignment_scores(
            torch.log_softmax(ctc_logits, dim=-1), labels, lab_lens)
    comp_ub = max_d / max_steps.clamp(min=1).float() ** cfg.BEAM_LENP
    cond_b = comp_ub < comb_g - eps_norm
    return path_ok & cond_a & cond_b & (n_steps > 0) & (max_d < 0.0)


# ==========================================================================
# Resumable (windowed) streaming decode
# ==========================================================================
# The one-shot loops run to the end and the host replays their history;
# these run a window of steps at a time, the state (tokens, scores, K/V
# cache) staying on the device between windows, so that the first records
# of a line show after one window. They take the one-shot loops' steps
# (``_beam_step``, ``_greedy_step``), so the records are the same.
class BeamStreamState(NamedTuple):
    t: int                   # host: the step the next window starts at
    bound: int               # host: no line takes a step at or past it
    tokens: torch.Tensor     # [N, K, L_buf]
    scores: torch.Tensor     # [N, K]
    lengths: torch.Tensor    # [N, K]
    finished: torch.Tensor   # [N, K] bool
    cache: torch.Tensor      # the K/V cache, rows follow their beams
    steps_done: torch.Tensor  # [N]
    max_steps: torch.Tensor  # [N] each line's step budget


class GreedyStreamState(NamedTuple):
    t: int
    bound: int
    tokens: torch.Tensor     # [N, L_buf]
    lengths: torch.Tensor    # [N]
    score: torch.Tensor      # [N]
    finished: torch.Tensor   # [N] bool
    cache: torch.Tensor
    steps_done: torch.Tensor  # [N]
    max_steps: torch.Tensor  # [N]


def _window_steps(state, w: int) -> range:
    return range(state.t, min(state.t + w, state.bound))


def _stop_early(t_next: int, steps: range, poll_every: int, max_steps,
                finished) -> bool:
    """Every ``poll_every`` steps of a window short of its last, one fetch:
    True once no line takes step ``t_next``."""
    return bool(poll_every and t_next < steps.stop
                and (t_next - steps.start) % poll_every == 0
                and not ((t_next < max_steps) & ~finished).any())


def beam_stream_init(model, mem_proj: torch.Tensor, target_len: torch.Tensor,
                     *, cfg, k_beam: int, l_cap: int, bos_id: int = 1,
                     step_bound: Optional[int] = None):
    """The initial beam state and each decoder layer's cross-attention K/V
    (``decode_prepare``, passed unchanged to every window). ``step_bound``
    as in ``beam_search``."""
    n, t_mem, _ = mem_proj.shape
    l_buf = l_cap + 2
    dev = mem_proj.device
    target_len = target_len.to(torch.int32)
    max_steps = max_decode_steps(cfg, target_len, t_mem).clamp(max=l_cap)
    tokens = torch.zeros((n, k_beam, l_buf), dtype=torch.int32, device=dev)
    tokens[:, :, 0] = bos_id
    scores = torch.full((n, k_beam), NEG_INF, device=dev)
    scores[:, 0] = 0.0
    state = BeamStreamState(
        0, min(_step_bound(max_steps, step_bound), l_cap), tokens, scores,
        torch.ones((n, k_beam), dtype=torch.int32, device=dev),
        torch.zeros((n, k_beam), dtype=torch.bool, device=dev),
        model.init_decode_cache(n * k_beam, l_buf, mem_proj.dtype),
        torch.zeros((n,), dtype=torch.int32, device=dev), max_steps)
    return state, model.decode_prepare(mem_proj)


def beam_stream_window(model, state: BeamStreamState, cross_kvs,
                       target_len: torch.Tensor, *, cfg, w: int,
                       eos_id: int = 2, unk_dec_id: int = 3,
                       poll_every: int = POLL_EVERY):
    """Advance every line by up to ``w`` beam steps.

    Returns (state, hist, all_done): ``hist`` = (tokens [N, w, L_buf], len,
    score, finished [N, w]) holds the best beam after each step of the
    window (row s is step ``state.t + s``; rows a line did not take stay
    zero); ``all_done`` is a device bool, no line has a step left.

    Lines take their steps from the window's start on, so the JAX
    package's window ends after ``steps_done.max()`` steps in all; the loop
    here may run frozen steps past that (polled every ``poll_every``),
    which change nothing.
    """
    target_len = target_len.to(torch.int32)
    n, _, l_buf = state.tokens.shape
    hist = _new_history(n, w, l_buf, state.tokens.device)
    tokens, scores, lengths, finished, cache, steps_done = state[2:8]
    t_next = state.t
    steps = _window_steps(state, w)
    for t in steps:
        (tokens, scores, lengths, finished, cache, steps_done,
         active) = _beam_step(
            model, cross_kvs, target_len, state.max_steps, t, tokens,
            scores, lengths, finished, cache, steps_done, cfg=cfg,
            eos_id=eos_id, unk_dec_id=unk_dec_id)
        _record(hist, t - state.t, active,
                _stream_best(cfg, tokens, scores, lengths, finished))
        t_next = t + 1
        if _stop_early(t_next, steps, poll_every, state.max_steps,
                       finished.all(dim=1)):
            break
    state = state._replace(t=t_next, tokens=tokens, scores=scores,
                           lengths=lengths, finished=finished, cache=cache,
                           steps_done=steps_done)
    all_done = ~((t_next < state.max_steps) & ~finished.all(dim=1)).any()
    return state, hist, all_done


def greedy_stream_init(model, mem_proj: torch.Tensor,
                       target_len: torch.Tensor, *, cfg, l_cap: int,
                       bos_id: int = 1, step_bound: Optional[int] = None):
    """The initial greedy state and the cross-attention K/V."""
    n, t_mem, _ = mem_proj.shape
    l_buf = l_cap + 2
    dev = mem_proj.device
    target_len = target_len.to(torch.int32)
    max_steps = max_decode_steps(cfg, target_len, t_mem).clamp(max=l_cap)
    tokens = torch.zeros((n, l_buf), dtype=torch.int32, device=dev)
    tokens[:, 0] = bos_id
    state = GreedyStreamState(
        0, min(_step_bound(max_steps, step_bound), l_cap), tokens,
        torch.ones((n,), dtype=torch.int32, device=dev),
        torch.zeros((n,), device=dev),
        torch.zeros((n,), dtype=torch.bool, device=dev),
        model.init_decode_cache(n, l_buf, mem_proj.dtype),
        torch.zeros((n,), dtype=torch.int32, device=dev), max_steps)
    return state, model.decode_prepare(mem_proj)


def greedy_stream_window(model, state: GreedyStreamState, cross_kvs,
                         target_len: torch.Tensor, *, cfg, w: int,
                         eos_id: int = 2, unk_dec_id: int = 3,
                         poll_every: int = POLL_EVERY):
    """Advance every line by up to ``w`` greedy steps (the argmax of the
    raw logits, as ``greedy_decode``). Returns (state, extra, all_done):
    ``extra`` [N, w, 2] holds (raw prob, token id) of each step of the
    window; the rest as ``beam_stream_window``."""
    target_len = target_len.to(torch.int32)
    n = state.tokens.shape[0]
    extra = torch.zeros((n, w, 2), device=state.tokens.device)
    tokens, lengths, score, finished, cache, steps_done = state[2:8]
    t_next = state.t
    steps = _window_steps(state, w)
    for t in steps:
        (tokens, lengths, score, finished, steps_done, active, best_prob,
         best_id, _) = _greedy_step(
            model, cross_kvs, target_len, state.max_steps, t, tokens,
            lengths, score, finished, cache, steps_done, cfg=cfg,
            eos_id=eos_id, unk_dec_id=unk_dec_id)
        extra[:, t - state.t] = torch.where(
            active[:, None], torch.stack([best_prob, best_id.float()], -1),
            extra[:, t - state.t])
        t_next = t + 1
        if _stop_early(t_next, steps, poll_every, state.max_steps, finished):
            break
    state = state._replace(t=t_next, tokens=tokens, lengths=lengths,
                           score=score, finished=finished,
                           steps_done=steps_done)
    all_done = ~((t_next < state.max_steps) & ~finished).any()
    return state, extra, all_done


def pick_l_cap(cfg, max_steps_host: int, buckets=None) -> int:
    """Smallest configured step bucket that covers ``max_steps_host``."""
    bs = buckets if buckets is not None else cfg.STEP_BUCKETS
    for b in bs:
        if b >= max_steps_host:
            return int(b)
    return int(bs[-1])
