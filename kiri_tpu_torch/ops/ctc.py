"""CTC ops, the port of ``kiri_tpu/ops/ctc.py``: greedy statistics, the
forward-algorithm alignment score the decoder paths rank candidates with, and
the training loss."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30   # finite, as in the JAX package: NEG_INF - NEG_INF stays 0


def greedy_ctc_stats(logits: torch.Tensor, ctc_offset: int = 2
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits [N, T, C] float32 -> (best_ids [N, T] int32, confidence [N]
    float32, est_len [N] int32).

    Confidence is the per-frame max probability averaged over all frames;
    the length counts transitions to a new non-special id.
    """
    probs = torch.softmax(logits, dim=-1)
    best = logits.argmax(dim=-1).to(torch.int32)
    confidence = probs.amax(dim=-1).mean(dim=-1)
    prev = torch.cat([torch.full_like(best[:, :1], -1), best[:, :-1]], dim=1)
    is_new = (best != prev) & (best >= ctc_offset)
    return best, confidence, is_new.sum(dim=-1).to(torch.int32)


def _ctc_forward_ll(log_probs: torch.Tensor, labels: torch.Tensor,
                    label_lens: torch.Tensor, blank_id: int) -> torch.Tensor:
    """CTC forward recurrence over the blank-interleaved state lattice.

    log_probs [N, T, C] log-softmaxed frames, labels [N, Lmax] CTC ids
    (padding past ``label_lens`` ignored), label_lens [N]. Returns [N]
    log p(labels | frames): the logsumexp of the two terminal states; rows
    without labels get the all-blank path.

    The recurrence is a Python loop over the T - 1 later frames. Each step
    reads the three predecessors of every state (stay, from the state
    before, skip over a blank) as one sliding window over a buffer padded
    with two NEG_INF columns on the left, so a step is a handful of ops.
    """
    n, t, _ = log_probs.shape
    lmax = labels.shape[1]
    s_max = 2 * lmax + 1
    dev = log_probs.device
    labels = labels.long()
    label_lens = label_lens.long()

    s_idx = torch.arange(s_max, device=dev)
    is_label = (s_idx % 2) == 1
    label_idx = ((s_idx - 1) // 2).clamp(0, lmax - 1)
    lab_at = labels[:, label_idx]                                   # [N, S]
    ext = torch.where(is_label[None], lab_at,
                      torch.full_like(lab_at, blank_id))
    # The skip over a blank is allowed at odd s > 1 between unequal labels.
    diff_prev = lab_at != labels[:, (label_idx - 1).clamp(0, lmax - 1)]
    can_skip = is_label[None] & (s_idx[None] > 1) & diff_prev
    valid = s_idx[None] < (2 * label_lens[:, None] + 1)

    # Emissions of every frame at once: [N, T, S].
    emit = log_probs.gather(2, ext[:, None, :].expand(n, t, s_max))
    buf = log_probs.new_full((n, s_max + 2), NEG_INF)
    alpha = buf[:, 2:]
    alpha[:, :2] = emit[:, 0, :2]
    alpha.copy_(torch.where(valid, alpha, NEG_INF))
    # Window [.., s] = (alpha[s-2], alpha[s-1], alpha[s]); the first is open
    # only where the skip is.
    window_open = torch.stack(
        [can_skip, torch.ones_like(can_skip), torch.ones_like(can_skip)], -1)
    for ti in range(1, t):
        win = torch.where(window_open, buf.unfold(1, 3, 1), NEG_INF)
        new = torch.logsumexp(win, dim=-1) + emit[:, ti]
        alpha.copy_(torch.where(valid, new, NEG_INF))

    s_last = 2 * label_lens
    a_last = alpha.gather(1, s_last[:, None])[:, 0]
    a_pen = alpha.gather(1, (s_last - 1).clamp(min=0)[:, None])[:, 0]
    a_pen = torch.where(label_lens > 0, a_pen, NEG_INF)
    return torch.logaddexp(a_last, a_pen)


def ctc_alignment_scores(log_probs: torch.Tensor, labels: torch.Tensor,
                         label_lens: torch.Tensor, blank_id: int = 0
                         ) -> torch.Tensor:
    """Length-normalized CTC forward scores of padded label rows.

    log_probs [N, T, C] log-softmaxed frames, labels [N, Lmax], label_lens
    [N] -> [N]: log p(labels | frames) / max(1, label_len); rows without
    labels get the mean blank log-probability over the frames. Rows do not
    interact, so several candidates per line are scored in one call by
    concatenating them as rows.
    """
    ll = _ctc_forward_ll(log_probs, labels, label_lens, blank_id)
    blank_score = log_probs[:, :, blank_id].mean(dim=-1)
    return torch.where(label_lens > 0, ll / label_lens.clamp(min=1),
                       blank_score)


def ctc_loss(logits: torch.Tensor, logit_lens: torch.Tensor,
             labels: torch.Tensor, label_lens: torch.Tensor,
             blank_id: int = 0) -> torch.Tensor:
    """Batched CTC negative log-likelihood with the JAX package's reduction.

    logits [B, T, C] raw, logit_lens [B], labels [B, Lmax] CTC ids (padding
    past label_lens ignored), label_lens [B] -> a float32 scalar (float64
    for float64 logits): each row's -log p(labels) divided by its label
    count, rows with no labels left out, averaged over the rest. An
    infeasible row (no alignment fits) adds 0 and no gradient.
    ``F.ctc_loss``'s own ``reduction="mean"`` would count the empty rows, so
    it reduces nothing here.
    """
    nll_sum, count = ctc_loss_terms(logits, logit_lens, labels, label_lens,
                                    blank_id)
    return nll_sum / count.clamp(min=1)


def ctc_loss_terms(logits: torch.Tensor, logit_lens: torch.Tensor,
                   labels: torch.Tensor, label_lens: torch.Tensor,
                   blank_id: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ctc_loss`` as (the sum of the per-row terms, the count of rows with
    labels): a data-parallel step adds each over the ranks before it
    divides."""
    log_probs = torch.log_softmax(logits if logits.dtype == torch.float64
                                  else logits.float(), dim=-1).transpose(0, 1)
    nll = F.ctc_loss(log_probs, labels.long(), logit_lens.long(),
                     label_lens.long(), blank=blank_id, reduction="none",
                     zero_infinity=True)
    has = label_lens > 0
    nll = torch.where(has, nll / label_lens.clamp(min=1), 0.0)
    return nll.sum(), has.sum()
