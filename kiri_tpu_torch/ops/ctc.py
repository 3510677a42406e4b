"""Greedy CTC statistics, the port of ``kiri_tpu/ops/ctc.py::greedy_ctc_stats``."""
from __future__ import annotations

from typing import Tuple

import torch


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
