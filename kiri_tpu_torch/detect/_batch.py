"""Grouped batch dispatch of multi-page detector forwards (the port of
``kiri_tpu/detect/_batch.py``).

Pages with the same canvas shape share batched forwards at the batch
buckets (1, 2, 4, 8); bucket padding is sliced off on the device, every
group's forward is launched and its copy to the host started (non-blocking,
into pinned memory on the card) before the first group is handed to the
caller, so the caller's per-page host work runs under the rest.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..utils.profiling import annotate, count

#: Batch-size buckets: pages of one canvas shape share a batch per bucket.
BATCH_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8)


def _to_host_async(t: torch.Tensor):
    """Start the copy of ``t`` to the host; returns (host tensor, event)."""
    if t.device.type != "cuda":
        return t.cpu(), None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def iter_grouped_batches(canvases: Sequence[np.ndarray],
                         fwd: Callable[[np.ndarray], torch.Tensor],
                         buckets: Tuple[int, ...] = BATCH_BUCKETS):
    """Yield ``(page indices, numpy output)`` per dispatched group, in the
    JAX package's order: canvas shapes sorted, then chunks of at most the
    largest bucket in page order.

    ``fwd`` maps a stacked u8 canvas batch [nb, H, W] to a device tensor
    with a leading batch axis; the numpy output is cut to the group's
    pages.
    """
    groups = {}
    for i, c in enumerate(canvases):
        groups.setdefault(c.shape, []).append(i)
    max_b = buckets[-1]
    pending: List = []
    for shape in sorted(groups):
        idxs = groups[shape]
        for s in range(0, len(idxs), max_b):
            chunk = idxs[s: s + max_b]
            nb = next(b for b in buckets if b >= len(chunk))
            with annotate("detect.forward"):
                arr = np.stack([canvases[i] for i in chunk]
                               + [canvases[chunk[-1]]] * (nb - len(chunk)))
                pending.append((chunk,
                                _to_host_async(fwd(arr)[:len(chunk)])))
    for chunk, (host, ev) in pending:
        with annotate("detect.wait"):
            if ev is not None:
                count("host_waits")
                ev.synchronize()
            arr = host.numpy()
        yield chunk, arr
