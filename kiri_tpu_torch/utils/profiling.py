"""Tracing and stage timing (the port of ``kiri_tpu/utils/profiling.py``):

* ``trace(logdir)``: a ``torch.profiler`` trace of the host and the card,
  written into ``logdir`` as a Chrome trace (``chrome://tracing``,
  Perfetto);
* ``annotate(name)``: a named range on the host timeline of such a trace
  (``torch.profiler.record_function``);
* ``StageTimer``: wall-clock seconds per named pipeline stage, each stage
  also an ``annotate`` range.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def trace(logdir: str = "kiri_trace") -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU, and CUDA where a card is present) and write
    ``logdir/trace_<pid>_<n>.json``, a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    n = len(list(out.glob(f"trace_{os.getpid()}_*.json")))
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{n}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range on the host timeline of a ``trace``."""
    with torch.profiler.record_function(name):
        yield


class StageTimer:
    """Seconds and calls per named stage; one per pipeline call (not
    thread-safe)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with annotate(name):
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        total = sum(self.totals.values())
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * t / total if total else 0.0
            lines.append(f"  {name:24s} {t * 1000:8.1f} ms "
                         f"({pct:4.1f}%)  x{self.counts[name]}")
        lines.append(f"  {'TOTAL':24s} {total * 1000:8.1f} ms")
        return "\n".join(lines)
