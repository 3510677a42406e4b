"""Wall-clock accounting of the pipeline's stages (the port of
``StageTimer`` in ``kiri_tpu/utils/profiling.py``). Each stage is also a
``torch.profiler.record_function`` range, so it shows on the host timeline of
a profiler trace."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


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
            with torch.profiler.record_function(name):
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
