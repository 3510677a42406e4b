"""Tracing and stage timing (the port of ``kiri_tpu/utils/profiling.py``):

* ``trace(logdir)``: a ``torch.profiler`` trace of the host and the card,
  written into ``logdir`` as a Chrome trace (``chrome://tracing``,
  Perfetto);
* ``annotate(name)``: the program's span, a named range on the host
  timeline of such a trace (``torch.profiler.record_function``) while a
  profiler records, and nothing at all otherwise (one flag check);
* ``count(name, n)``: a counter of the same traced stretch, kept only
  while a profiler records; ``counters()`` reads the table and
  ``reset_counters()`` clears it;
* ``StageTimer``: wall-clock seconds per named pipeline stage, kept
  always, each stage also an ``annotate`` span.

"Tracing on" means exactly "a ``torch.profiler`` session is recording",
as under ``trace(...)``: spans and counters then cover the same stretch as
the device trace, on its clock. An operator reads the counters after the
traced block::

    reset_counters()
    with trace("kiri_trace"):
        engine.recognize_batch(imgs, "decoder", widths)
    counters()          # e.g. {"host_waits": 11}

The program's spans are dotted layer names (``engine.encode``,
``decode.round``, ``detect.wait``, ...); the one counter is
``host_waits``, each time the host waits for the card's results.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import ContextManager, Dict, Iterator

import torch
from torch.autograd import _profiler_enabled

_NO_SPAN = contextlib.nullcontext()
_COUNTERS: Dict[str, int] = {}


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


def annotate(name: str) -> ContextManager:
    """A named range on the host timeline of a ``trace``; with no profiler
    recording, the block runs with nothing around it."""
    if not _profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if _profiler_enabled():
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of the counter table."""
    return dict(_COUNTERS)


def reset_counters() -> None:
    _COUNTERS.clear()


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
