"""The port's tracing API (kiri_tpu_torch/utils/profiling.py), the
counterpart of kiri_tpu's ``trace`` on ``jax.profiler.trace`` and
``annotate`` on ``TraceAnnotation``: ``trace`` writes a Chrome trace on the
CPU, and ``annotate`` ranges and ``StageTimer`` stages show in it as
``record_function`` ranges."""
from __future__ import annotations

import json

import torch

from kiri_tpu_torch.utils.profiling import StageTimer, annotate, trace


def _events(logdir):
    files = sorted(logdir.glob("trace_*.json"))
    assert len(files) == 1
    return json.loads(files[0].read_text())["traceEvents"]


def test_trace_writes_annotated_ranges(tmp_path):
    timer = StageTimer()
    with trace(str(tmp_path / "t")) as prof:
        with annotate("kiri_outer"):
            with timer.stage("kiri_stage"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    names = {e.get("name"): e.get("cat") for e in _events(tmp_path / "t")}
    assert names.get("kiri_outer") == "user_annotation"
    assert names.get("kiri_stage") == "user_annotation"
    assert timer.counts["kiri_stage"] == 1 and timer.totals["kiri_stage"] > 0
    assert "kiri_stage" in timer.report()


def test_trace_files_do_not_overwrite(tmp_path):
    for _ in range(2):
        with trace(str(tmp_path)):
            with annotate("x"):
                torch.zeros(3).sum()
    assert len(list(tmp_path.glob("trace_*.json"))) == 2


def test_annotate_outside_a_trace_runs_the_block():
    with annotate("nothing_records_this"):
        y = torch.arange(4).sum()
    assert int(y) == 6
