"""The device trace of a slice of the window: ``torch.profiler`` over the
host and the card, exported as a Chrome trace into a temporary directory,
read back and deleted.

From it: the device's busy seconds as the union of the kernel, memcpy and
memset intervals (overlapping work counted once), the length of the traced
slice (from the first traced call's start to the last one's end, by the
harness's own ``gpubench.call`` ranges), device seconds by kernel name, and
the idle gaps between device intervals, each put to the innermost host
range that was open at its middle (the harness's call ranges and the
pipeline's stage ranges).
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

import torch

CALL_RANGE = "gpubench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profiled() -> Iterator[Dict]:
    """Profile the block; the dict it yields is filled with the parsed
    trace (``parse``) when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out: Dict = {}
    with tempfile.TemporaryDirectory(prefix="gpubench_trace_") as tmp:
        with profile(activities=acts) as prof:
            yield out
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    out.update(parse(events))


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def parse(events: List[Dict]) -> Dict:
    """{"window_s", "busy_s", "kernels": {name: s}, "idle": {range: s}}
    of the traced slice; all 0 where no call range was traced."""
    calls = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("name") == CALL_RANGE
             and e.get("cat") == "user_annotation"]
    if not calls:
        return {"window_s": 0.0, "busy_s": 0.0, "kernels": {}, "idle": {}}
    lo, hi = min(a for a, _ in calls), max(b for _, b in calls)
    dev, kernels = [], defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], lo), min(e["ts"] + e.get("dur", 0.0), hi)
        if b > a:
            dev.append((a, b))
            kernels[e["name"]] += (b - a) * 1e-6
    busy = union(dev)
    ranges = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("ph") == "X"
                     and e.get("cat") == "user_annotation"),
                    key=lambda r: r[0])
    idle: Dict[str, float] = defaultdict(float)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        open_ = [r for r in ranges if r[0] <= mid <= r[1]]
        name = (min(open_, key=lambda r: r[1] - r[0])[2] if open_
                else "between calls")
        idle[name] += (b - a) * 1e-6
    return {"window_s": (hi - lo) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "kernels": dict(kernels), "idle": dict(idle)}


def breakdown(tr: Dict, top: int = 10) -> Dict:
    def best(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]
    return {"device_ops": best(tr["kernels"]), "idle_gaps": best(tr["idle"])}
