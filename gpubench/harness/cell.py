"""One run of one cell: set-up, warm-up, the measured window, the traced
slice, the check against the reference, and the result line."""
from __future__ import annotations

import importlib.util
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from flops import recognizer, stem
from flops.detectors import page_flop
from reference.check import ENGINE_METHOD, run as ref_check
from traffic import make
from traffic.preprocess import content_width, width_bucket

from . import trace as T
from .entries import ENTRIES

METRICS = Path(__file__).resolve().parents[1] / "metrics"
#: The traced slice starts at this share of the window and lasts at most
#: TRACE_S seconds (or this share of the window, if less).
TRACE_AT, TRACE_S, TRACE_SHARE = 0.4, 3.0, 0.4


def reader(name: str) -> Callable:
    spec = importlib.util.spec_from_file_location(
        f"gpubench_metric_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def model_cfg(cell: Dict) -> Dict:
    root = Path(cell["root"])
    vocab = json.loads((root / cell["config"]["vocab"]).read_text(
        encoding="utf-8"))
    n = len(vocab) + (0 if "<unk>" in vocab else 1)
    return dict(cell["config"]["model"], VOCAB=n)


# ------------------------------------------------------------ accounting
def line_work(cfg: Dict, method: str, width: int, text: Optional[str]
              ) -> float:
    tokens = 0 if text is None else len(text) + 1
    return recognizer.line_flop(cfg, width_bucket(cfg, width), method, tokens)


def account(cell: Dict, cfg: Dict, traffic: Dict, idx, out: Dict) -> Dict:
    """Work of one call: items, model FLOP, the stem's least seconds."""
    mix = cell["mix"]
    method = ENGINE_METHOD[mix["method"]]
    rec = {"items": len(idx), "fallback": out.get("fallback", 0),
           "stages": out.get("stages", {})}
    if mix["inputs"] == "lines":
        widths = traffic["widths"][idx]
        rec["flops"] = sum(line_work(cfg, method, int(w), a[0] if a else None)
                           for w, a in zip(widths, out["answers"]))
        per: Dict[int, int] = {}
        for w in widths:
            b = width_bucket(cfg, int(w))
            per[b] = per.get(b, 0) + 1
        top = int(cfg["BATCH_BUCKETS"][-1])
        rec["stem_least_s"] = sum(
            stem.least_s(min(top, n - s), b, int(cfg["IMG_H"]))
            for b, n in per.items() for s in range(0, n, top))
        return rec
    h, w = int(cfg["IMG_H"]), int(cfg["IMG_W"])
    det = cell["config"]["detector"]
    flops = 0.0
    for i, rows in zip(idx, out["answers"]):
        page = traffic["pages"][i]
        flops += page_flop(det, *page.shape)
        for r in rows or []:
            x, y, bw, bh = r["box"]
            ch = min(page.shape[0], y + bh + 5) - max(0, y - 5)
            cw = min(page.shape[1], x + bw + 5) - max(0, x - 5)
            flops += line_work(cfg, method, content_width((ch, cw), h, w),
                               r["text"])
    rec["flops"] = flops
    return rec


# ------------------------------------------------------------------ window
def window(entry, traffic: Dict, plan: List, seconds: float,
           traced: bool) -> Dict:
    """Calls back to back for ``seconds``; with ``traced`` a slice of them
    under the profiler. Returns the calls (t0, t1, plan index, output,
    traced) and the parsed trace."""
    calls, tr = [], None
    t_start = time.perf_counter()
    k = 0
    slice_s = min(TRACE_S, TRACE_SHARE * seconds)
    prof = None
    while True:
        now = time.perf_counter() - t_start
        # The slice starts at TRACE_AT of the window, or with the last call
        # where the window would close before it.
        if traced and prof is None and tr is None and (
                now >= TRACE_AT * seconds or now >= seconds):
            prof = T.profiled()
            tr = prof.__enter__()
            # The slice is counted from here: starting the profiler takes
            # seconds.
            t_trace = time.perf_counter() - t_start
        idx = plan[k % len(plan)]
        t0 = time.perf_counter()
        with torch.profiler.record_function(T.CALL_RANGE):
            out = entry.call(traffic, idx)
        t1 = time.perf_counter()
        calls.append({"t0": t0, "t1": t1, "k": k % len(plan), "out": out,
                      "traced": prof is not None})
        k += 1
        if prof is not None and t1 - t_start - t_trace >= slice_s:
            prof.__exit__(None, None, None)
            prof = None
        if t1 - t_start >= seconds and prof is None and (
                tr is not None or not traced):
            break
    return {"calls": calls, "trace": tr}


# --------------------------------------------------------------------- run
def run_cell(cell: Dict, seed: int, seconds: float, traced: bool,
             device="cuda", start: Optional[float] = None,
             pool: Optional[Dict] = None) -> Dict:
    """One run; ``pool`` overrides traffic parameters (the CPU tests' tiny
    pools)."""
    t_setup0 = start if start is not None else time.time()
    root = Path(cell["root"])
    mix = dict(cell["mix"], **(pool or {}))
    cell = dict(cell, mix=mix)
    cfg = model_cfg(cell)
    entry = ENTRIES[mix["entry"]](cell["config"], mix, root, device)
    traffic = make.make(mix, seed, cfg, root / cell["config"]["vocab"])
    plan = entry.plan(traffic)
    for idx in plan:                      # warm-up: every call the window
        entry.call(traffic, idx)          # makes, once
    if torch.cuda.is_available() and str(device).startswith("cuda"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t_setup0
    w = window(entry, traffic, plan, seconds, traced)
    calls = w["calls"]
    peak = (torch.cuda.max_memory_allocated()
            if str(device).startswith("cuda") else 0)
    program_cfg = entry.program_config()
    for c in calls:
        c.update(account(cell, cfg, traffic, plan[c["k"]], c["out"]))
    # The last answer served for each input of the pool.
    served: Dict[int, object] = {}
    for c in calls:
        for i, a in zip(plan[c["k"]], c["out"]["answers"]):
            served[int(i)] = a
    entry.close()
    check = ref_check(cell, cfg, program_cfg, traffic, served, seed,
                          device)

    untraced = [c for c in calls if not c["traced"]]
    rec = {"setup_s": setup_s, "calls": calls, "untraced": untraced,
           "traced": [c for c in calls if c["traced"]],
           "trace": w["trace"], "cfg": cfg, "mix": mix}
    names = (cell["per_layer"] if traced else cell["end_to_end"])
    metrics = {}
    for name, m in names.items():
        value = reader(name)(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if str(device).startswith("cuda") else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if str(device).startswith("cuda") else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": check["correct"],
           "attempted": sum(c["items"] for c in calls),
           "failed": sum(1 for c in calls for a in c["out"]["answers"]
                         if a is None),
           "metrics": metrics, "device": dev}
    if traced and w["trace"] is not None:
        dev["busy_s"] = w["trace"]["busy_s"]
        dev["window_s"] = w["trace"]["window_s"]
        out["breakdown"] = T.breakdown(w["trace"])
    out["check"] = check["numbers"]
    return out
