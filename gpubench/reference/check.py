"""The check of a run: a sample of the window's served answers, drawn from
the seed with the longest answer in it, judged by the plain reference
(``judge``) once the program is gone. Every number has its limit in the
cell's ``workloads/<cell>.json``; the run is correct when each is at or
below it.

* ``config_mismatches``: keys of the configuration's model dict that the
  program runs with another value (limit 0: a run that departs from the
  stated configuration is no sound run);
* ``unanswered``: sampled inputs whose answer never came (limit 0);
* ``char_diff`` and ``line_diff`` (%); for pages ``det_gap`` and
  ``box_gap``; for the accurate method ``dec_gap`` (the widest over the
  lines) and ``dec_gap_p95`` (their 95th percentile) (``judge``).

Only the numbers the cell's file gives a limit are compared (and
printed); ``readings`` holds every number, for setting limits.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

from . import detectors
from .judge import page_checks, text_edits
from .recognizer import RefRecognizer
from .tokens import Vocab

ENGINE_METHOD = {"fast": "ctc", "accurate": "decoder", "ctc": "ctc",
                 "decoder": "decoder"}


def size_of(answer) -> int:
    """A served answer's size: a line's text length, a page's lines."""
    if answer is None:
        return -1
    return len(answer[0]) if isinstance(answer, tuple) else len(answer)


def sample(served: Dict, n: int, seed: int) -> list:
    """``n`` served inputs drawn from the seed, the largest (``size_of``)
    among them."""
    keys = sorted(served)
    size = size_of
    largest = max(keys, key=lambda k: size(served[k]))
    rng = np.random.default_rng([seed, 7])
    rest = [k for k in keys if k != largest]
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [largest] + [rest[i] for i in sorted(pick)]


def run(cell: Dict, cfg: Dict, program_cfg: Dict, traffic: Dict,
        served: Dict, seed: int, device, precision: str = "f32") -> Dict:
    root = Path(cell["root"])
    config, mix = cell["config"], cell["mix"]
    limits = cell["check"]["limits"]
    method = ENGINE_METHOD[mix["method"]]
    numbers = {"config_mismatches": sum(
        1 for k, v in config["model"].items()
        if k in program_cfg and _norm(program_cfg[k]) != _norm(v))}
    vocab = Vocab(root / config["vocab"], bool(cfg["KHMER_VISUAL_ORDER"]))
    ref = RefRecognizer(root / config["checkpoint"], cfg, device, precision)
    if mix["inputs"] == "lines":
        keys = sample(served, int(mix["check_lines"]), seed)
        texts = [None if served[k] is None else served[k][0] for k in keys]
        numbers["unanswered"] = sum(t is None for t in texts)
        counts, gaps = text_edits(ref, vocab, cfg, method,
                                  traffic["imgs"][keys],
                                  traffic["widths"][keys], texts)
    else:
        keys = sample(served, int(mix["check_pages"]), seed)
        rows = [served[k] for k in keys]
        numbers["unanswered"] = sum(r is None for r in rows)
        detector = detectors.load(config["detector"], root, device)
        pages = page_checks(ref, detector, vocab, cfg, config["detector"],
                            method, [traffic["pages"][k] for k in keys],
                            rows)
        numbers["det_gap"] = max(pages["det_gap"])
        numbers["box_gap"] = max(pages["box_gap"])
        counts, gaps = pages["counts"], pages["gaps"]
    e, n, lines_off, lines = (int(c) for c in counts)
    numbers["char_diff"] = 100.0 * e / max(n, 1)
    numbers["line_diff"] = 100.0 * lines_off / max(lines, 1)
    if method == "decoder":
        numbers["dec_gap"] = max(gaps, default=0.0)
        numbers["dec_gap_p95"] = (float(np.percentile(gaps, 95)) if gaps
                                  else 0.0)
    out = {k: {"value": float(v), "limit": float(limits[k])}
           for k, v in numbers.items() if k in limits}
    return {"correct": all(c["value"] <= c["limit"] for c in out.values()),
            "numbers": out,
            "readings": {k: float(v) for k, v in numbers.items()}}


def _norm(v):
    return list(v) if isinstance(v, (list, tuple)) else v
