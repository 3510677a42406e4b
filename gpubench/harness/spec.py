"""A cell as ``BENCHMARK.json`` and the files it names describe it.

``load_cell(name)`` gathers, by name only: the cell's entry in
``BENCHMARK.json``, its configuration file, its traffic mix, its check
(``workloads/<cell>.json``), and the metrics that list it (a metric with
no ``workloads`` key belongs to every cell that reports the end-to-end
metric it moves). A pages cell's configuration names its detector
(``detector.method``, the program's ``det_method``); the cell is refused
unless that detector's reference (``reference/detectors/<method>.py``) and
FLOP count (``flops/detectors/<method>.py``) are there.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _listed(metric: Dict, cell: str, default: bool) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else default


def _check_detector(config: Dict) -> None:
    method = config.get("detector", {}).get("method")
    if not isinstance(method, str) or not method.isidentifier():
        raise SystemExit(f"gpubench: configuration {config['name']!r} serves "
                         f"pages, so its detector needs a method "
                         f"(\"detector.method\", the program's det_method): "
                         f"got {method!r}")
    for part in ("reference", "flops"):
        path = HERE / part / "detectors" / f"{method}.py"
        if not path.is_file():
            raise SystemExit(f"gpubench: configuration {config['name']!r} "
                             f"names detector {method!r}, which has no "
                             f"{path.relative_to(HERE.parent)}")


def load_cell(name: str, root: Path = ROOT) -> Dict:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"gpubench: no cell {name!r} in BENCHMARK.json "
                         f"(cells: {sorted(cells)})")
    w = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if _listed(m, name, True)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _listed(m, name, m["moves"] in moved)]
    body = json.loads((root / config["file"]).read_text())
    mix = json.loads((HERE / "traffic" / "mixes"
                      / f"{w['traffic']}.json").read_text())
    if mix["inputs"] == "pages":
        _check_detector(body)
    return {
        "name": name, "chips": int(w["chips"]), "root": root,
        "config": body, "mix": mix,
        "check": json.loads((HERE / "workloads"
                             / f"{name}.json").read_text()),
        "end_to_end": {m["name"]: m for m in e2e},
        "per_layer": {m["name"]: m for m in per_layer},
    }
