"""BENCHMARK.json and every file it names: present, loadable, and within
the characters and limits the benchmark's contract allows."""
import json
import os
import re

import pytest

from harness import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|_dim$|_rank$|"
                   r"head|expan|experts_per)", re.I)


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and TEXT.match(c["source"])
    assert TEXT.match(c["why"]) and len(c["reduced"]) <= 16
    assert not any(WIDTH.search(k) for k in c["reduced"])
    body = json.loads((spec.ROOT / c["file"]).read_text())
    assert c["file"].startswith("gpubench/configs/")
    assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
    for key in ("checkpoint", "vocab"):
        assert (spec.ROOT / body[key]).exists()
    used = [w for w in BENCH["workloads"] if w["config"] == c["name"]]
    assert used, "every configuration is used by a cell"


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and TEXT.match(w["why"])
    cell = spec.load_cell(w["name"])
    assert cell["mix"]["inputs"] in ("lines", "pages")
    limits = cell["check"]["limits"]
    assert limits["config_mismatches"] == 0 and limits["unanswered"] == 0
    e2e = cell["end_to_end"]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]
    for m in cell["per_layer"].values():
        assert m["moves"] in e2e


ALL_METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("m", ALL_METRICS, ids=lambda m: m["name"])
def test_metric(m):
    keys = {"name", "unit", "better", "source", "workloads"}
    if m in BENCH["end_to_end"]:
        keys |= {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert TEXT.match(m["layer"])
    assert set(m) <= keys and NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert (spec.HERE / "metrics" / f"{m['name']}.py").exists()
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", [])) <= cells
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in ALL_METRICS]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_layers_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(TEXT.match(k) for k in layers)


def test_files_named_from_name_characters():
    for p in spec.HERE.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(spec.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_host_threads_pinned_from_the_mix(w, monkeypatch):
    import run

    mix = spec.load_cell(w["name"])["mix"]
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        monkeypatch.setenv(var, "7")
    n = run.pin_host_threads(mix)
    assert n == mix.get("host_threads", 0) and n >= 0
    want = str(n) if n else "7"
    assert all(os.environ[v] == want
               for v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                         "OPENBLAS_NUM_THREADS"))
