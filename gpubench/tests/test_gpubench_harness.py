"""The harness end to end at a tiny size on the CPU (the kernels' plain
versions), the faults the check must catch, and a cell added as new files
only."""
import json
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from harness import spec
from harness.cell import run_cell

TINY_LINES = {"quota": {"english": {"160": 2, "320": 2, "480": 1, "640": 1},
                        "khmer": {"160": 1, "320": 1}},
              "batch": 4, "check_lines": 4}
#: The same eight lines' sizes, call by call, for a mix that fixes them.
TINY_SIZES = [[["english", 160, 7], ["english", 320, 12], ["khmer", 160, 9],
               ["english", 480, 22]],
              [["english", 160, 6], ["english", 320, 14], ["khmer", 320, 17],
               ["english", 640, 31]]]
TINY_PAGES = {"sizes": [[640, 640], [960, 640]],
              "layouts": ["single_column", "two_column"], "batch": 2,
              "check_pages": 2}
SEED = 2 ** 31 + 12345      # past 32 signed bits, as the driver's are


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def tiny(cell):
    if cell["mix"]["inputs"] != "lines":
        return TINY_PAGES
    return (dict(TINY_LINES, sizes=TINY_SIZES) if "sizes" in cell["mix"]
            else TINY_LINES)


def run_tiny(name, traced=False, seconds=0.5):
    cell = spec.load_cell(name)
    return run_cell(cell, SEED, seconds, traced, device="cpu",
                    pool=tiny(cell))


@pytest.mark.parametrize("name,traced", [
    ("lines-fast", False), ("lines-accurate", True),
    ("pages-batch", False), ("page-interactive", True)])
def test_run_ends_in_the_result_line(name, traced):
    out = run_tiny(name, traced)
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    cell = spec.load_cell(name)
    want = cell["per_layer"] if traced else cell["end_to_end"]
    for m, v in line["metrics"].items():
        assert m in want and v["unit"] == want[m]["unit"]
    if not traced:
        assert set(line["metrics"]) == set(want)
        assert all(v["value"] > 0 for v in line["metrics"].values())
    else:
        assert "busy_s" in line["device"] and "breakdown" in line
    for c in line["check"].values():
        assert c["value"] <= c["limit"]


def test_same_seed_same_inputs():
    from harness.cell import model_cfg
    from traffic import make

    cell = spec.load_cell("lines-fast")
    mix = dict(cell["mix"], **TINY_LINES)
    vocab = spec.ROOT / cell["config"]["vocab"]
    a = make.make(mix, SEED, model_cfg(cell), vocab)
    b = make.make(mix, SEED, model_cfg(cell), vocab)
    assert np.array_equal(a["imgs"], b["imgs"]) and a["texts"] == b["texts"]
    c = make.make(mix, SEED + 1, model_cfg(cell), vocab)
    assert a["texts"] != c["texts"]


# ------------------------------------------------------------------ faults
def _alter(text):
    return (text[:-1] + ("x" if text[-1:] != "x" else "y")) if text else "x"


@pytest.mark.parametrize("name", ["lines-fast", "lines-accurate"])
@pytest.mark.parametrize("fault", ["token altered", "half of the batch"])
def test_faults_fail_the_lines_check(monkeypatch, name, fault):
    from kiri_tpu_torch.engine import RecognizerEngine

    real = RecognizerEngine.recognize_batch

    def broken(self, imgs, method, widths=None):
        if fault == "half of the batch":
            half = (len(imgs) + 1) // 2
            out = real(self, imgs[:half], method, widths[:half])
            return out + out[:len(imgs) - half]
        return [(_alter(t), c) for t, c in real(self, imgs, method, widths)]

    monkeypatch.setattr(RecognizerEngine, "recognize_batch", broken)
    assert run_tiny(name)["correct"] is False


def _shifted(rows):
    """The first row's box moved down by half its height."""
    x, y, w, h = rows[0]["box"]
    rows[0]["box"] = [x, y + (h + 1) // 2, w, h]
    return rows


def _merged(rows):
    """The first two rows served as one line: their boxes' union, their
    texts joined."""
    a, b = rows[0], rows[1]
    x0, y0 = min(a["box"][0], b["box"][0]), min(a["box"][1], b["box"][1])
    x1 = max(a["box"][0] + a["box"][2], b["box"][0] + b["box"][2])
    y1 = max(a["box"][1] + a["box"][3], b["box"][1] + b["box"][3])
    one = dict(a, box=[x0, y0, x1 - x0, y1 - y0],
               text=a["text"] + " " + b["text"])
    return [one] + rows[2:]


PAGE_FAULTS = {
    "token altered": lambda rows: [dict(r, text=_alter(r["text"]))
                                   for r in rows],
    "box score altered": lambda rows: [
        dict(r, det_confidence=r["det_confidence"] * 0.9) for r in rows],
    "box shifted": _shifted,
    "two lines merged": _merged,
    "rows reversed": lambda rows: rows[::-1],
}


@pytest.mark.parametrize("fault", ["half of the batch"] + sorted(PAGE_FAULTS))
def test_faults_fail_the_pages_check(monkeypatch, fault):
    from kiri_tpu_torch.pipeline import OCR

    real = OCR.process_documents

    def broken(self, pages, *a, **k):
        if fault == "half of the batch":
            half = (len(pages) + 1) // 2
            out = real(self, pages[:half], *a, **k)
            return out + out[:len(pages) - half]
        return [PAGE_FAULTS[fault](rows) for rows in
                real(self, pages, *a, **k)]

    monkeypatch.setattr(OCR, "process_documents", broken)
    out = run_tiny("pages-batch")
    assert out["correct"] is False, out["check"]


# ------------------------------------------------- a cell as new files only
def copy_checkout(tmp_path):
    """A checkout of the benchmark in ``tmp_path`` (the program and models
    linked), and the bytes of each of its files."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root)
    for name in ("models", "kiri_tpu_torch"):
        (root / name).symlink_to(spec.ROOT / name)
    before = {p: p.read_bytes() for p in (root / "gpubench").rglob("*")
              if p.is_file()}
    return root, before


def test_new_cell_metric_and_config_as_new_files(tmp_path):
    root, before = copy_checkout(tmp_path)
    g = root / "gpubench"
    config = json.loads((g / "configs" / "kiri-ocr-v13.json").read_text())
    config["name"] = "kiri-ocr-v13-copy"
    (g / "configs" / "kiri-ocr-v13-copy.json").write_text(json.dumps(config))
    mix = json.loads((g / "traffic" / "mixes" / "lines-fast.json")
                     .read_text())
    mix.update(TINY_LINES, batch=2)
    (g / "traffic" / "mixes" / "lines-tiny.json").write_text(json.dumps(mix))
    (g / "workloads" / "lines-tiny.json").write_text(
        (g / "workloads" / "lines-fast.json").read_text())
    (g / "metrics" / "lines_per_call.py").write_text(
        "def read(rec):\n"
        "    calls = rec['untraced']\n"
        "    return sum(c['items'] for c in calls) / len(calls)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "kiri-ocr-v13-copy", "source": "x",
                             "file": "gpubench/configs/kiri-ocr-v13-copy."
                             "json", "reduced": [], "why": "a copy"})
    bench["workloads"].append({"name": "lines-tiny",
                               "config": "kiri-ocr-v13-copy",
                               "traffic": "lines-tiny", "chips": 1,
                               "why": "a throwaway cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "lines_per_s":
            m["workloads"].append("lines-tiny")
    bench["per_layer"].append({"name": "lines_per_call", "unit": "lines",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine.RecognizerEngine",
                               "moves": "lines_per_s",
                               "workloads": ["lines-tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, json, torch; torch.set_num_threads(2)\n"
            f"sys.path[:0] = [{str(g)!r}, {str(root)!r}]\n"
            "from harness import spec; from harness.cell import run_cell\n"
            "cell = spec.load_cell('lines-tiny')\n"
            f"print(json.dumps(run_cell(cell, {SEED}, 0.3, True, "
            "device='cpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["lines_per_call"]["value"] == 2.0
    assert set(line["metrics"]) == {"lines_per_call"}
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


@pytest.mark.parametrize("method,stubs,missing", [
    (None, [], "detector.method"),
    ("craft", [], "gpubench/reference/detectors/craft.py"),
    ("craft", ["reference"], "gpubench/flops/detectors/craft.py"),
    ("craft", ["flops"], "gpubench/reference/detectors/craft.py")])
def test_pages_configuration_refused_without_its_detector(
        tmp_path, monkeypatch, method, stubs, missing):
    root, _ = copy_checkout(tmp_path)
    g = root / "gpubench"
    config = json.loads((g / "configs" / "kiri-ocr-v13-db.json").read_text())
    config["name"] = "kiri-ocr-v13-x"
    config["detector"].pop("method")
    if method is not None:
        config["detector"]["method"] = method
    (g / "configs" / "kiri-ocr-v13-x.json").write_text(json.dumps(config))
    for part in stubs:
        (g / part / "detectors" / f"{method}.py").write_text("")
    (g / "workloads" / "pages-x.json").write_text(
        (g / "workloads" / "page-interactive.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "kiri-ocr-v13-x", "source": "x",
                             "file": "gpubench/configs/kiri-ocr-v13-x.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "pages-x", "config": "kiri-ocr-v13-x",
                               "traffic": "page-interactive", "chips": 1,
                               "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "HERE", g)
    assert spec.load_cell("page-interactive", root)["config"]["detector"][
        "method"] == "db"
    with pytest.raises(SystemExit, match=re.escape(missing)):
        spec.load_cell("pages-x", root)


# --------------------------------------------- a detector as new files only
#: The stub's FLOP a page, and the copy's cell on small pages.
STUB_FLOP = 1.25e9
CRAFT_PAGES = {"sizes": [[320, 320], [480, 320]],
               "layouts": ["single_column", "two_column"], "check_pages": 2}


def test_new_detector_as_new_files(tmp_path):
    """A configuration whose detector is the program's CRAFT, with a stub
    reference that finds no boxes and a stub FLOP count, runs through
    ``run_cell`` in a copy of the tree after adding files only."""
    import pickle

    from harness.cell import line_work, model_cfg
    from reference.check import ENGINE_METHOD
    from traffic.preprocess import content_width

    root, before = copy_checkout(tmp_path)
    g = root / "gpubench"
    config = json.loads((g / "configs" / "kiri-ocr-v13-db.json").read_text())
    config.update(name="kiri-ocr-v13-craft", detector={
        "method": "craft", "checkpoint": "models/craft.safetensors",
        "crop_padding": 5, "preprocess": "host"})
    (g / "configs" / "kiri-ocr-v13-craft.json").write_text(json.dumps(config))
    (g / "reference" / "detectors" / "craft.py").write_text(
        "class NoBoxes:\n"
        "    def boxes(self, page):\n"
        "        return []\n\n\n"
        "def load(det, root, device, control=False):\n"
        "    return NoBoxes()\n")
    (g / "flops" / "detectors" / "craft.py").write_text(
        f"def page_flop(det, h, w):\n    return {STUB_FLOP!r}\n")
    mix = json.loads((g / "traffic" / "mixes" / "page-interactive.json")
                     .read_text())
    mix.update(CRAFT_PAGES)
    (g / "traffic" / "mixes" / "pages-craft.json").write_text(json.dumps(mix))
    (g / "workloads" / "pages-craft.json").write_text(
        (g / "workloads" / "page-interactive.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "kiri-ocr-v13-craft", "source": "x",
                             "file": "gpubench/configs/kiri-ocr-v13-craft."
                             "json", "reduced": [], "why": "a stub"})
    bench["workloads"].append({"name": "pages-craft",
                               "config": "kiri-ocr-v13-craft",
                               "traffic": "pages-craft", "chips": 1,
                               "why": "a throwaway cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    # The run, with the detector's forwards and each call's accounting
    # recorded on the side.
    code = ("import sys, json, pickle, torch; torch.set_num_threads(2)\n"
            f"sys.path[:0] = [{str(g)!r}, {str(root)!r}]\n"
            "from harness import spec, cell as C\n"
            "from kiri_tpu_torch.detect.craft import CRAFTDetector\n"
            "forwards, calls = [], []\n"
            "fwd, account = CRAFTDetector.forward_maps, C.account\n"
            "def forward_maps(self, canvases):\n"
            "    forwards.append(len(canvases))\n"
            "    return fwd(self, canvases)\n"
            "def recorded(cell, cfg, traffic, idx, out):\n"
            "    rec = account(cell, cfg, traffic, idx, out)\n"
            "    calls.append(([traffic['pages'][i].shape for i in idx],\n"
            "                  out['answers'], rec['flops']))\n"
            "    return rec\n"
            "CRAFTDetector.forward_maps, C.account = forward_maps, recorded\n"
            "cell = spec.load_cell('pages-craft')\n"
            f"line = C.run_cell(cell, {SEED}, 0.3, False, device='cpu')\n"
            f"pickle.dump((forwards, calls), open({str(tmp_path / 'rec')!r},"
            " 'wb'))\n"
            "print(json.dumps(line))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert line["check"]["det_gap"]["value"] == 1.0
    assert line["correct"] is False
    forwards, calls = pickle.loads((tmp_path / "rec").read_bytes())
    assert sum(forwards) >= len(calls) > 0
    cfg = model_cfg(spec.load_cell("page-interactive"))
    method = ENGINE_METHOD[mix["method"]]
    h, w = cfg["IMG_H"], cfg["IMG_W"]
    served = 0
    for shapes, answers, flops in calls:
        want = STUB_FLOP * len(shapes)
        for (ph, pw), rows in zip(shapes, answers):
            for r in rows:
                x, y, bw, bh = r["box"]
                crop = (min(ph, y + bh + 5) - max(0, y - 5),
                        min(pw, x + bw + 5) - max(0, x - 5))
                want += line_work(cfg, method, content_width(crop, h, w),
                                  r["text"])
                served += 1
        assert flops == pytest.approx(want, rel=1e-12)
    assert served > 0
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
