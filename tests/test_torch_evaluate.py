"""The port's accuracy entry points (kiri_tpu_torch/evaluate.py) against the
JAX scripts they port, on the CPU with the same seeds and the pseudo-glyph
pool on both sides: ``scripts/eval_recognizer.py``,
``scripts/eval_detector.py`` and ``scripts/eval_pipeline.py`` run by their
own ``main()`` (through importlib, ``sys.argv`` set, the last JSON line
read), the port's ``*_main`` with the same flags plus ``--device cpu
--no-fonts``. The small float32 recognizer of tests/torch_pages.py and the
committed DB detector. Reports are compared exactly (every number is
rounded to 4 places on both sides); the degraded line crops byte for
byte."""
from __future__ import annotations

import importlib.util
import io
import json
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
from torch_pages import REPO, cv2_without_ipp, small_ckpt  # noqa: F401

from kiri_tpu.data import synth as JS
from kiri_tpu_torch import evaluate as E


@pytest.fixture(autouse=True)
def pseudo_fonts(monkeypatch):
    """kiri_tpu's generators find no system font, as the port's do with
    ``--no-fonts``."""
    monkeypatch.setattr(JS, "_FONT_DIRS", [])


def run_jax_script(name: str, argv, monkeypatch):
    """The last JSON line of ``scripts/<name>.py``'s ``main()``."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [name, *argv])
    out = io.StringIO()
    with redirect_stdout(out):
        try:
            mod.main()
        except _Stop:
            return None
    return json.loads(out.getvalue().strip().splitlines()[-1])


class _Stop(Exception):
    pass


class _NoModel:
    """Stands in for kiri_tpu's OCR where only the lines are compared: it
    stops the script at its first recognition."""

    def __init__(self, *a, **k):
        from kiri_tpu.config import CFG

        self.cfg = CFG()

    @property
    def engine(self):
        raise _Stop


def run_port(main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        got = main([*argv, "--device", "cpu", "--no-fonts"])
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert last == json.loads(json.dumps(got))
    return last


@pytest.mark.parametrize("enhance", [False, True],
                         ids=["degrade", "degrade-enhance"])
def test_degraded_crops_equal_the_scripts(enhance, monkeypatch):
    """The crops ``eval_recognizer.py --degrade [--enhance]`` hands to the
    resize, byte for byte; every condition is drawn in 12 lines."""
    import kiri_tpu.ops.preprocess as JP
    from kiri_tpu_torch.config import CFG

    seen = []
    resize = JP.resize_keep_ratio_pad_np

    def record(img, h, w):
        seen.append(img.copy())
        return resize(img, h, w)

    monkeypatch.setattr(JP, "resize_keep_ratio_pad_np", record)
    monkeypatch.setattr("kiri_tpu.pipeline.OCR", _NoModel)
    run_jax_script("eval_recognizer", ["--n", "12", "--degrade"]
                   + ["--enhance"] * enhance, monkeypatch)
    samples, conds = E.line_samples(CFG(), 12, degrade=True, enhance=enhance,
                                    font_dirs=[])
    assert set(conds) == set(E.LINE_CONDITIONS)
    assert len(seen) == len(samples) == 12
    for a, b in zip(seen, samples):
        assert a.dtype == b["image"].dtype and np.array_equal(a, b["image"])


@pytest.mark.parametrize("extra", [[], ["--degrade", "--enhance"]],
                         ids=["plain", "degrade-enhance"])
def test_eval_recognizer_report(small_ckpt, extra, monkeypatch, tmp_path):
    """n = 6, "fast" and "beam": the report (and the error dump's JSON)
    equal to the script's."""
    argv = ["--model", small_ckpt, "--n", "6", "--methods", "fast,beam",
            *extra]
    want = run_jax_script("eval_recognizer",
                          argv + ["--dump-errors", str(tmp_path / "j")],
                          monkeypatch)
    got = run_port(E.recognizer_main,
                   argv + ["--dump-errors", str(tmp_path / "t")])
    assert got == want
    assert set(got["report"]) == {"fast", "beam"}
    assert got["report"]["fast"]["all"]["n"] == 6
    for m in ("fast", "beam"):
        name = f"errors_{m}.json"
        assert (tmp_path / "t" / name).read_text() == \
            (tmp_path / "j" / name).read_text()
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir())


def test_eval_detector_report(monkeypatch):
    """One document a row through DB: recall, precision, detections and the
    summary equal to the script's."""
    want = run_jax_script("eval_detector", ["--n", "1"], monkeypatch)
    got = run_port(E.detector_main, ["--n", "1"])
    assert got == want
    assert got["total_docs"] == 8 and len(got["report"]) == 8


def test_eval_pipeline_rows(small_ckpt, monkeypatch):
    """One page each of "clean" and "rotated" with deskew: the rows and the
    summary equal to the script's."""
    argv = ["--model", small_ckpt, "--n", "1", "--deskew"]
    want = run_jax_script("eval_pipeline", argv, monkeypatch)
    got = run_port(E.pipeline_main, argv)
    assert got == want
    assert list(got["summary"]) == ["clean", "rotated"]


def test_covers_rule_and_scripts():
    """``_covers`` and ``_rect_of`` give the script's verdicts on 2,000
    random pairs (integer corners, so that edges coincide often);
    ``script_of`` the recognizer script's labels."""
    spec = importlib.util.spec_from_file_location(
        "_jax_eval_detector", REPO / "scripts" / "eval_detector.py")
    jd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jd)
    spec = importlib.util.spec_from_file_location(
        "_jax_eval_recognizer", REPO / "scripts" / "eval_recognizer.py")
    jr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jr)
    rng = np.random.default_rng(3)
    verdicts = []
    for _ in range(2000):
        pts = rng.integers(0, 40, (2, 2))
        gt = tuple(int(v) for v in rng.integers(0, 30, 2)) + tuple(
            int(v) for v in rng.integers(1, 20, 2))
        assert E._rect_of(pts) == jd._rect_of(pts)
        verdicts.append(E._covers(E._rect_of(pts), gt))
        assert verdicts[-1] == jd._covers(jd._rect_of(pts), gt)
    assert 50 < sum(verdicts) < 1950
    assert E._covers((20, 10, 30, 20), (10, 10, 20, 10))   # centre on edge
    for t in ("abc 1", "ក abc", "កខ ។", "", "-", "ក1"):
        assert E.script_of(t) == jr.script_of(t)
        assert E.levenshtein(t, "ក abc") == jr.lev(t, "ក abc")
