"""Store the evals fixture that the port's accuracy and training-recipe
entry points are held to on the card (the GPU machine has no JAX):

    python scripts/make_torch_smoke_evals.py

writes ``kiri_tpu_torch/assets/smoke_evals.npz``: one JSON string,
``evals``, of ``kiri_tpu``'s answers, made on the CPU by the JAX scripts'
own ``main()`` (loaded with importlib, ``sys.argv`` set, nothing in them
edited), with font discovery off (``kiri_tpu.data.synth._FONT_DIRS``
emptied in this process only, so every line and page is drawn with the
pseudo-glyph pool) and cv2's IPP off. The recognizer is the committed v13
checkpoint in float32 (``OCR`` replaced in this process by a subclass
that passes ``use_fp16=False``); the detector is the committed DB one.
Sizes and flags are ``kiri_tpu_torch.smoke``'s ``EVAL_*`` and
``RECIPE_ARGV``; digests are ``smoke.digest``.

* ``versions``: Pillow, cv2 and numpy;
* ``recognizer``: ``scripts/eval_recognizer.py --n 64 --methods
  fast,accurate,beam``, plain (``plain``) and ``--degrade --enhance``
  (``degrade``): ``report`` (its last line), ``outputs`` ({method: [[text,
  confidence]] of the 64 lines}) and ``crops`` (the digest of each line as
  handed to the resize); ``degrade`` also holds ``degraded``, each line's
  digest after ``--degrade`` alone;
* ``detector``: ``scripts/eval_detector.py --n 2``: ``summary`` (its last
  line) and ``boxes`` ({row: [[x0, y0, x1, y1] of each line] a page});
* ``pipeline``: ``scripts/eval_pipeline.py --n 2 --deskew --enhance
  --conditions clean,rotated,low_contrast,noisy,rotated+noisy``: its last
  line;
* ``recipe``: ``scripts/train_recognizer.py`` with ``RECIPE_ARGV``, its
  ``train_loop`` replaced by a stub that keeps the lines: ``train`` and
  ``val`` ([digest, text] a line) and ``vocab`` (``vocab.json``'s text).

About 6 minutes on 8 CPU cores. It refuses to change a fixture the
committed file already holds: delete the file first to regenerate it.
"""
from __future__ import annotations

import importlib.util
import io
import json
import sys
import tempfile
import time
from contextlib import redirect_stdout
from pathlib import Path
from types import SimpleNamespace

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from kiri_tpu_torch.smoke import (EVAL_CONDITIONS,  # noqa: E402
                                  EVAL_DET_DOCS, EVAL_LINES, EVAL_METHODS,
                                  EVAL_PAGES, RECIPE_ARGV, SMOKE_EVALS,
                                  digest)

OUT = SMOKE_EVALS


class _Stop(Exception):
    pass


def run_script(name: str, argv) -> list:
    """The JSON lines ``scripts/<name>.py``'s ``main()`` printed."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.argv = [name, *argv]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(buf):
        try:
            mod.main()
        except _Stop:
            pass
    print(f"{name} {' '.join(argv)}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith("{")]


def recognizer(patch) -> dict:
    import kiri_tpu.engine as JE
    import kiri_tpu.ops.preprocess as JP
    import kiri_tpu.pipeline as JPL

    crops, outs = [], []
    resize = JP.resize_keep_ratio_pad_np

    def record(img, h, w):
        crops.append(digest(img))
        return resize(img, h, w)

    class F32OCR(JPL.OCR):
        def __init__(self, *a, **k):
            super().__init__(*a, use_fp16=False, **k)

    call = JE.RecognizerEngine.recognize_batch

    def kept(self, *a, **k):
        res = call(self, *a, **k)
        outs.append([[t, float(c)] for t, c in res])
        return res

    class LinesOnly:
        def __init__(self, *a, **k):
            from kiri_tpu.config import CFG

            self.cfg = CFG()

        @property
        def engine(self):
            raise _Stop

    patch(JP, "resize_keep_ratio_pad_np", record)
    patch(JE.RecognizerEngine, "recognize_batch", kept)
    argv = ["--n", str(EVAL_LINES), "--methods", ",".join(EVAL_METHODS)]
    out = {}
    for key, extra in (("plain", []), ("degrade", ["--degrade",
                                                   "--enhance"])):
        crops.clear()
        outs.clear()
        patch(JPL, "OCR", F32OCR)
        report = run_script("eval_recognizer", argv + extra)[-1]
        assert len(outs) == len(EVAL_METHODS), len(outs)
        out[key] = {"report": report, "crops": list(crops),
                    "outputs": dict(zip(EVAL_METHODS, outs))}
    crops.clear()
    patch(JPL, "OCR", LinesOnly)
    run_script("eval_recognizer", argv + ["--degrade"])
    out["degrade"]["degraded"] = list(crops)
    return out


def detector(patch) -> dict:
    import kiri_tpu.detect as JD

    pages = []

    class Kept(JD.TextDetector):
        def detect_lines_objects(self, img, *a, **k):
            res = super().detect_lines_objects(img, *a, **k)
            pages.append([[float(b.x), float(b.y), float(b.x + b.width),
                           float(b.y + b.height)] for b in res])
            return res

    patch(JD, "TextDetector", Kept)
    summary = run_script("eval_detector", ["--n", str(EVAL_DET_DOCS)])[-1]
    rows = list(summary["report"])
    assert len(pages) == EVAL_DET_DOCS * len(rows)
    return {"summary": summary,
            "boxes": {r: pages[i * EVAL_DET_DOCS:(i + 1) * EVAL_DET_DOCS]
                      for i, r in enumerate(rows)}}


def pipeline(patch) -> dict:
    import kiri_tpu
    import kiri_tpu.pipeline as JPL

    class F32OCR(JPL.OCR):
        def __init__(self, *a, **k):
            super().__init__(*a, use_fp16=False, **k)

    patch(kiri_tpu, "OCR", F32OCR)
    return run_script("eval_pipeline", [
        "--n", str(EVAL_PAGES), "--deskew", "--enhance", "--conditions",
        ",".join(EVAL_CONDITIONS)])[-1]


def recipe(patch) -> dict:
    import kiri_tpu.train.trainer as JT

    kept = {}

    def stub(cfg, tok, tc, train, val, **kw):
        kept.update(train=train, val=val)
        return SimpleNamespace(best_val_acc=0.0)

    patch(JT, "train_loop", stub)
    with tempfile.TemporaryDirectory(prefix="kiri_recipe_") as d:
        run_script("train_recognizer", [*RECIPE_ARGV, "--out-dir", d])
        vocab = (Path(d) / "vocab.json").read_text(encoding="utf-8")
    return {k: [[digest(np.asarray(s["image"])), s["text"]]
                for s in kept[k]] for k in ("train", "val")} | {
        "vocab": vocab}


def main() -> None:
    import cv2
    import jax
    import PIL

    jax.config.update("jax_platforms", "cpu")
    cv2.ipp.setUseIPP(False)
    from kiri_tpu.data import synth

    synth._FONT_DIRS[:] = []
    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    argv = sys.argv
    evals = {"versions": {"Pillow": PIL.__version__, "cv2": cv2.__version__,
                          "numpy": np.__version__}}
    for key, fn in (("recognizer", recognizer), ("detector", detector),
                    ("pipeline", pipeline), ("recipe", recipe)):
        try:
            evals[key] = fn(patch)
        finally:
            for obj, name, value in reversed(saved):
                setattr(obj, name, value)
            saved.clear()
            sys.argv = argv
    out = {"evals": np.asarray(json.dumps(evals, ensure_ascii=False))}
    if OUT.exists():
        with np.load(OUT) as old:
            if str(old["evals"]) != str(out["evals"]):
                sys.exit(f"{OUT}: the fixture would change; delete the file "
                         "first to regenerate it")
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
