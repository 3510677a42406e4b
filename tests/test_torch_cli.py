"""The port's command line (kiri_tpu_torch/cli.py), renderer and PNG
reader/writer against kiri_tpu's and cv2 on the CPU:

- ``predict``'s flags, choices and defaults equal kiri_tpu's (``--device``
  is the card by default);
- ``predict --device cpu`` with the small random recognizer and the
  classic-CV detector writes kiri_tpu's ``ocr_results.json`` (confidences
  within 1e-4) and ``extracted_text.txt``, and images equal kiri_tpu's pixel
  for pixel; the report is kiri_tpu's apart from the embedded PNG, which
  decodes to the same pixels;
- the port exits 1 on an error where kiri_tpu prints it and exits 0
  (ROADMAP queue 3), and fails before any OCR work when rendering is asked
  for without Pillow;
- ``--version``, ``init-config``, the implicit ``predict``, the
  generators' commands (their output is kiri_tpu's) and the training
  commands without their data;
- the PNG reader gives ``cv2.imread``'s bytes for every colour type."""
from __future__ import annotations

import argparse
import base64
import json
import re
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
from test_torch_decoder_layers import few_torch_threads  # noqa: F401
from torch_pages import (REPO, cv2_without_ipp, same_dicts,  # noqa: F401
                         small_ckpt, smoke_pages)

from kiri_tpu import cli as jcli
from kiri_tpu_torch import cli as tcli


def _options(parser: argparse.ArgumentParser, command: str):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    out = {}
    for a in sub.choices[command]._actions:
        if a.dest == "help":
            continue
        out[a.dest] = (tuple(a.option_strings), a.choices, a.default,
                       a.nargs, a.type)
    return out


def test_predict_flags_match_kiri_tpu():
    ours = _options(tcli._build_parser(), "predict")
    ref = _options(jcli._build_parser(), "predict")
    assert sorted(ours) == sorted(ref)
    for dest in ref:
        if dest == "device":
            continue
        assert ours[dest] == ref[dest], dest
    assert ours["device"][2] == "cuda" and ref["device"][2] == "tpu"
    assert (_options(tcli._build_parser(), "init-config")
            == _options(jcli._build_parser(), "init-config"))


@pytest.fixture(scope="module")
def page_png(smoke_pages, tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "page.png"
    cv2.imwrite(str(path), smoke_pages["legacy"]["color_page"])
    return path


def _run_both(tmp_path, pages, small_ckpt, *extra):
    args = [*map(str, pages), "--model", small_ckpt, "--det-method",
            "legacy", "--decode-method", "fast", "--device", "cpu", *extra]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jcli.main(["predict", *args, "-o", str(jdir)])
    assert tcli.main(["predict", *args, "-o", str(tdir)]) == 0
    return jdir, tdir


def _same_outputs(jdir: Path, tdir: Path) -> None:
    same_dicts(json.loads((tdir / "ocr_results.json").read_text()),
               json.loads((jdir / "ocr_results.json").read_text()))
    assert ((tdir / "extracted_text.txt").read_text()
            == (jdir / "extracted_text.txt").read_text())


def test_predict_words_writes_kiri_tpus_files(tmp_path, page_png, small_ckpt):
    jdir, tdir = _run_both(tmp_path, [page_png], small_ckpt, "--mode",
                           "words", "--no-render")
    _same_outputs(jdir, tdir)
    assert not (tdir / "report.html").exists()


def test_predict_renders_kiri_tpus_images_and_report(tmp_path, page_png,
                                                     small_ckpt):
    jdir, tdir = _run_both(tmp_path, [page_png], small_ckpt)
    _same_outputs(jdir, tdir)
    for name in ("boxes.png", "ocr_result.png"):
        assert np.array_equal(cv2.imread(str(tdir / name)),
                              cv2.imread(str(jdir / name))), name
    pattern = re.compile(r'data:image/png;base64,([A-Za-z0-9+/=]+)"')
    ours = (tdir / "report.html").read_text()
    ref = (jdir / "report.html").read_text()
    assert pattern.sub("", ours) == pattern.sub("", ref)
    pngs = []
    for html, d in ((ours, tdir), (ref, jdir)):
        (d / "embedded.png").write_bytes(
            base64.b64decode(pattern.search(html).group(1)))
        pngs.append(cv2.imread(str(d / "embedded.png")))
    assert np.array_equal(pngs[0], pngs[1])
    assert np.array_equal(pngs[0], cv2.imread(str(page_png)))


def test_two_pages_and_the_stream(tmp_path, page_png, small_ckpt,
                                  smoke_pages, capsys):
    second = tmp_path / "second.png"
    cv2.imwrite(str(second), smoke_pages["pages"][4]["image"])
    jdir, tdir = _run_both(tmp_path, [page_png, second], small_ckpt,
                           "--no-render")
    for stem in ("page", "second"):
        _same_outputs(jdir / stem, tdir / stem)
    jdir, tdir = _run_both(tmp_path / "stream", [page_png], small_ckpt,
                           "--stream", "--no-render")
    assert ((tdir / "extracted_text.txt").read_text()
            == (jdir / "extracted_text.txt").read_text())
    assert "(streaming)" in capsys.readouterr().out


def test_errors_exit_1_where_kiri_tpu_exits_0(tmp_path, page_png, capsys):
    args = ["predict", str(page_png), "--model", str(tmp_path / "none"),
            "--det-method", "legacy", "--device", "cpu", "--no-render", "-o",
            str(tmp_path / "o")]
    assert jcli.main(args) is None
    assert "Error" in capsys.readouterr().out
    assert tcli.main(args) == 1
    assert "Error" in capsys.readouterr().err
    tpu = ["predict", str(page_png), "--det-method", "legacy", "--device",
           "tpu", "--no-render", "-o", str(tmp_path / "o")]
    assert tcli.main(tpu) == 1
    assert "CUDA" in capsys.readouterr().err


def test_missing_pillow_fails_before_any_ocr(tmp_path, page_png, small_ckpt,
                                             monkeypatch, capsys):
    import importlib

    import kiri_tpu_torch.pipeline as pipeline

    real = importlib.import_module

    def no_pil(name, *a, **k):
        if name.startswith("PIL"):
            raise ImportError(name)
        return real(name, *a, **k)

    def no_ocr(*a, **k):
        raise AssertionError("OCR was built")

    monkeypatch.setattr(importlib, "import_module", no_pil)
    monkeypatch.setattr(pipeline, "OCR", no_ocr)
    args = ["predict", str(page_png), "--model", small_ckpt, "--det-method",
            "legacy", "--device", "cpu", "-o", str(tmp_path / "o")]
    assert tcli.main(args) == 1
    assert "--no-render" in capsys.readouterr().err
    from kiri_tpu_torch.renderer import DocumentRenderer

    with pytest.raises(RuntimeError, match="--no-render"):
        DocumentRenderer().draw_boxes(str(page_png), [])
    monkeypatch.undo()
    assert tcli.main([*args, "--no-render"]) == 0


def test_version_init_config_and_not_ported_commands(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--version"])
    assert e.value.code == 0
    assert "kiri-tpu-torch" in capsys.readouterr().out
    jcfg, tcfg = tmp_path / "j.yaml", tmp_path / "t.yaml"
    jcli.main(["init-config", "-o", str(jcfg)])
    assert tcli.main(["init-config", "-o", str(tcfg)]) == 0
    assert tcfg.read_text() == jcfg.read_text()
    # The generators run and write kiri_tpu's files.
    for cmd, flags in (("generate", ["-n", "3", "--khmer-ratio", "0.5"]),
                       ("generate-detector", ["--num-train", "1",
                                              "--num-val", "1",
                                              "--image-size", "96"])):
        out = {}
        for name, main in (("j", jcli.main), ("t", tcli.main)):
            out[name] = tmp_path / f"{cmd}_{name}"
            opt = "-o" if cmd == "generate" else "--output"
            assert main([cmd, *flags, opt, str(out[name])]) in (0, None)
        _same_tree(out["j"], out["t"])
    # Training without its data runs and fails naming what is missing.
    for cmd, flag, want in (("train", [], "--train-labels"),
                            ("train-detector",
                             ["--data-yaml", str(tmp_path / "none")],
                             "annotations.json")):
        assert tcli.main([cmd, *flag, "--epochs", "1", "--device",
                          "cpu"]) == 1
        assert want in capsys.readouterr().err
    proc = subprocess.run([sys.executable, "-m", "kiri_tpu_torch.cli",
                           "--version"], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and "kiri-tpu-torch" in proc.stdout


def _same_tree(a: Path, b: Path) -> None:
    """Two generated directories: the same files, PNGs of the same pixels,
    every other file byte for byte."""
    from PIL import Image

    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*")
                           if p.is_file())
    assert files
    for rel in files:
        if rel.suffix == ".png":
            assert np.array_equal(np.asarray(Image.open(a / rel)),
                                  np.asarray(Image.open(b / rel))), rel
        else:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


def test_bare_image_means_predict(tmp_path, page_png, small_ckpt):
    out = tmp_path / "bare"
    assert tcli.main([str(page_png), "--model", small_ckpt, "--det-method",
                      "legacy", "--device", "cpu", "--no-render", "-o",
                      str(out)]) == 0
    assert (out / "ocr_results.json").exists()


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "1", "P4"])
def test_png_reader_matches_cv2_imread(tmp_path, mode):
    from PIL import Image

    from kiri_tpu_torch.utils.imageio import encode_png, imread_bgr

    rng = np.random.default_rng(0)
    base = (rng.random((37, 53, 4)) * 255).astype(np.uint8)
    base[:20] = base[:20] // 16 * 16   # long runs: every filter is chosen
    path = tmp_path / "t.png"
    for opt in ({}, {"optimize": True}, {"compress_level": 9}):
        if mode == "P4":
            Image.fromarray(base[..., :3]).quantize(16).save(path, bits=4)
        elif mode == "P":
            Image.fromarray(base[..., :3]).quantize(50).save(path, **opt)
        else:
            Image.fromarray(base).convert(mode).save(path, **opt)
        assert np.array_equal(imread_bgr(path), cv2.imread(str(path)))
    for img in (base[..., 0], base[..., :3], base):
        path.write_bytes(encode_png(img))
        assert np.array_equal(cv2.imread(str(path), cv2.IMREAD_UNCHANGED),
                              img)


def test_khmer_overlay_without_a_khmer_font(tmp_path):
    """Khmer overlay text goes through the generators' first Khmer-capable
    font, the procedural pseudo-glyphs where no system font draws Khmer, in
    both packages: the overlay images are equal pixel for pixel; Latin text
    uses the own font in both."""
    from PIL import Image

    from kiri_tpu.renderer import DocumentRenderer as JRenderer
    from kiri_tpu_torch.renderer import DocumentRenderer

    ours, ref = DocumentRenderer(), JRenderer()
    assert ours._font_for("abc").getname() == ref._font_for("abc").getname()
    assert (type(ours._font_for("ក")).__name__
            == type(ref._font_for("ក")).__name__)
    page = np.full((60, 200), 255, np.uint8)
    Image.fromarray(page).save(tmp_path / "page.png")
    results = [{"box": [5, 5, 150, 24], "text": "កម្ពុជា abc",
                "confidence": 0.95},
               {"box": [5, 32, 150, 24], "text": "ភាសាខ្មែរ",
                "confidence": 0.5}]
    imgs = []
    for name, r in (("j", ref), ("t", ours)):
        out = tmp_path / f"{name}.png"
        r.draw_results(str(tmp_path / "page.png"), results, str(out))
        imgs.append(np.asarray(Image.open(out)))
    assert np.array_equal(*imgs)
    assert (imgs[0][:, 210:] < 128).any()
