"""The port's line generators (kiri_tpu_torch/data/synth.py) against
kiri_tpu's on the CPU with the same seeds: the files each writes (PNG
pixels and ``labels.txt`` byte for byte) and the samples it returns, with
the pseudo-glyph pool only (``font_dirs=[]``, the machine with the card)
and with the default manager, whose system TTFs both draw through Pillow.
Without Pillow the port leaves the system's TTFs out and refuses fonts it
is given; with neither Pillow nor cv2 importable it still generates
kiri_tpu's pseudo-pool lines and documents."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from kiri_tpu.data import synth as J
from kiri_tpu_torch.data import synth as T

REPO = Path(__file__).resolve().parent.parent
MANAGERS = ["pseudo", "default"]


def _fonts(mod, kind, **kw):
    return mod.FontManager(font_dirs=[] if kind == "pseudo" else None, **kw)


def _same_tree(a: Path, b: Path) -> None:
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files and files == sorted(p.relative_to(b) for p in b.rglob("*")
                                     if p.is_file())
    for rel in files:
        if rel.suffix == ".png":
            assert np.array_equal(np.asarray(Image.open(a / rel)),
                                  np.asarray(Image.open(b / rel))), rel
        else:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


def _both(tmp_path, kind, cls="MultilingualDatasetGenerator", fm_kw=None,
          **kw):
    out = []
    for name, mod in (("j", J), ("t", T)):
        fonts = _fonts(mod, kind, **(fm_kw or {}))
        out.append(getattr(mod, cls)(str(tmp_path / name), fonts=fonts, **kw))
    return out


def test_font_managers_agree():
    for kind in MANAGERS:
        a, b = _fonts(J, kind), _fonts(T, kind)
        assert (a.font_paths, a.english_fonts, a.khmer_fonts) == \
            (b.font_paths, b.english_fonts, b.khmer_fonts)


@pytest.mark.parametrize("kind", MANAGERS)
def test_generate_dataset_and_append(tmp_path, kind):
    jg, tg = _both(tmp_path, kind, khmer_ratio=0.5, sign_boost=0.3, seed=42)
    for g in (jg, tg):
        g.generate_dataset(24)
        g.generate_dataset(8, append=True)
        g.generate_dataset(3, texts=["ក្ខ abc", "hello"], append=True)
    _same_tree(tmp_path / "j", tmp_path / "t")
    assert len((tmp_path / "t" / "labels.txt").read_text().splitlines()) == 35


@pytest.mark.parametrize("kind", MANAGERS)
@pytest.mark.parametrize("font_mode", ["random", "all"])
def test_generate_from_files(tmp_path, kind, font_mode):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(["hello world", "ភាសាខ្មែរ", "  ", "abc 123",
                                 "កម្ពុជា x", "the end"]), encoding="utf-8")
    val = tmp_path / "val.txt"
    val.write_text("val line\nក ខ\n", encoding="utf-8")
    for vfile in (None, val):
        sub = tmp_path / f"{font_mode}_{vfile is not None}"
        jg, tg = _both(sub, kind, cls="DatasetGenerator", seed=3,
                       max_width=150)
        for g in (jg, tg):
            g.generate_from_files(str(corpus), val_file=vfile and str(vfile),
                                  train_augment=2, font_mode=font_mode,
                                  random_augment=True)
        _same_tree(sub / "j", sub / "t")


@pytest.mark.parametrize("kind", MANAGERS)
def test_generate_samples_and_cap_width(tmp_path, kind):
    jg, tg = _both(tmp_path, kind, khmer_ratio=0.4, seed=9, height=32,
                   augment=False, max_width=200)
    want = jg.generate_samples(12, max_width=180, max_words=20)
    got = tg.generate_samples(12, max_width=180, max_words=20)
    assert [s["text"] for s in got] == [s["text"] for s in want]
    for a, b in zip(got, want):
        assert np.array_equal(a["image"], b["image"])
    img = np.random.default_rng(0).integers(0, 256, (32, 517), np.uint8)
    assert np.array_equal(tg._cap_width(img), jg._cap_width(img))
    fixed = ["a", "ក្ខ"]
    a = tg.generate_samples(3, texts=fixed)
    b = jg.generate_samples(3, texts=fixed)
    assert [s["text"] for s in a] == [s["text"] for s in b]


def test_an_unlisted_size_renders(tmp_path):
    jg, tg = _both(tmp_path, "pseudo", fm_kw={"sizes": (20,)},
                   khmer_ratio=1.0, seed=1)
    for g in (jg, tg):
        g.generate_dataset(6)
    _same_tree(tmp_path / "j", tmp_path / "t")


def test_without_pillow(tmp_path, monkeypatch):
    """The system's TTFs are left out with a warning; fonts named by the
    caller raise, naming Pillow."""
    monkeypatch.setattr(T, "pillow_modules", lambda: None)
    font = tmp_path / "fonts" / "a.ttf"
    font.parent.mkdir()
    font.write_bytes(b"")
    monkeypatch.setattr(T, "_FONT_DIRS", [str(font.parent)])
    with pytest.warns(UserWarning, match="1 TrueType font.*left out"):
        fm = T.FontManager()
    assert fm.font_paths == fm.khmer_fonts == T.pseudo_font_paths()
    with pytest.raises(RuntimeError, match="Pillow"):
        T.FontManager(font_dirs=[str(font.parent)])
    with pytest.raises(RuntimeError, match="Pillow"):
        T.DatasetGenerator(str(tmp_path), fonts_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="Pillow"):
        fm.get(str(tmp_path / "some.ttf"), 20)


_BLOCKED = r'''
import sys
sys.modules["PIL"] = None
sys.modules["cv2"] = None
import numpy as np
from kiri_tpu_torch.data import docsynth, synth
fm = synth.FontManager(font_dirs=[])
g = synth.MultilingualDatasetGenerator(sys.argv[1], fonts=fm, seed=42,
                                       khmer_ratio=0.5)
g.generate_dataset(6)
doc = docsynth.DocumentGenerator(
    320, 320, fonts=synth.FontManager(font_dirs=[], sizes=(18, 22, 26)),
    khmer_ratio=0.4).generate()
doc = docsynth.apply_condition(doc, "rotated", __import__("random").Random(1))
np.save(sys.argv[1] + "/doc.npy", doc["image"])
assert not [m for m in sys.modules if m.split(".")[0] in ("PIL", "cv2")
            and sys.modules[m] is not None]
'''


def test_generators_run_without_pillow_and_cv2(tmp_path):
    import random

    from kiri_tpu.data import docsynth as JD

    out = tmp_path / "t"
    out.mkdir()
    proc = subprocess.run([sys.executable, "-c", _BLOCKED, str(out)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    jg = J.MultilingualDatasetGenerator(str(tmp_path / "j"), seed=42,
                                        fonts=J.FontManager(font_dirs=[]),
                                        khmer_ratio=0.5)
    jg.generate_dataset(6)
    doc = np.load(out / "doc.npy")
    (out / "doc.npy").unlink()
    _same_tree(tmp_path / "j", out)
    want = JD.DocumentGenerator(
        320, 320, fonts=J.FontManager(font_dirs=[], sizes=(18, 22, 26)),
        khmer_ratio=0.4).generate()
    want = JD.apply_condition(want, "rotated", random.Random(1))
    assert np.array_equal(doc, want["image"])
