"""The port's document generator (kiri_tpu_torch/data/docsynth.py), the
detectors' live batches and ``evalpage.eval_condition`` against kiri_tpu's
on the CPU with the same seeds, byte for byte: every layout under every
condition and a chain, ``rescale_doc``, a whole ``generate_detector_dataset``
directory, DB's and CRAFT's ``make_batch`` (conditions, weights, CRAFT's
small-scale documents), and ``eval_condition``'s rows at float32 on two
small pages."""
from __future__ import annotations

import json
import random

import numpy as np
import pytest
from PIL import Image
from torch_pages import DET, cv2_without_ipp, small_ckpt  # noqa: F401

from kiri_tpu.data import docsynth as JD
from kiri_tpu.data import synth as JS
from kiri_tpu_torch.data import docsynth as D
from kiri_tpu_torch.data import synth as TS

SIZES = (18, 22, 26, 30, 34)


def _gens(kind="pseudo", size=320, **kw):
    dirs = [] if kind == "pseudo" else None
    return (JD.DocumentGenerator(size, size, fonts=JS.FontManager(
                font_dirs=dirs, sizes=SIZES), **kw),
            D.DocumentGenerator(size, size, fonts=TS.FontManager(
                font_dirs=dirs, sizes=SIZES), **kw))


def _same_doc(a, b):
    assert np.array_equal(a["image"], b["image"])
    for k in ("lines", "texts", "chars", "layout", "condition"):
        assert a.get(k) == b.get(k), k


@pytest.mark.parametrize("kind", ["pseudo", "default"])
@pytest.mark.parametrize("layout", JD.LAYOUTS)
def test_layouts_conditions_and_rescale(kind, layout):
    jg, tg = _gens(kind, 320, seed=11, khmer_ratio=0.4)
    a, b = jg.generate(layout), tg.generate(layout)
    _same_doc(a, b)
    assert a["lines"]
    for cond in (*JD.CONDITIONS, "rotated+noisy", "textured+low_contrast"):
        ra, rb = random.Random(len(cond)), random.Random(len(cond))
        x, y = a, b
        for c in cond.split("+"):
            x, y = JD.apply_condition(x, c, ra), D.apply_condition(y, c, rb)
        _same_doc(x, y)
    for h, w in ((480, 480), (213, 301), (320, 320)):
        _same_doc(JD.rescale_doc(a, h, w), D.rescale_doc(b, h, w))
    with pytest.raises(ValueError):
        D.apply_condition(b, "blurry", random.Random(0))


def test_texts_and_unaugmented():
    corpus = ["ភាសាខ្មែរ", "a line of text", "x"]
    jg, tg = _gens("pseudo", 256, seed=4, texts=corpus, augment=False)
    for _ in range(3):
        _same_doc(jg.generate(), tg.generate())


def test_generate_detector_dataset(tmp_path):
    kw = dict(width=192, height=160, seed=5, kind="both", khmer_ratio=0.5,
              min_lines=3, max_lines=8)
    JD.generate_detector_dataset(str(tmp_path / "j"), 3, **kw)
    D.generate_detector_dataset(str(tmp_path / "t"), 3, **kw)
    ann = (tmp_path / "t" / "annotations.json").read_text()
    assert ann == (tmp_path / "j" / "annotations.json").read_text()
    assert len(json.loads(ann)) == 3
    for p in sorted((tmp_path / "j").rglob("*.*")):
        q = tmp_path / "t" / p.relative_to(tmp_path / "j")
        if p.suffix == ".png":
            assert np.array_equal(np.asarray(Image.open(p)),
                                  np.asarray(Image.open(q)))
        elif p.suffix == ".npy":
            assert np.array_equal(np.load(p), np.load(q))
    for kind in ("db", "craft"):
        D.generate_detector_dataset(str(tmp_path / kind), 1, width=96,
                                    height=96, kind=kind)
        names = {p.name.split(".", 2)[-1] for p in (tmp_path / kind / "gt")
                 .iterdir()}
        assert names == ({"db_prob.npy", "db_thresh.npy", "db_tmask.npy"}
                         if kind == "db" else {"region.npy", "affinity.npy"})


def _same_batch(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_db_make_batch():
    from kiri_tpu.detect.db.train import make_batch as jmake
    from kiri_tpu.detect.db.train import pick_condition as jpick
    from kiri_tpu_torch.detect.db.train import make_batch, pick_condition

    jg, tg = _gens("default", 160, seed=8, khmer_ratio=0.3)
    for aug, weights in ((0.0, None), (0.7, None), (1.0, {"rotated": 3.0})):
        _same_batch(make_batch(tg, 3, 160, aug, weights),
                    jmake(jg, 3, 160, aug, weights))
    ra, rb = random.Random(2), random.Random(2)
    assert [pick_condition(ra, {"noisy": 5}) for _ in range(20)] == \
        [jpick(rb, {"noisy": 5}) for _ in range(20)]


def test_craft_make_batch():
    from kiri_tpu.detect.craft.train import make_batch as jmake
    from kiri_tpu_torch.detect.craft.train import (CRAFTTrainConfig,
                                                   make_batch,
                                                   scale_generators)

    size = 224
    jg, tg = _gens("default", size, seed=8, khmer_ratio=0.3)
    tc = CRAFTTrainConfig(image_size=size, seed=8, khmer_ratio=0.3,
                          scale_aug=0.6)
    tsmall = scale_generators(tc, tg)
    jsmall = [JD.DocumentGenerator(round(size / f), round(size / f),
                                   seed=8 + 17 * i, fonts=jg.fonts,
                                   khmer_ratio=0.3)
              for i, f in enumerate(tc.scale_aug_factors, 1)]
    assert [g.width for g in tsmall] == [g.width for g in jsmall]
    for _ in range(2):
        _same_batch(make_batch(tg, 3, size, 0.5, None, 0.6, tsmall),
                    jmake(jg, 3, size, 0.5, None, 0.6, jsmall))


def test_eval_condition_rows(small_ckpt):
    """Two 320 px pages per condition through kiri_tpu's OCR and the
    port's on the CPU at float32 (DB and the small recognizer): the rows
    are equal."""
    from torch_pages import ocr_pair

    from kiri_tpu import evalpage as JE
    from kiri_tpu_torch import evalpage as E

    jocr, ocr = ocr_pair(small_ckpt)
    for cond in ("clean", "rotated+noisy"):
        want = JE.eval_condition(jocr, cond, 2, page=320)
        got = E.eval_condition(ocr, cond, 2, page=320)
        assert got == want
        assert got["docs"] == 2 and got["gt_lines"] > 0
    assert E.eval_condition(ocr, "clean", 3, page=320,
                            deadline=0.0)["docs"] == 1
