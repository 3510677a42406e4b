"""The frozen copies give what the program's own generators and host code
give, with the same seeds (the program's font pool emptied to the
pseudo-glyph one, as on the card), and the pools hold the mixes' fixed
sizes."""
import random

import numpy as np
import pytest

from traffic import docsynth, imgproc, make, preprocess, synth


@pytest.fixture
def program_synth(monkeypatch):
    from kiri_tpu_torch.data import synth as prog

    monkeypatch.setattr(prog, "_FONT_DIRS", [])
    return prog


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 99])
def test_lines_equal_the_program_generator(program_synth, tmp_path, seed):
    texts = [synth.sample_text(random.Random(seed), 2, 8),
             synth.sample_khmer_text(random.Random(seed + 1), 2, 6)]
    ours = synth.DatasetGenerator(48, False, seed).generate_samples(texts)
    theirs = program_synth.DatasetGenerator(
        str(tmp_path), height=48, augment=False, seed=seed
    ).generate_samples(len(texts), texts=texts)
    for a, b in zip(ours, theirs):
        assert a["text"] == b["text"]
        assert np.array_equal(a["image"], b["image"])


@pytest.mark.parametrize("layout", ["two_column", "dense"])
def test_pages_equal_the_program_generator(program_synth, layout):
    from kiri_tpu_torch.data import docsynth as prog

    ours = docsynth.DocumentGenerator(
        960, 640, fonts=synth.FontManager(sizes=docsynth.DOC_FONT_SIZES),
        seed=77, khmer_ratio=0.4).generate(layout)
    theirs = prog.DocumentGenerator(
        960, 640, fonts=program_synth.FontManager(
            font_dirs=[], sizes=prog.DOC_FONT_SIZES),
        seed=77, khmer_ratio=0.4).generate(layout)
    assert ours["texts"] == theirs["texts"]
    assert np.array_equal(ours["image"], theirs["image"])


@pytest.mark.parametrize("interp", ["linear", "cubic", "area"])
def test_resizes_equal_the_program(interp):
    from kiri_tpu_torch.ops import imgproc as prog
    from kiri_tpu_torch.ops import preprocess as prog_pre

    img = np.random.default_rng(5).integers(0, 256, (37, 211), np.uint8)
    for w, h in ((100, 48), (301, 48), (211, 74)):
        if interp == "area" and (w > 211 or h > 37):
            continue
        assert np.array_equal(imgproc.resize_u8(img, w, h, interp),
                              prog.resize_u8(img, w, h, interp))
    assert np.array_equal(preprocess.resize_keep_ratio_pad_np(img, 48, 640),
                          prog_pre.resize_keep_ratio_pad_np(img, 48, 640))


def test_line_pool_holds_the_quotas():
    cfg = {"IMG_H": 48, "IMG_W": 640, "WIDTH_BUCKETS": [160, 320, 480, 640]}
    mix = dict(make.load_mix("lines-fast"),
               quota={"english": {"160": 2, "480": 1},
                      "khmer": {"320": 2}})
    from harness import spec

    pool = make.lines(mix, 2 ** 31 + 5, cfg, spec.ROOT / "models/vocab.json")
    buckets = sorted(preprocess.width_bucket(cfg, int(w))
                     for w in pool["widths"])
    assert buckets == [160, 160, 320, 320, 480]
    assert pool["imgs"].shape == (5, 48, 640)


def test_page_pool_holds_the_sizes_and_layouts():
    mix = dict(make.load_mix("pages-batch"), sizes=[[640, 960], [960, 640]],
               layouts=["sparse", "dense"])
    pool = make.pages(mix, 2 ** 31 + 6)
    assert sorted(pool["sizes"]) == [(640, 960), (960, 640)]
    assert sorted(p.shape for p in pool["pages"]) == [(640, 960), (960, 640)]


def _sizes(pool, cfg, lo, hi):
    return sorted([s, preprocess.width_bucket(cfg, int(w)), len(t)]
                  for s, w, t in zip(pool["scripts"][lo:hi],
                                     pool["widths"][lo:hi],
                                     pool["texts"][lo:hi]))


def test_sized_lines_hold_their_sizes_on_every_seed():
    cfg = {"IMG_H": 48, "IMG_W": 640, "WIDTH_BUCKETS": [160, 320, 480, 640]}
    plan = [[["english", 160, 7], ["khmer", 320, 17], ["english", 480, 22]],
            [["khmer", 160, 9], ["english", 320, 12], ["khmer", 640, 40]]]
    mix = dict(make.load_mix("lines-accurate"), sizes=plan, batch=3)
    from harness import spec

    pools = [make.make(mix, seed, cfg, spec.ROOT / "models/vocab.json")
             for seed in (2 ** 31 + 7, 2 ** 31 + 8)]
    for pool in pools:
        assert pool["imgs"].shape == (6, 48, 640)
        for k, call in enumerate(plan):
            assert _sizes(pool, cfg, 3 * k, 3 * k + 3) == sorted(call)
    assert pools[0]["texts"] != pools[1]["texts"]
    again = make.make(mix, 2 ** 31 + 7, cfg, spec.ROOT / "models/vocab.json")
    assert np.array_equal(again["imgs"], pools[0]["imgs"])


def test_accurate_sizes_are_the_plan_of_their_seed():
    from harness import spec
    from harness.cell import model_cfg

    cell = spec.load_cell("lines-accurate")
    cfg, mix = model_cfg(cell), cell["mix"]
    quota_mix = {k: v for k, v in mix.items() if k != "sizes"}
    pool = make.make(quota_mix, mix["sizes_seed"], cfg,
                     spec.ROOT / cell["config"]["vocab"])
    assert make.size_plan(pool, cfg, mix["batch"]) == mix["sizes"]
    assert all(len(c) == mix["batch"] for c in mix["sizes"])
    assert sum(len(c) for c in mix["sizes"]) == sum(
        n for per in mix["quota"].values() for n in per.values())
