"""The generators fixture (kiri_tpu_torch/assets/smoke_gen.npz, made with
kiri_tpu by scripts/make_torch_smoke_gen.py) is what the port generates on
the CPU, as chip_smoke.py's generators phase checks on the card: the lines,
the documents under every condition, the generate-detector and generate
directories and the trainers' live batches, all with font discovery off."""
from __future__ import annotations

import hashlib
import random

import numpy as np
import pytest

from kiri_tpu_torch import cli
from kiri_tpu_torch.data import docsynth as D
from kiri_tpu_torch.data import synth as S
from kiri_tpu_torch.smoke import (GEN_AUG, GEN_BATCH, GEN_CHAIN,
                                  GEN_DOC_SIZE, GEN_DOC_SIZES, GEN_GENERATE,
                                  GEN_LINES, GEN_POOL, GEN_RESCALE,
                                  GEN_SCALE_AUG, GEN_SEED, cond_seed, digest,
                                  load_smoke_gen, tree_digests)
from kiri_tpu_torch.utils.imageio import imread_gray


@pytest.fixture(scope="module")
def fx():
    return load_smoke_gen()


@pytest.fixture()
def no_discovery(monkeypatch):
    monkeypatch.setattr(S, "_FONT_DIRS", [])


def test_lines(fx, tmp_path):
    gen = S.MultilingualDatasetGenerator(
        str(tmp_path), khmer_ratio=0.5, sign_boost=0.3, seed=GEN_SEED,
        fonts=S.FontManager(font_dirs=[]))
    gen.generate_dataset(GEN_LINES)
    labels = (tmp_path / "labels.txt").read_text(encoding="utf-8")
    assert labels == fx["lines_labels"]
    imgs = [imread_gray(tmp_path / "images" / row.split("\t")[0])
            for row in labels.splitlines()]
    assert [digest(i) for i in imgs] == fx["lines_digests"]
    assert np.array_equal(imgs[0], fx["lines_first"])


def test_documents(fx):
    dg = D.DocumentGenerator(GEN_DOC_SIZE, GEN_DOC_SIZE, khmer_ratio=0.4,
                             fonts=S.FontManager(font_dirs=[],
                                                 sizes=GEN_DOC_SIZES))
    docs = fx["docs"]

    def same(key, d):
        want = docs[key]
        assert digest(d["image"]) == want["digest"], key
        assert [[list(b) for b in d["lines"]], d["texts"],
                [[list(b) for b in r] for r in d["chars"]]] == \
            [want["lines"], want["texts"], want["chars"]], key

    for layout in D.LAYOUTS:
        doc = dg.generate(layout)
        same(layout, doc)
        for cond in (*D.CONDITIONS, GEN_CHAIN):
            rng = random.Random(cond_seed(layout, cond))
            d = doc
            for c in cond.split("+"):
                d = D.apply_condition(d, c, rng)
            same(f"{layout}/{cond}", d)
            if layout == D.LAYOUTS[0] and cond == "rotated":
                assert np.array_equal(d["image"], fx["doc_first_rotated"])
        if layout == D.LAYOUTS[0]:
            assert np.array_equal(doc["image"], fx["doc_first"])
            same("rescale", D.rescale_doc(doc, GEN_RESCALE, GEN_RESCALE))


def test_command_line_directories(fx, tmp_path, no_discovery):
    assert cli.main(["generate-detector", "--num-train", "8", "--num-val",
                     "2", "--kind", "both", "--output",
                     str(tmp_path / "det")]) == 0
    assert tree_digests(tmp_path / "det") == fx["detector_files"]
    assert cli.main(["generate", "-n", str(GEN_GENERATE), "-o",
                     str(tmp_path / "gen")]) == 0
    files = tree_digests(tmp_path / "gen")
    assert (tmp_path / "gen" / "labels.txt").read_text(
        encoding="utf-8") == fx["generate_labels"]
    assert hashlib.sha256("".join(
        v for k, v in files.items() if k.endswith(".png"))
        .encode()).hexdigest() == fx["generate_digest"]


@pytest.mark.parametrize("kind", ["db", "craft"])
def test_live_batches(fx, kind, no_discovery):
    from kiri_tpu_torch.detect.craft.train import (CRAFTTrainConfig,
                                                   scale_generators)
    from kiri_tpu_torch.detect.craft.train import make_batch as craft_batch
    from kiri_tpu_torch.detect.db.train import make_batch as db_batch

    gen = D.DocumentGenerator(GEN_DOC_SIZE, GEN_DOC_SIZE, seed=GEN_SEED,
                              khmer_ratio=0.3)
    small = scale_generators(CRAFTTrainConfig(
        image_size=GEN_DOC_SIZE, seed=GEN_SEED, khmer_ratio=0.3,
        scale_aug=GEN_SCALE_AUG), gen)
    got = []
    for _ in range(GEN_POOL // GEN_BATCH):
        b = (db_batch(gen, GEN_BATCH, GEN_DOC_SIZE, GEN_AUG) if kind == "db"
             else craft_batch(gen, GEN_BATCH, GEN_DOC_SIZE, GEN_AUG, None,
                              GEN_SCALE_AUG, small))
        got.append({k: digest(v) for k, v in b.items()})
    assert got == fx[f"{kind}_batches"]
