"""Training data of the port against kiri_tpu's: Pillow's bilinear width
resize and grey conversion done in numpy, the labels.txt loader with its
augmentation, the vocab builder, and the Khmer labels' canonical form
(ROADMAP.md queue 3: a recorded difference)."""
from __future__ import annotations

import json

import numpy as np
import pytest
from PIL import Image

from kiri_tpu.data.datasets import load_local_dataset as jload
from kiri_tpu.tokenizer import build_vocab_from_texts as jbuild
from kiri_tpu_torch.config import CFG
from kiri_tpu_torch.data.datasets import LineSampleSet, load_local_dataset
from kiri_tpu_torch.ops.imgproc import pil_gray, pil_resize_width_bilinear
from kiri_tpu_torch.tokenizer import CharTokenizer, build_vocab_from_texts
from kiri_tpu_torch.train.trainer import canonical_samples, collate
from kiri_tpu_torch.utils.imageio import imread_gray

from torch_train import write_vocab

# ADVICE.md's two sequences that visual order does not give back as they
# were: a vowel after a sign, and a vowel after an above vowel.
NON_CANONICAL = ["បំេ", "កឹេ"]
CANONICAL = "បេំ កេឹ ក្រែ"


@pytest.fixture(autouse=True)
def cv2_without_ipp():
    import cv2

    before = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(before)


@pytest.mark.parametrize("seed", range(6))
def test_pil_bilinear_width_resize_is_pillows(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        h, w = int(rng.integers(1, 50)), int(rng.integers(1, 500))
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        if seed % 2:
            img = img // 85 * 85                 # flat runs and hard edges
        nw = max(1, int(w * rng.uniform(0.2, 2.5)))
        want = np.asarray(Image.fromarray(img).resize((nw, h),
                                                      Image.BILINEAR))
        np.testing.assert_array_equal(pil_resize_width_bilinear(img, nw),
                                      want)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "1"])
def test_gray_reads_as_pillow_converts(tmp_path, mode):
    rng = np.random.default_rng(1)
    base = rng.integers(0, 256, (23, 41, 4), dtype=np.uint8)
    path = tmp_path / "x.png"
    im = Image.fromarray(base)
    im = im.convert("RGB").quantize(40) if mode == "P" else im.convert(mode)
    im.save(path)
    want = np.asarray(Image.open(path).convert("L"))
    np.testing.assert_array_equal(imread_gray(path), want)
    rgb = base[..., :3]
    np.testing.assert_array_equal(pil_gray(rgb), np.asarray(
        Image.fromarray(rgb).convert("L")))


def _line_dir(tmp_path, rgb: bool):
    rng = np.random.default_rng(3)
    (tmp_path / "images").mkdir()
    rows = []
    for i in range(7):
        h, w = int(rng.integers(20, 70)), int(rng.integers(30, 700))
        px = rng.integers(0, 256, (h, w, 3) if rgb else (h, w), np.uint8)
        name = f"l{i}.png"
        # One image lies beside labels.txt, not under images/.
        where = tmp_path if i == 3 else tmp_path / "images"
        Image.fromarray(px).save(where / name)
        rows.append(f"{name}\t{'abc'[: i % 3 + 1]}")
    rows += ["missing.png\tx", "no tab here"]
    (tmp_path / "labels.txt").write_text("\n".join(rows) + "\n")
    return tmp_path / "labels.txt"


@pytest.mark.parametrize("rgb", [False, True])
@pytest.mark.parametrize("augment", [False, True])
def test_load_local_dataset_matches_kiri_tpu(tmp_path, rgb, augment):
    labels = _line_dir(tmp_path, rgb)
    want = jload(labels, 48, 320, augment=augment)
    got = load_local_dataset(labels, 48, 320, augment=augment)
    assert len(got) == len(want) == 7
    for _ in range(2):               # a second pass draws new stretches
        for i in range(len(want)):
            a, b = got[i], want[i]
            assert a["text"] == b["text"]
            np.testing.assert_array_equal(a["image"], b["image"])


def test_unreadable_line_is_a_blank_sample(tmp_path, capsys):
    (tmp_path / "bad.png").write_bytes(b"not a png")
    got = LineSampleSet([(str(tmp_path / "bad.png"), "x")], 48, 64)[0]
    assert got["text"] == "" and not got["image"].any()
    assert "Error loading sample" in capsys.readouterr().out


def test_build_vocab_matches_kiri_tpu(tmp_path):
    texts = ["hello world", "ក្រុម", "a\nb", ""]
    jbuild(texts, tmp_path / "j.json")
    build_vocab_from_texts(texts, tmp_path / "t.json")
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()


@pytest.fixture
def khmer_tok(tmp_path):
    vocab = {"<unk>": 0}
    for ch in sorted(set("".join(NON_CANONICAL) + CANONICAL)):
        vocab[ch] = len(vocab)
    vp = tmp_path / "v.json"
    vp.write_text(json.dumps(vocab))
    return CharTokenizer(vp, CFG(KHMER_VISUAL_ORDER=True))


def test_canonical_text_of_khmer_labels(khmer_tok, tmp_path):
    """The two sequences of ADVICE.md come back reordered from visual
    order: canonical_text gives that order, which encodes to the same
    tokens; a canonical label is left as it is; without visual order every
    label is canonical."""
    tok = khmer_tok
    for text in NON_CANONICAL:
        canon = tok.canonical_text(text)
        assert canon != text and sorted(canon) == sorted(text)
        assert tok.decode_ctc(tok.encode_ctc(text)) == canon
        assert tok.encode_ctc(canon) == tok.encode_ctc(text)
        assert tok.canonical_text(canon) == canon
    assert tok.canonical_text(CANONICAL) == CANONICAL
    plain = CharTokenizer(write_vocab(tmp_path / "p.json"), CFG())
    assert plain.canonical_text(NON_CANONICAL[0]) == NON_CANONICAL[0]


def test_labels_are_canonicalized_once_at_load(khmer_tok, tmp_path, capsys):
    tok = khmer_tok
    (tmp_path / "images").mkdir()
    rows = []
    for i, text in enumerate(NON_CANONICAL + [CANONICAL]):
        Image.fromarray(np.full((30, 60), 200, np.uint8)).save(
            tmp_path / "images" / f"{i}.png")
        rows.append(f"{i}.png\t{text}")
    (tmp_path / "labels.txt").write_text("\n".join(rows) + "\n")
    data = load_local_dataset(tmp_path / "labels.txt", 48, 160, tok=tok)
    assert "2 of 3 labels" in capsys.readouterr().out
    assert [t for _, t in data.records] == \
        [tok.canonical_text(t) for t in NON_CANONICAL] + [CANONICAL]
    samples = [{"image": np.zeros((48, 160), np.uint8), "text": t}
               for t in NON_CANONICAL]
    canon = canonical_samples(samples, tok)
    assert "2 of 2 labels" in capsys.readouterr().out
    assert [s["text"] for s in canon] == \
        [tok.canonical_text(t) for t in NON_CANONICAL]
    for key, v in collate(samples, tok).items():
        np.testing.assert_array_equal(v, collate(canon, tok)[key])
