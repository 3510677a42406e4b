"""HuggingFace datasets in the port (``data/datasets.py::load_hf_dataset``)
against ``kiri_tpu``'s: local datasets written here (image folders with a
``metadata.csv``, and parquet files with the image bytes inside) and loaded
with ``load_dataset`` on their directory, offline, the cache under the
test's directory. Samples' bytes equal, the validation split's fallback
order (the given split, "validation", "val", "test", else a seeded split),
``streaming=True``, and ``kiri-tpu-torch train --hf-dataset``."""
from __future__ import annotations

import os

os.environ.setdefault("HF_DATASETS_OFFLINE", "1")
os.environ.setdefault("HF_HUB_OFFLINE", "1")

import numpy as np
import pytest

from kiri_tpu.data.datasets import load_hf_dataset as jload
from kiri_tpu_torch.data.datasets import load_hf_dataset
from kiri_tpu_torch.utils.imageio import encode_png

from torch_train import CHARS


@pytest.fixture(autouse=True)
def offline_cache(tmp_path, monkeypatch):
    """No network, and the datasets cache inside the test's directory."""
    import cv2
    import datasets

    monkeypatch.setenv("HF_DATASETS_OFFLINE", "1")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(datasets.config, "HF_DATASETS_OFFLINE", True)
    monkeypatch.setattr(datasets.config, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(datasets.config, "HF_DATASETS_CACHE",
                        tmp_path / "hf_cache")
    before = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)     # the port's resize is OpenCV's own code
    yield
    cv2.ipp.setUseIPP(before)


def _line(rng, i, rgb=False):
    shape = (24 + 3 * i, 60 + 17 * i) + ((3,) if rgb else ())
    return rng.integers(0, 255, shape, np.uint8)


def write_folder(root, splits, seed=0, rgb=False):
    """An image folder per split, with its metadata.csv."""
    rng = np.random.default_rng(seed)
    for split, n in splits.items():
        d = root / split
        d.mkdir(parents=True)
        rows = ["file_name,text"]
        for i in range(n):
            (d / f"{i}.png").write_bytes(encode_png(_line(rng, i, rgb)))
            rows.append(f"{i}.png,{CHARS[i % 5]}{split[:2]} {i}")
        (d / "metadata.csv").write_text("\n".join(rows) + "\n")
    return str(root)


def write_parquet(root, splits, seed=1):
    """Parquet files whose image column holds the PNG bytes."""
    import datasets

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    for split, n in splits.items():
        ds = datasets.Dataset.from_dict(
            {"image": [{"bytes": encode_png(_line(rng, i)), "path": None}
                       for i in range(n)],
             "text": [f"{split} {i}" for i in range(n)]},
            features=datasets.Features({"image": datasets.Image(),
                                        "text": datasets.Value("string")}))
        ds.to_parquet(str(root / f"{split}.parquet"))
    return str(root)


def _same(got, want):
    assert len(got) == len(want)
    for i in range(len(want)):
        a, b = got[i], want[i]
        assert a["text"] == b["text"]
        np.testing.assert_array_equal(a["image"], b["image"])


@pytest.mark.parametrize("kind", ["folder", "folder_rgb", "parquet"])
def test_samples_equal_kiri_tpus(tmp_path, kind):
    splits = {"train": 5, "validation": 2}
    root = (write_parquet(tmp_path / "ds", splits) if kind == "parquet" else
            write_folder(tmp_path / "ds", splits, rgb=kind == "folder_rgb"))
    got = load_hf_dataset([root], img_h=48, img_w=160)
    want = jload([root], img_h=48, img_w=160)
    for g, w in zip(got, want):
        _same(g, w)
    assert len(got[0]) == 5 and len(got[1]) == 2
    src = got[0].records[0][0]
    assert isinstance(src, dict)            # undecoded: the port reads it
    assert (src["bytes"] is None) == (kind != "parquet")


@pytest.mark.parametrize("splits,val_split,expect", [
    ({"train": 4, "validation": 2, "test": 3}, None, "va"),
    ({"train": 4, "val": 2, "test": 3}, None, "va"),
    ({"train": 4, "test": 3}, None, "te"),
    ({"train": 4, "validation": 2, "test": 3}, "test", "te"),
    ({"train": 4, "test": 3}, "nosuch", "te"),
])
def test_validation_split_fallback_order(tmp_path, splits, val_split,
                                         expect):
    root = write_folder(tmp_path / "ds", splits)
    got = load_hf_dataset([root], img_h=48, img_w=160, val_split=val_split)
    want = jload([root], img_h=48, img_w=160, val_split=val_split)
    _same(got[1], want[1])
    assert all(got[1][i]["text"][1:3] == expect for i in range(len(got[1])))


@pytest.mark.parametrize("streaming", [False, True])
def test_seeded_auto_split_and_streaming(tmp_path, streaming):
    root = write_folder(tmp_path / "ds", {"train": 12})
    for seed in (42, 7):
        got = load_hf_dataset([root], img_h=48, img_w=160, val_ratio=0.25,
                              seed=seed, streaming=streaming)
        want = jload([root], img_h=48, img_w=160, val_ratio=0.25, seed=seed,
                     streaming=streaming)
        for g, w in zip(got, want):
            _same(g, w)
        assert len(got[1]) == 3 and len(got[0]) == 9


def test_two_datasets_concatenate(tmp_path):
    a = write_folder(tmp_path / "a", {"train": 3, "test": 1}, seed=3)
    b = write_folder(tmp_path / "b", {"train": 2, "validation": 1}, seed=4)
    got = load_hf_dataset([a, b], img_h=48, img_w=160, augment=True)
    want = jload([a, b], img_h=48, img_w=160, augment=True)
    for g, w in zip(got, want):
        _same(g, w)
    assert len(got[0]) == 5


def test_train_from_a_local_hf_dataset(tmp_path, capsys):
    from kiri_tpu_torch import cli

    root = write_folder(tmp_path / "ds", {"train": 8, "test": 2})
    out = tmp_path / "run"
    args = ["train", "--hf-dataset", root, "--epochs", "1", "--batch-size",
            "4", "--output-dir", str(out), "--device", "cpu",
            "--enc-dim", "32", "--enc-layers", "1", "--enc-heads", "4",
            "--enc-ff", "64", "--dec-dim", "32", "--dec-layers", "1",
            "--dec-heads", "4", "--dec-ff", "64", "--width", "160"]
    assert cli.main(args) == 0, capsys.readouterr().err
    assert (out / "model_epoch_1.safetensors").exists()
    assert (out / "vocab.json").exists()
    assert "8 train / 2 val samples" in capsys.readouterr().out
