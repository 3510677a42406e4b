"""``kiri-tpu-torch train`` and ``train-detector`` on the CPU: kiri_tpu's
flags, the config file without PyYAML, the runs and their files, and the
refused routes (the TPU, several devices without a process group)."""
from __future__ import annotations

import argparse
import json

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from kiri_tpu import cli as jcli
from kiri_tpu.data.docsynth import generate_detector_dataset
from kiri_tpu_torch import cli as tcli

SMALL_ARGS = ["--enc-dim", "32", "--enc-layers", "1", "--enc-heads", "4",
              "--enc-ff", "64", "--dec-dim", "32", "--dec-layers", "1",
              "--dec-heads", "4", "--dec-ff", "64", "--width", "160",
              "--batch-size", "4", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _options(parser, command):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {a.dest: (tuple(a.option_strings), a.choices, a.default, a.nargs,
                     a.type)
            for a in sub.choices[command]._actions if a.dest != "help"}


@pytest.mark.parametrize("command", ["train", "train-detector"])
def test_train_flags_match_kiri_tpu(command):
    """Every flag of kiri_tpu's, the same spellings and defaults; --device
    is the card by default and takes cpu (train-detector adds it, and
    --n-devices for data-parallel DB training)."""
    ours = _options(tcli._build_parser(), command)
    ref = _options(jcli._build_parser(), command)
    own = {"device"} | ({"n_devices"} if command == "train-detector"
                        else set())
    assert set(ours) - own == set(ref) - {"device"}
    for dest in ref:
        if dest != "device":
            assert ours[dest][:4] == ref[dest][:4], dest


def test_config_file_reads_as_pyyaml(tmp_path):
    """init-config's file (and a few more scalars) read without PyYAML as
    PyYAML reads them; JSON too."""
    path = tmp_path / "c.yaml"
    assert tcli.main(["init-config", "-o", str(path)]) == 0
    text = path.read_text() + ("train_labels: 'a b.txt'\nresume: true\n"
                               "vocab: null\nhf_dataset: [x, y]\n")
    path.write_text(text)
    assert tcli.load_config_file(path) == yaml.safe_load(text)
    js = tmp_path / "c.json"
    js.write_text(json.dumps({"epochs": 3}))
    assert tcli.load_config_file(js) == {"epochs": 3}


@pytest.fixture(scope="module")
def labels(tmp_path_factory):
    root = tmp_path_factory.mktemp("lines")
    (root / "images").mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i in range(8):
        img = rng.integers(0, 256, (int(rng.integers(30, 50)),
                                    int(rng.integers(60, 200))), np.uint8)
        Image.fromarray(img).save(root / "images" / f"{i}.png")
        rows.append(f"{i}.png\t{['abc', 'ba c', 'cab'][i % 3]}")
    (root / "labels.txt").write_text("\n".join(rows) + "\n")
    return root / "labels.txt"


def test_train_runs_and_writes_kiri_tpus_files(labels, tmp_path, capsys):
    cfg = tmp_path / "c.yaml"
    cfg.write_text(f"epochs: 1\nlr: 0.001\ntrain_labels: {labels}\n")
    out = tmp_path / "run"
    assert tcli.main(["train", "--config", str(cfg), "--output-dir", str(out),
                      *SMALL_ARGS]) == 0
    names = {p.name for p in out.iterdir()}
    assert {"vocab.json", "latest.safetensors", "latest_meta.json",
            "latest_optim_torch.npz", "model_epoch_1.safetensors",
            "history.json"} <= names
    vocab = json.loads((out / "vocab.json").read_text())
    assert sorted(vocab) == sorted(["<unk>", " ", "a", "b", "c"])
    meta = json.loads((out / "latest_meta.json").read_text())
    assert meta["config"]["ENC_DIM"] == 32 and meta["epoch"] == 1
    assert "1 epochs" in capsys.readouterr().out
    # --resume continues from latest: nothing left to train at 1 epoch.
    assert tcli.main(["train", "--train-labels", str(labels), "--epochs", "1",
                      "--output-dir", str(out), "--resume", *SMALL_ARGS]) == 0
    assert "Resumed" in capsys.readouterr().out


@pytest.mark.parametrize("extra,message", [
    (["--model-parallel", "2"], "parallel.initialize"),
    (["--device", "tpu"], "--device 'tpu'"),
    (["--n-devices", "2"], "parallel.initialize"),
])
def test_train_refuses(labels, tmp_path, capsys, extra, message):
    args = ["train", "--train-labels", str(labels), "--epochs", "1",
            "--output-dir", str(tmp_path / "r"), *SMALL_ARGS, *extra]
    assert tcli.main(args) == 1
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("detector", ["db", "craft"])
def test_train_detector_runs(tmp_path, detector):
    data = tmp_path / "data"
    generate_detector_dataset(str(data / "train"), 2, width=96, height=96,
                              seed=1)
    out = tmp_path / "out"
    assert tcli.main(["train-detector", "--detector", detector, "--data-yaml",
                      str(data), "--epochs", "2", "--batch-size", "2",
                      "--image-size", "96", "--output-dir", str(out),
                      "--device", "cpu"]) == 0
    want = ({"detector.safetensors"} if detector == "db"
            else {"last.safetensors", "best.safetensors"})
    assert {p.name for p in out.iterdir()} == want
    again = tmp_path / "again"
    assert tcli.main(["train-detector", "--detector", detector, "--data-yaml",
                      str(data / "train" / "annotations.json"), "--steps",
                      "1", "--batch-size", "2", "--from-model",
                      str(out / sorted(want)[0]), "--output-dir", str(again),
                      "--device", "cpu"]) == 0


def test_train_detector_ignores_generator_flags(tmp_path, capsys,
                                               monkeypatch):
    """With --data-yaml the live generator's flags are named as ignored (the
    trainer reads the directory); without it they reach the live pool's
    config, as in kiri_tpu."""
    from kiri_tpu_torch.detect.craft import train as craft_train

    seen = []
    monkeypatch.setattr(craft_train, "train_craft",
                        lambda tc, **kw: seen.append(tc))
    flags = ["train-detector", "--detector", "craft", "--aug-weights",
             "rotated=3", "--scale-aug", "0.5", "--image-size", "640",
             "--pool-size", "32", "--device", "cpu"]
    assert tcli.main([*flags, "--data-yaml", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "--pool-size, --aug-weights, --scale-aug: the live generator's" \
        in out
    assert "--image-size" not in out
    assert seen[-1].data_dir == str(tmp_path)
    assert tcli.main(flags) == 0
    assert "ignored" not in capsys.readouterr().out
    tc = seen[-1]
    assert tc.data_dir is None and tc.pool_size == 32
    assert tc.aug_weights == {"rotated": 3.0} and tc.scale_aug == 0.5
