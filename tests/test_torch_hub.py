"""Hugging Face hub resolution in kiri_tpu_torch, the cases of
tests/test_hf_resolution.py with the same fake ``huggingface_hub`` (no test
reaches the network): a repo id's file order and side files, ``model.pt``
after ``model.safetensors`` (and loaded, as every format now is), the path
as given when the hub cannot be imported, no request for a local file, and
the detector's ``detector/<f>``, ``<f>``, ``models/<f>`` order, its hub hit
and the default repo. Where nothing resolves the port raises
``FileNotFoundError`` (kiri_tpu falls back to its classic-CV detector)."""
from __future__ import annotations

import json
import shutil
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest

from kiri_tpu.config import CFG as JCFG
from kiri_tpu.models.recognizer import init_recognizer
from kiri_tpu.tokenizer import CharTokenizer as JTok
from kiri_tpu.train.checkpoints import save_checkpoint

REPO = Path(__file__).resolve().parent.parent
TINY = dict(ENC_DIM=32, ENC_LAYERS=1, ENC_FF=64, ENC_HEADS=2,
            DEC_DIM=32, DEC_LAYERS=1, DEC_FF=64, DEC_HEADS=2,
            COMPUTE_DTYPE="float32")


@pytest.fixture()
def hub(monkeypatch, tmp_path):
    """A fake huggingface_hub serving files from tmp_path/repo and
    recording every (repo_id, filename) request."""
    calls = []
    repo = tmp_path / "repo"
    repo.mkdir()

    def hf_hub_download(repo_id, filename, **kw):
        calls.append((repo_id, filename))
        p = repo / filename
        if not p.exists():
            raise FileNotFoundError(filename)
        return str(p)

    monkeypatch.setitem(sys.modules, "huggingface_hub",
                        types.SimpleNamespace(hf_hub_download=hf_hub_download))
    from kiri_tpu_torch.pipeline import OCR

    OCR._model_cache.clear()
    return repo, calls


def _make_ckpt(dirpath, name="model.safetensors"):
    vp = dirpath / "vocab.json"
    vp.write_text(json.dumps({"<unk>": 0, "a": 1, "b": 2, "c": 3}))
    cfg = JCFG(**TINY)
    variables = init_recognizer(jax.random.PRNGKey(0), cfg,
                                JTok(str(vp), cfg))
    save_checkpoint(str(dirpath / name), jax.device_get(variables), cfg,
                    vocab_path=str(vp))
    return dirpath / name


# ---------------------------------------------------------------- recognizer
def test_repo_id_download_and_load(hub):
    from kiri_tpu_torch.pipeline import OCR

    repo, calls = hub
    _make_ckpt(repo)
    ocr = OCR(model_path="someorg/somemodel", det_method="legacy",
              decode_method="fast", device="cpu")
    assert ocr.cfg.ENC_DIM == 32
    names = [f for _, f in calls]
    assert names[0] == "model.safetensors"
    assert names[1:] == ["model_meta.json", "vocab.json", "vocab_auto.json",
                         "vocab_char.json", "config.json"]
    assert all(r == "someorg/somemodel" for r, _ in calls)


def test_repo_id_pt_fallback_order(hub):
    """model.safetensors missing -> model.pt is tried next; an empty repo
    leaves the id as given and the loader raises."""
    from kiri_tpu_torch.pipeline import OCR

    repo, calls = hub
    with pytest.raises(FileNotFoundError):
        OCR(model_path="org/ptonly", det_method="legacy", device="cpu")
    assert [f for _, f in calls][:2] == ["model.safetensors", "model.pt"]


def test_repo_id_pt_loads(hub, tmp_path):
    """A repo holding only the reference's ``.pt`` serves from it."""
    import torch

    from kiri_tpu_torch.checkpoints import read_safetensors
    from kiri_tpu_torch.pipeline import OCR

    repo, calls = hub
    src = _make_ckpt(tmp_path)
    meta = json.loads((tmp_path / "model_meta.json").read_text())
    torch.save({"config": meta["config"], "model": {
        k: torch.from_numpy(v) for k, v in read_safetensors(src).items()}},
        str(repo / "model.pt"))
    shutil.copy(tmp_path / "vocab.json", repo / "vocab.json")
    ocr = OCR(model_path="org/ptrepo", det_method="legacy", device="cpu")
    assert ocr.cfg.ENC_DIM == 32 and ocr.cfg.ENC_HEADS == 1
    assert [f for _, f in calls][:2] == ["model.safetensors", "model.pt"]


def test_offline_degrades_to_input_path(monkeypatch):
    """No importable huggingface_hub: the id stays as given and the loader
    raises a file error, with no crash in resolution."""
    from kiri_tpu_torch.pipeline import OCR

    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    OCR._model_cache.clear()
    ocr = OCR.__new__(OCR)
    ocr.verbose = True
    assert ocr._resolve_model_path("org/unreachable") == "org/unreachable"
    with pytest.raises(FileNotFoundError, match="org/unreachable"):
        OCR(model_path="org/unreachable", det_method="legacy", device="cpu")


def test_local_path_never_hits_hub(hub, tmp_path):
    from kiri_tpu_torch.pipeline import OCR

    repo, calls = hub
    ckpt = _make_ckpt(tmp_path)
    OCR(model_path=str(ckpt), det_method="legacy", device="cpu")
    assert calls == []


# ------------------------------------------------------------------ detector
def test_detector_hub_filename_order(hub, monkeypatch):
    """detector/<f>, <f>, models/<f> in order; nothing found raises (no
    fallback to the classic-CV detector)."""
    from kiri_tpu_torch.detect import TextDetector

    repo, calls = hub
    monkeypatch.chdir(repo)
    with pytest.raises(FileNotFoundError):
        TextDetector(method="db", model_path="definitely/absent.safetensors",
                     device="cpu")
    assert [f for _, f in calls] == [
        "detector/detector.safetensors", "detector.safetensors",
        "models/detector.safetensors"]
    assert all(r == "definitely/absent.safetensors" for r, _ in calls)


@pytest.mark.parametrize("method,fname", [("db", "detector.safetensors"),
                                          ("craft", "craft.safetensors")])
def test_detector_hub_hit_loads(hub, monkeypatch, tmp_path, method, fname):
    from kiri_tpu_torch.detect import TextDetector

    repo, calls = hub
    (repo / "detector").mkdir()
    shutil.copy(REPO / "models" / fname, repo / "detector" / fname)
    monkeypatch.chdir(tmp_path)
    det = TextDetector(method=method, model_path="some/repo", device="cpu")
    assert (det.db_detector if method == "db" else det.craft_detector)
    assert det.model_path == str(repo / "detector" / fname)
    assert calls == [("some/repo", f"detector/{fname}")]


def test_default_model_from_the_default_repo(hub, monkeypatch, tmp_path):
    """No local default model: the default repo's file is fetched."""
    import kiri_tpu_torch.detect as D

    repo, calls = hub
    monkeypatch.setitem(D._MODEL_FILES, "db", "kiri_db_absent.safetensors")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError):
        D.TextDetector("db", device="cpu")
    assert [r for r, _ in calls] == [D.TextDetector.DEFAULT_HUB_REPO] * 3
    shutil.copy(REPO / "models" / "detector.safetensors",
                repo / "kiri_db_absent.safetensors")
    calls.clear()
    det = D.TextDetector("db", device="cpu")
    assert det.model_path == str(repo / "kiri_db_absent.safetensors")
    assert calls == [("mrrtmob/kiri-ocr",
                      "detector/kiri_db_absent.safetensors"),
                     ("mrrtmob/kiri-ocr", "kiri_db_absent.safetensors")]
    page = np.full((64, 200), 255, np.uint8)
    assert det.detect_lines(page) == []
