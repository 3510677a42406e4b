"""kiri_tpu_torch stands alone: it imports neither JAX nor the JAX package
(nor safetensors, cv2, PIL, yaml, onnx or onnxruntime, which the GPU
machine lacks), and its entry points refuse to fall back to the CPU when no card is
present."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "kiri_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "kiri_tpu", "safetensors", "cv2", "PIL", "flax",
             "optax", "onnx", "onnxruntime", "yaml"}


def _port_modules():
    return sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def test_port_imports_without_jax():
    mods = _port_modules()
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r})\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(mods) >= 15


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*PORT.rglob("*.py"),
                                       REPO / "chip_smoke.py"]))
def test_no_forbidden_imports(path):
    tree = ast.parse((REPO / path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    from kiri_tpu_torch.checkpoints import load_checkpoint
    from kiri_tpu_torch.device import resolve_device
    from kiri_tpu_torch.engine import RecognizerEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt = str(REPO / "models" / "model.safetensors")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint(ckpt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RecognizerEngine.from_checkpoint(ckpt)
    assert resolve_device("cpu").type == "cpu"


def test_page_entry_points_refuse_cpu_fallback(monkeypatch):
    """OCR, DBDetector and TextDetector with no device mean the card."""
    import kiri_tpu_torch
    from kiri_tpu_torch.detect import TextDetector
    from kiri_tpu_torch.detect.db import DBDetector

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    det = str(REPO / "models" / "detector.safetensors")
    for make in (lambda: kiri_tpu_torch.OCR(str(REPO / "models"
                                                / "model.safetensors")),
                 lambda: DBDetector(det), lambda: TextDetector("db", det)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_training_modules_are_covered():
    """The training slice's modules are among those imported above."""
    mods = set(_port_modules())
    assert {"kiri_tpu_torch.train.trainer", "kiri_tpu_torch.train.checkpoints",
            "kiri_tpu_torch.data.datasets", "kiri_tpu_torch.data.docsynth",
            "kiri_tpu_torch.detect.db.train",
            "kiri_tpu_torch.detect.craft.train"} <= mods


def test_training_entry_points_refuse_cpu_fallback(monkeypatch, tmp_path):
    """Trainer, train_db and train_craft with no device mean the card."""
    from kiri_tpu_torch.config import CFG
    from kiri_tpu_torch.detect.craft.train import CRAFTTrainConfig, train_craft
    from kiri_tpu_torch.detect.db.train import DBTrainConfig, train_db
    from kiri_tpu_torch.tokenizer import CharTokenizer
    from kiri_tpu_torch.train.trainer import TrainConfig, Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tok = CharTokenizer(REPO / "models" / "vocab.json", CFG())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(CFG(), tok, TrainConfig())
    for fn, tc in ((train_db, DBTrainConfig(data_dir=str(tmp_path))),
                   (train_craft, CRAFTTrainConfig(data_dir=str(tmp_path)))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(tc, verbose=False)


def test_model_file_modules_are_covered():
    """The model-files slice's modules are among those imported above, and
    ``huggingface_hub`` is imported only inside the hub functions."""
    mods = set(_port_modules())
    assert {"kiri_tpu_torch.utils.khmer", "kiri_tpu_torch.utils.onnx_pb",
            "kiri_tpu_torch.utils.onnx_import"} <= mods
    for path in PORT.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else [node.module])
                assert not any(str(n).startswith("huggingface_hub")
                               for n in names), path


def test_onnx_and_kiriocr_entry_points_refuse_cpu_fallback(monkeypatch,
                                                           tmp_path):
    """A ``.onnx`` DB detector and ``KiriOCR`` with no device mean the
    card."""
    from kiri_tpu_torch.detect.db import DBDetector
    from kiri_tpu_torch.models.recognizer import KiriOCR
    from kiri_tpu_torch.smoke import build_ppocr_det

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    onnx = tmp_path / "det.onnx"
    onnx.write_bytes(build_ppocr_det(seed=3, neck_ch=8, scale=0.35))
    ckpt = str(REPO / "models" / "model.safetensors")
    for make in (lambda: DBDetector(str(onnx)),
                 lambda: KiriOCR.from_checkpoint(ckpt)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
