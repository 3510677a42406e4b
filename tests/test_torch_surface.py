"""kiri_tpu_torch's public surface against kiri_tpu's: the eight lazily
exported names and ``__version__``, and ``KiriOCR`` on kiri_tpu's parameters
(``variables=``) against ``kiri_tpu.KiriOCR`` on a small random model at
float32 (encode, CTC logits, memory projection within 1e-4; the parameter
count equal)."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_decoder_layers import few_torch_threads  # noqa: F401

import kiri_tpu
import kiri_tpu_torch

REPO = Path(__file__).resolve().parent.parent
NAMES = ("OCR", "CFG", "CharTokenizer", "TextDetector", "DocumentRenderer",
         "TextBox", "DetectionLevel", "KiriOCR")
ATOL = 1e-4


@pytest.mark.parametrize("name", NAMES)
def test_lazy_name_resolves_to_the_port(name):
    obj = getattr(kiri_tpu_torch, name)
    assert obj.__module__.startswith("kiri_tpu_torch.")
    assert obj.__name__ == getattr(kiri_tpu, name).__name__
    assert name in dir(kiri_tpu_torch)


def test_version_and_unknown_name():
    assert kiri_tpu_torch.__version__ == kiri_tpu.__version__ == "0.1.0"
    with pytest.raises(AttributeError, match="no attribute"):
        kiri_tpu_torch.NotAName  # noqa: B018


def test_import_is_light_and_needs_no_card():
    """``import kiri_tpu_torch`` loads no torch-heavy module until a name
    is asked for, and every name imports with CUDA hidden."""
    code = ("import sys\nimport kiri_tpu_torch as k\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n"
            f"from kiri_tpu_torch import {', '.join(NAMES)}\n"
            "import torch\nassert not torch.cuda.is_available()\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    from test_torch_decoder_layers import make_small_model

    return make_small_model(tmp_path_factory.mktemp("surface"), seed=4)


def test_kiriocr_on_kiri_tpu_parameters(small):
    variables, jcfg, jtok, _, cfg, tok = small
    ref = kiri_tpu.KiriOCR(jcfg, jtok, variables=variables)
    np_vars = jax.tree.map(np.asarray, {k: variables[k]
                                        for k in ("params", "batch_stats")})
    ours = kiri_tpu_torch.KiriOCR(cfg, tok, variables=np_vars, device="cpu")
    imgs = np.random.default_rng(5).integers(0, 256, (3, 48, 160), np.uint8)
    jmem = ref.encode(imgs)
    mem = ours.encode(imgs)
    assert mem.shape == (3, 40, 64) and mem.dtype == torch.float32
    np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), atol=ATOL)
    np.testing.assert_allclose(ours.ctc_logits(mem).numpy(),
                               np.asarray(ref.ctc_logits(jmem)), atol=ATOL)
    np.testing.assert_allclose(ours.mem_project(mem).numpy(),
                               np.asarray(ref.mem_project(jmem)), atol=ATOL)
    assert ours.num_params() == ref.num_params()


def test_kiriocr_seeded_init_differs_from_jax_but_counts_the_same(small):
    """Without ``variables`` the port draws its own weights from a torch
    generator (not JAX's initializer): the same count of parameters, the
    same shapes of output, other values; the same seed gives the same
    weights."""
    variables, jcfg, jtok, _, cfg, tok = small
    ref = kiri_tpu.KiriOCR(jcfg, jtok, seed=0)
    a = kiri_tpu_torch.KiriOCR(cfg, tok, seed=0, device="cpu")
    b = kiri_tpu_torch.KiriOCR(cfg, tok, seed=0, device="cpu")
    c = kiri_tpu_torch.KiriOCR(cfg, tok, seed=1, device="cpu")
    assert a.num_params() == ref.num_params()
    imgs = np.full((1, 48, 96), 200, np.uint8)
    ma, mb, mc = (m.encode(imgs) for m in (a, b, c))
    assert torch.equal(ma, mb) and not torch.equal(ma, mc)
    jm = np.asarray(ref.encode(imgs))
    assert ma.shape == jm.shape and not np.allclose(ma.numpy(), jm,
                                                    atol=1e-2)


def test_kiriocr_from_checkpoint(tmp_path):
    """``from_checkpoint`` on the committed checkpoint: its config, and the
    JAX package's parameter count."""
    ckpt = REPO / "models" / "model.safetensors"
    ours = kiri_tpu_torch.KiriOCR.from_checkpoint(str(ckpt), device="cpu")
    ref = kiri_tpu.KiriOCR.from_checkpoint(str(ckpt))
    assert ours.cfg.ENC_DIM == ref.cfg.ENC_DIM == 256
    assert ours.tok.vocab_size == ref.tok.vocab_size
    assert ours.num_params() == ref.num_params()
    with pytest.raises(FileNotFoundError, match="vocab"):
        bare = tmp_path / "m.safetensors"
        bare.write_bytes(ckpt.read_bytes())
        kiri_tpu_torch.KiriOCR.from_checkpoint(str(bare), device="cpu")
