"""kiri_tpu_torch's one loader over every recognizer format that kiri_tpu
loads, against kiri_tpu on the same files (a small random model on the CPU):
F32 and F16 ``.safetensors`` with and without a meta, the reference's
``{"config", "model"}`` ``.pt`` (config as a dict and as an object) and a
bare state-dict ``.pt``. Each file loads to kiri_tpu's config, and float32
encoder memory, CTC logits and memory projection agree within 1e-4. Also the
reader's dtypes against ``safetensors.numpy``, BF16 (ValueError here;
kiri_tpu reads it, as JAX registers bfloat16 with numpy),
``infer_cfg_from_state_dict`` on every test shape,
and the readers that route through the loader: ``OCR``,
``RecognizerEngine.from_checkpoint``, ``KiriOCR``, the trainer's warm start
and the detector checkpoints."""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file
from test_torch_decoder_layers import few_torch_threads  # noqa: F401

from kiri_tpu.config import CFG as JCFG
from kiri_tpu.models import recognizer as R
from kiri_tpu.tokenizer import CharTokenizer as JTok
from kiri_tpu.train.checkpoints import load_checkpoint as j_load
from kiri_tpu.train.checkpoints import save_checkpoint as j_save
from kiri_tpu.utils.convert import infer_cfg_from_state_dict as j_infer
from kiri_tpu.utils.convert import to_torch_state_dict
from kiri_tpu_torch.checkpoints import (load_checkpoint, read_checkpoint,
                                        read_safetensors, write_safetensors)
from kiri_tpu_torch.config import CFG
from kiri_tpu_torch.convert import infer_cfg_from_state_dict

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "models" / "model.safetensors"
TINY = dict(ENC_DIM=64, ENC_LAYERS=2, ENC_FF=128, ENC_HEADS=4, DEC_DIM=64,
            DEC_LAYERS=2, DEC_FF=128, DEC_HEADS=4, IMG_H=48, IMG_W=160,
            COMPUTE_DTYPE="float32", KHMER_VISUAL_ORDER=True)
FORMATS = ("f32_meta", "f16_meta", "f32_nometa", "f16_nometa", "pt_config",
           "pt_namespace", "pt_bare")
ATOL = 1e-4


def _norm(d):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A random kiri_tpu model (biases and norms jittered) written in every
    format, each in its own directory with the vocab beside it."""
    root = tmp_path_factory.mktemp("formats")
    vocab = {"<unk>": 0, **{ch: i + 1 for i, ch in enumerate("abcde ")}}
    (root / "vocab.json").write_text(json.dumps(vocab))
    jcfg = JCFG(**TINY)
    variables = R.init_recognizer(jax.random.PRNGKey(3), jcfg,
                                  JTok(str(root / "vocab.json"), jcfg))
    rng = np.random.default_rng(3)
    variables = dict(variables, params=jax.tree.map(
        lambda v: np.asarray(v) + rng.normal(0, 0.05, v.shape).astype(
            np.float32), variables["params"]))
    sd = to_torch_state_dict(variables, jcfg)
    meta_cfg = jcfg.to_dict()
    out = {}
    for fmt in FORMATS:
        d = root / fmt
        d.mkdir()
        shutil.copy(root / "vocab.json", d / "vocab.json")
        if fmt == "f32_meta":
            j_save(str(d / "model.safetensors"), variables, jcfg,
                   vocab_path="vocab.json", epoch=3, step=77)
            out[fmt] = d / "model.safetensors"
        elif fmt.endswith("meta"):
            half = {k: v.astype(np.float16) if v.dtype == np.float32 else v
                    for k, v in sd.items()}
            if fmt == "f16_meta":
                write_safetensors(d / "model.safetensors", half)
                (d / "model_meta.json").write_text(json.dumps(
                    {"config": meta_cfg, "vocab_path": "vocab.json",
                     "epoch": 2}))
            else:
                save_file(half if fmt == "f16_nometa" else sd,
                          str(d / "model.safetensors"))
            out[fmt] = d / "model.safetensors"
        else:
            state = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
            config = (meta_cfg if fmt == "pt_config"
                      else SimpleNamespace(**meta_cfg, _private=1))
            torch.save(state if fmt == "pt_bare" else {
                "config": config, "model": state, "vocab_path": "vocab.json",
                "epoch": 1, "step": 9}, str(d / "model.pt"))
            out[fmt] = d / "model.pt"
    return out


@pytest.mark.parametrize("fmt", FORMATS)
def test_format_loads_to_kiri_tpu(files, fmt):
    path = str(files[fmt])
    jvars, jcfg, jmeta = j_load(path)
    model, cfg, meta = load_checkpoint(path, device="cpu")
    assert _norm(cfg.to_dict()) == _norm(jcfg.to_dict())
    assert meta == jmeta
    if "nometa" in fmt or fmt == "pt_bare":
        # The shapes decide: width 64 is one head of 64, and the defaults
        # hold for everything the shapes do not show.
        assert cfg.ENC_HEADS == 1 and not cfg.KHMER_VISUAL_ORDER
    else:
        assert cfg.KHMER_VISUAL_ORDER
    imgs = np.random.default_rng(1).integers(0, 256, (2, 48, 160), np.uint8)
    jc = jcfg.replace(COMPUTE_DTYPE="float32")
    jmem, _ = R.encode(jvars, jnp.asarray(imgs), jc, train=False)
    with torch.inference_mode():
        mem = model.encode(torch.from_numpy(imgs), torch.float32)
        np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), atol=ATOL)
        np.testing.assert_allclose(
            model.ctc_logits(mem).numpy(),
            np.asarray(R.ctc_logits(jvars["params"], jmem, jc)), atol=ATOL)
        np.testing.assert_allclose(
            model.mem_project(mem).numpy(),
            np.asarray(R.mem_project(jvars["params"], jmem)), atol=ATOL)
    for v in model.state_dict().values():
        assert v.dtype in (torch.float32, torch.int64)


@pytest.mark.parametrize("fmt", ["f16_meta", "f32_nometa", "pt_config",
                                 "pt_bare"])
def test_given_cfg_precedence(files, fmt):
    """A given cfg wins over the meta's and the .pt's config; a meta-less
    file or a .pt reads its shapes over it."""
    given = CFG(**dict(TINY, ENC_HEADS=8, DEC_HEADS=8, USE_LM=False,
                       KHMER_VISUAL_ORDER=False))
    jgiven = JCFG(**dict(TINY, ENC_HEADS=8, DEC_HEADS=8, USE_LM=False,
                         KHMER_VISUAL_ORDER=False))
    _, cfg, _ = read_checkpoint(files[fmt], given)
    _, jcfg, _ = j_load(str(files[fmt]), jgiven)
    assert _norm(cfg.to_dict()) == _norm(jcfg.to_dict())
    assert cfg.ENC_HEADS == (8 if fmt == "f16_meta" else 1)
    assert not cfg.USE_LM
    # The model keeps the file's LM head, which the config leaves unused.
    model, _, _ = load_checkpoint(files[fmt], given, device="cpu")
    assert hasattr(model, "lm_head") and not model.use_lm


@pytest.mark.parametrize("name,dtype", [
    ("F64", np.float64), ("F32", np.float32), ("F16", np.float16),
    ("I64", np.int64), ("U64", np.uint64), ("I32", np.int32),
    ("U32", np.uint32), ("I16", np.int16), ("U16", np.uint16),
    ("I8", np.int8), ("U8", np.uint8), ("BOOL", np.bool_)])
def test_reader_and_writer_dtypes(tmp_path, name, dtype):
    rng = np.random.default_rng(0)
    a = (rng.integers(0, 2, (3, 5)) if dtype == np.bool_
         else rng.normal(0, 50, (3, 5))).astype(dtype)
    save_file({"t": a, "s": a[0]}, str(tmp_path / "ref.safetensors"))
    got = read_safetensors(tmp_path / "ref.safetensors")
    assert got["t"].dtype == a.dtype and np.array_equal(got["t"], a)
    write_safetensors(tmp_path / "ours.safetensors", {"t": a})
    back = load_file(str(tmp_path / "ours.safetensors"))["t"]
    assert back.dtype == a.dtype and np.array_equal(back, a)
    header = json.loads((tmp_path / "ours.safetensors").read_bytes()[8:][
        :int.from_bytes((tmp_path / "ours.safetensors").read_bytes()[:8],
                        "little")])
    assert header["t"]["dtype"] == name


def test_bf16_raises_naming_the_dtype(tmp_path):
    header = json.dumps({"w": {"dtype": "BF16", "shape": [2],
                               "data_offsets": [0, 4]}}).encode()
    p = tmp_path / "bf16.safetensors"
    p.write_bytes(len(header).to_bytes(8, "little") + header + bytes(4))
    with pytest.raises(ValueError, match="BF16"):
        read_safetensors(p)
    # kiri_tpu reads it: JAX registers bfloat16 with numpy (ml_dtypes).
    assert load_file(str(p))["w"].dtype.name == "bfloat16"


@pytest.mark.parametrize("dims", [
    dict(ENC_DIM=32, ENC_LAYERS=2, ENC_FF=64, DEC_DIM=32, DEC_LAYERS=2,
         DEC_FF=64),
    dict(ENC_DIM=64, ENC_LAYERS=1, ENC_FF=128, DEC_DIM=64, DEC_LAYERS=1,
         DEC_FF=96),
    dict(ENC_DIM=96, ENC_LAYERS=3, ENC_FF=192, DEC_DIM=48, DEC_LAYERS=2,
         DEC_FF=64),
    dict(ENC_DIM=128, ENC_LAYERS=2, ENC_FF=256, DEC_DIM=128, DEC_LAYERS=1,
         DEC_FF=256),
    dict(ENC_DIM=40, ENC_LAYERS=1, ENC_FF=80, DEC_DIM=40, DEC_LAYERS=1,
         DEC_FF=80),
])
def test_infer_cfg_equals_kiri_tpu(dims, tmp_path):
    """On the shapes of a kiri_tpu model: each rule's branch (a head of 64,
    of 32, else 8 heads)."""
    jcfg = JCFG(**dims, COMPUTE_DTYPE="float32")
    (tmp_path / "v.json").write_text(json.dumps({"<unk>": 0, "a": 1}))
    variables = R.init_recognizer(jax.random.PRNGKey(0), jcfg,
                                  JTok(str(tmp_path / "v.json"), jcfg))
    sd = to_torch_state_dict(variables, jcfg)
    got = infer_cfg_from_state_dict(sd, CFG())
    want = j_infer(sd, JCFG())
    assert _norm(got.to_dict()) == _norm(want.to_dict())


def test_infer_cfg_committed_v13_reads_four_heads():
    """The committed v13 (8 heads of 32 in its meta) reads as 4 heads of 64
    without it, in both packages."""
    sd = read_safetensors(CKPT)
    got = infer_cfg_from_state_dict(sd, CFG())
    assert got.ENC_HEADS == got.DEC_HEADS == 4
    assert (got.ENC_DIM, got.ENC_LAYERS, got.DEC_LAYERS) == (256, 4, 3)
    assert _norm(got.to_dict()) == _norm(j_infer(sd, JCFG()).to_dict())


@pytest.mark.parametrize("fmt", ["f16_meta", "pt_config"])
def test_readers_route_through_the_loader(files, fmt, tmp_path):
    """``OCR``, ``RecognizerEngine.from_checkpoint`` and ``KiriOCR`` read
    every format; the trainer's warm start copies the file's weights."""
    from kiri_tpu_torch import KiriOCR
    from kiri_tpu_torch.engine import RecognizerEngine
    from kiri_tpu_torch.pipeline import OCR
    from kiri_tpu_torch.tokenizer import CharTokenizer
    from kiri_tpu_torch.train.trainer import TrainConfig, Trainer

    path = str(files[fmt])
    model, cfg, _ = load_checkpoint(path, device="cpu")
    imgs = np.random.default_rng(2).integers(0, 256, (3, 48, 160), np.uint8)
    eng = RecognizerEngine.from_checkpoint(path, device="cpu")
    ocr = OCR(model_path=path, det_method="legacy", decode_method="fast",
              device="cpu", use_fp16=False)
    want = RecognizerEngine(model, cfg.replace(COMPUTE_DTYPE="float32"),
                            eng.tok, device="cpu").recognize_batch(imgs,
                                                                   "ctc")
    assert ocr.engine.recognize_batch(imgs, "ctc") == want
    assert eng.recognize_batch(imgs, "ctc") == want
    kiri = KiriOCR.from_checkpoint(path, device="cpu")
    assert torch.equal(kiri.encode(imgs), model.encode(
        torch.from_numpy(imgs), torch.float32))

    tok = CharTokenizer(str(files[fmt].parent / "vocab.json"), cfg)
    trainer = Trainer(cfg, tok, TrainConfig(), device="cpu")
    trainer.load_weights(path)
    for k, v in model.state_dict().items():
        assert torch.equal(trainer.model.state_dict()[k], v), k


def test_detector_checkpoints_take_other_dtypes(tmp_path):
    """A DB or CRAFT checkpoint in F16 loads cast to float32, as
    ``safetensors.numpy`` reads it for kiri_tpu."""
    from kiri_tpu_torch.detect.craft import load_craft_checkpoint
    from kiri_tpu_torch.detect.db import load_db_checkpoint

    for src, load in (("detector.safetensors", load_db_checkpoint),
                      ("craft.safetensors", load_craft_checkpoint)):
        flat = read_safetensors(REPO / "models" / src)
        half = {k: v.astype(np.float16) for k, v in flat.items()}
        write_safetensors(tmp_path / src, half)
        got = load(tmp_path / src)
        ref = load_file(str(tmp_path / src))
        assert got.keys() == flat.keys()
        for k, v in got.items():
            assert v.dtype == np.float32
            assert np.array_equal(v, ref[k].astype(np.float32)), k
