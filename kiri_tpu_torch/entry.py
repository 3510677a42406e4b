"""Entry points for a quick check of the port: the counterpart of the
JAX package's ``__graft_entry__.py``.

``entry()``            — the flagship recognizer's forward step (encode,
                         CTC head, memory projection) and example inputs,
                         on the card unless the caller asks for the CPU.
``dryrun_multichip(n)`` — one hybrid CTC + CE train step over an n-rank
                         (data, model) mesh (model axis 2 where n is even),
                         then a "beam" ``recognize_batch`` through
                         ``RecognizerEngine(mesh=)``, on tiny shapes.

    python -m kiri_tpu_torch.entry [N] [--device cpu]
"""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch


def _make_vocab(tmpdir: str) -> str:
    chars = ("abcdefghijklmnopqrstuvwxyz"
             "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 .,!?-:;'\"()")
    vocab = {"<unk>": 0}
    for i, ch in enumerate(chars, start=1):
        vocab[ch] = i
    p = Path(tmpdir) / "vocab.json"
    p.write_text(json.dumps(vocab))
    return str(p)


def entry(device=None):
    """(fn, (model, images)): ``fn(model, images)`` is the flagship
    recognizer's forward (default ``CFG``, bf16, random weights from seed 0)
    over u8 lines [8, IMG_H, IMG_W] -> (CTC logits, projected memory)."""
    from .config import CFG
    from .device import resolve_device
    from .models.recognizer import Recognizer
    from .tokenizer import CharTokenizer

    dev = resolve_device(device)
    cfg = CFG(COMPUTE_DTYPE="bfloat16")
    tok = CharTokenizer(_make_vocab(tempfile.mkdtemp(prefix="kiri_entry_")),
                        cfg)
    model = Recognizer(cfg, tok.vocab_size).init_weights(
        torch.Generator().manual_seed(0)).to(dev).eval()

    @torch.inference_mode()
    def forward(model, images_u8):
        x = torch.as_tensor(images_u8).to(dev)
        mem = model.encode(x, torch.bfloat16)
        return model.ctc_logits(mem), model.mem_project(mem)

    images = np.random.default_rng(0).integers(
        0, 255, (8, cfg.IMG_H, cfg.IMG_W), dtype=np.uint8)
    return forward, (model, images)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One train step and one sharded ``"beam"`` recognition over an
    ``n_devices``-rank mesh. Run as a rank of a process group of that size,
    it does the work in place; otherwise it starts ``n_devices`` gloo ranks
    (``parallel.launch.spawn``) on ``device`` (the card unless ``"cpu"``;
    the ranks share the cards there are) and raises if any rank fails."""
    from . import parallel as P

    rank, world = P.process_info()
    if world == n_devices:
        _dryrun_impl(n_devices, device)
        return
    if device is None:
        from .device import resolve_device

        resolve_device(None)
        device = "cuda"
    from .parallel.launch import spawn

    out = spawn("kiri_tpu_torch.entry:_dryrun_rank", n_devices,
                {"n_devices": n_devices}, device=str(device), timeout=600)
    print(out[0])


def _dryrun_rank(n_devices: int) -> str:
    from . import parallel as P

    return _dryrun_impl(n_devices, P.process_device())


def _dryrun_impl(n_devices: int, device: Optional[torch.device]) -> str:
    from . import parallel as P
    from .config import CFG
    from .engine import RecognizerEngine
    from .models.recognizer import Recognizer
    from .tokenizer import CharTokenizer
    from .train.trainer import TrainConfig, Trainer, collate

    tmpdir = tempfile.mkdtemp(prefix="kiri_dryrun_")
    cfg = CFG(ENC_DIM=64, ENC_LAYERS=2, ENC_FF=128, ENC_HEADS=4,
              DEC_DIM=64, DEC_LAYERS=2, DEC_FF=128, DEC_HEADS=4,
              IMG_H=48, IMG_W=160, COMPUTE_DTYPE="float32")
    tok = CharTokenizer(_make_vocab(tmpdir), cfg)
    mp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    model = Recognizer(cfg, tok.vocab_size).init_weights(
        torch.Generator().manual_seed(0))
    tc = TrainConfig(batch_size=2 * n_devices, epochs=1, n_devices=n_devices,
                     model_parallel=mp)
    trainer = Trainer(cfg, tok, tc, model=model, total_steps=100,
                      device=device)

    rng = np.random.default_rng(0)
    samples = [{"image": rng.integers(0, 255, (cfg.IMG_H, cfg.IMG_W),
                                      dtype=np.uint8),
                "text": "hello world 123"} for _ in range(2 * n_devices)]
    loss = trainer.run_step(collate(samples, tok))["loss"]
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")

    engine = RecognizerEngine(trainer.model, cfg, tok, device,
                              mesh=trainer.mesh)
    imgs = np.stack([s["image"] for s in samples])
    widths = np.full((imgs.shape[0],), cfg.IMG_W, np.int32)
    outs = engine.recognize_batch(imgs, "beam", widths=widths)
    if len(outs) != imgs.shape[0]:
        raise RuntimeError(f"{len(outs)} results for {imgs.shape[0]} rows")
    shape = ({"data": 1, "model": 1} if trainer.mesh is None
             else trainer.mesh.shape)
    msg = (f"dryrun_multichip({n_devices}): mesh={shape} loss={loss:.4f} "
           f"infer={len(outs)} rows OK (rank {P.process_info()[0]})")
    print(msg, flush=True)
    return msg


if __name__ == "__main__":
    args = sys.argv[1:]
    dev = None
    if "--device" in args:
        i = args.index("--device")
        dev = args[i + 1]
        del args[i: i + 2]
    dryrun_multichip(int(args[0]) if args else 2, dev)
