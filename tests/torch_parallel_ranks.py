"""Rank bodies of the port's multi-process tests (tests/test_torch_sharding.py,
test_torch_multiprocess.py, test_torch_sharded_ckpt.py), started by
``kiri_tpu_torch.parallel.launch.spawn`` as gloo ranks on the CPU. Each
takes plain data (a torch-named state dict as numpy, a config dict, a
vocab path, numpy batches), runs as every rank does, and returns numpy
results; nothing here imports JAX, so a rank starts in a few seconds."""
from __future__ import annotations

import numpy as np
import torch


def _setup(state, cfgd, vocab):
    from kiri_tpu_torch.checkpoints import build_model
    from kiri_tpu_torch.config import CFG
    from kiri_tpu_torch.tokenizer import CharTokenizer

    cfg = CFG(**cfgd)
    return cfg, CharTokenizer(vocab, cfg), lambda: build_model(state, cfg)


def _state(model) -> dict:
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def _records(streams) -> list:
    return [[{k: v for k, v in r.items()} for r in s] for s in streams]


def _replica_spread(grads, mesh, sharded) -> float:
    """The largest difference between the model axis's ranks in a
    replicated parameter's gradient, relative to that gradient's largest
    value (a collective over the model axis)."""
    from kiri_tpu_torch import parallel as P

    flags = list(sharded) + [False] * (len(grads) - len(sharded))
    worst = 0.0
    for g, split in zip(grads, flags):
        if split:
            continue
        pieces = P.gather_tensor(g, mesh.model_group, mesh.model_size,
                                 mesh.model_index)
        scale = max(float(p.abs().max()) for p in pieces)
        diff = max(float((p - pieces[0]).abs().max()) for p in pieces)
        worst = max(worst, diff / scale if scale else diff)
    return worst


def train_steps(state, cfgd, vocab, batch, mp, steps=1, tc=None,
                total_steps=100):
    """``steps`` steps of the port's Trainer over a mesh of every rank with
    model axis ``mp``: (metrics of each step, the whole state after). With
    a model axis each step's metrics also hold ``replica_grad_spread``:
    ``_replica_spread`` of the gradients as the backward left them, before
    ``sync_gradients`` sums them over the data axis and broadcasts them
    over the model axis."""
    from kiri_tpu_torch.train.trainer import TrainConfig, Trainer
    from kiri_tpu_torch import parallel as P

    cfg, tok, make = _setup(state, cfgd, vocab)
    world = P.process_info()[1]
    tr = Trainer(cfg, tok, TrainConfig(**{**(tc or {}), "n_devices": world,
                                          "model_parallel": mp}),
                 model=make(), total_steps=total_steps, device="cpu")
    spreads = []
    sync = P.sync_gradients

    def recorded(grads, mesh, sharded=()):
        spreads.append(_replica_spread(grads, mesh, sharded))
        sync(grads, mesh, sharded)

    if mp > 1:
        P.sync_gradients = recorded
    try:
        metrics = [tr.run_step(batch) for _ in range(steps)]
    finally:
        P.sync_gradients = sync
    for m, spread in zip(metrics, spreads):
        m["replica_grad_spread"] = spread
    return metrics, _state(tr.whole_model())


def sharding(state, cfgd, vocab, batch, batch7, drop_cfgd, imgs, widths,
             crops, sharpen, db, meshes):
    """For each model-axis size of ``meshes`` over every rank: one train
    step (and one on the 7-row batch, padded), one with dropout and
    decoder-input noise, the engine's methods and streams; then the DB
    trainer's data-parallel step."""
    from kiri_tpu_torch import parallel as P
    from kiri_tpu_torch.engine import RecognizerEngine

    world = P.process_info()[1]
    out = {}
    for mp in meshes:
        r = out[mp] = {}
        r["step"] = train_steps(state, cfgd, vocab, batch, mp)
        r["step7"] = train_steps(state, cfgd, vocab, batch7, mp)
        r["drop"] = train_steps(state, drop_cfgd, vocab, batch, mp, steps=2,
                                tc={"dec_input_noise": 0.2, "lr": 1e-3,
                                    "warmup_steps": 2}, total_steps=10)
        cfg, tok, make = _setup(state, cfgd, vocab)
        eng = RecognizerEngine(make(), cfg, tok, device="cpu",
                               mesh=P.make_mesh(world, mp))
        for m in ("ctc", "beam", "decoder", "auto"):
            r[m] = eng.recognize_batch(imgs, m, widths)
        r["crops"] = eng.recognize_crops(crops, "ctc", enhance=True,
                                         sharpen=sharpen)
        r["crops_decoder"] = eng.recognize_crops(crops, "decoder")
        for m in ("ctc", "decoder", "beam"):
            r[f"stream_{m}"] = _records(eng.stream_records_batch(imgs, m))
        for m in ("decoder", "beam"):
            r[f"stream_{m}_w2"] = _records(eng.stream_records_batch(
                imgs, m, window=2))
        enc = eng.encode_batch(imgs)
        r["encode"] = [None if t is None else t.numpy() for t in enc[:5]]
        r["encode_n"] = enc[5]
    if db is not None:
        out["db"] = db_steps(**db)
    return out


def db_steps(state, batch, steps=1):
    """The DB trainer's loop over every rank (data-parallel): each step's
    metrics and the net's state after."""
    from kiri_tpu_torch import parallel as P
    from kiri_tpu_torch.detect.db.net import DBNet
    from kiri_tpu_torch.detect.db.train import db_loss, run_steps

    mesh = None
    world = P.process_info()[1]
    if world > 1:
        mesh = P.make_mesh(world, 1)
    net = DBNet()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    opt = torch.optim.AdamW(net.parameters(), lr=2e-3, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    hist = []
    run_steps(net, [batch], steps, 0,
              lambda n, b: db_loss(n, b, k=50.0, alpha=1.0, beta=10.0,
                                   neg_ratio=3.0, mesh=mesh),
              opt, 5.0, None, lambda step, loss: None, 0, False, hist,
              mesh=mesh)
    return hist, _state(net)


def checkpoint(state, cfgd, vocab, batch, mp, root):
    """A step over the mesh, then ``save_sharded`` by every rank (weights
    and moments), ``restore_sharded`` onto the mesh and whole, and
    ``to_reference`` on rank 0."""
    from kiri_tpu_torch import parallel as P
    from kiri_tpu_torch.train import sharded_ckpt as S
    from kiri_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg, tok, make = _setup(state, cfgd, vocab)
    rank, world = P.process_info()
    tr = Trainer(cfg, tok, TrainConfig(n_devices=world, model_parallel=mp,
                                       lr=1e-3, warmup_steps=2),
                 model=make(), total_steps=10, device="cpu")
    tr.run_step(batch)
    S.save_sharded(root, tr.model, cfg, vocab_path=vocab, epoch=2, step=1,
                   best_val_acc=0.25, opt_state=tr.opt_state(whole=False))
    local, _, meta, opt = S.restore_sharded(root, mesh=tr.mesh,
                                            with_opt_state=True, device="cpu")
    whole, _, _, whole_opt = S.restore_sharded(root, with_opt_state=True,
                                               device="cpu")
    if rank == 0:
        S.to_reference(root, f"{root}/reference.safetensors")
    # The single-file checkpoint: gathered, written by rank 0, resumed by a
    # fresh trainer on the same mesh.
    tr.save(f"{root}/plain.safetensors", vocab)
    again = Trainer(cfg, tok, TrainConfig(n_devices=world, model_parallel=mp,
                                          lr=1e-3, warmup_steps=2),
                    model=make(), total_steps=10, device="cpu")
    resumed = again.resume(f"{root}/plain.safetensors")
    return {"local": _state(local), "mine": _state(tr.model),
            "resumed": resumed, "resumed_state": _state(again.model),
            "resumed_opt": again.opt_state(whole=False),
            "resumed_step": again.step,
            "whole": _state(whole), "expected": _state(tr.whole_model()),
            "opt": {k: np.asarray(v) for k, v in opt.items()},
            "my_opt": tr.opt_state(whole=False),
            "whole_opt": {k: np.asarray(v) for k, v in whole_opt.items()},
            "expected_opt": tr.opt_state(), "meta": meta}


def fail_on_rank_1():
    """Rank 1 raises; rank 0 waits for it in a collective."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("boom")
    dist.all_reduce(torch.zeros(1))


def train_loop_run(cfgd, vocab, train, val, tc):
    """``train_loop`` over every rank (the mesh from ``tc``; the model made
    from ``tc.seed``, as on one device): its history and the files in its
    output directory."""
    from pathlib import Path

    from kiri_tpu_torch.config import CFG
    from kiri_tpu_torch.tokenizer import CharTokenizer
    from kiri_tpu_torch.train.trainer import TrainConfig, train_loop

    cfg = CFG(**cfgd)
    tr = train_loop(cfg, CharTokenizer(vocab, cfg), TrainConfig(**tc), train,
                    val, vocab_path=vocab, verbose=False, device="cpu")
    return tr.history, sorted(p.name for p in Path(tc["out_dir"]).iterdir())
