"""DB detector training from a ``generate-detector`` directory: the port of
``kiri_tpu/detect/db/train.py``.

    L = L_prob (balanced BCE, hard negatives at neg_ratio : 1)
      + alpha * L_binary (dice on b = sigmoid(k (p - t)))
      + beta * L_thresh (L1 inside the border band)

Global-norm clipping at ``grad_clip`` as optax computes it, then AdamW
(betas (0.9, 0.999), eps 1e-8, decay on every parameter) under optax's
cosine decay to ``alpha=0.05`` of the peak, computed on the host. The live
document generator (no ``data_dir``) draws text with PIL and waits for the
generators item of ``ROADMAP.md``; one card only.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ...data.docsynth import load_detector_batches
from ...device import no_tf32, resolve_device
from ...train.trainer import MULTI_DEVICE, clip_by_global_norm
from .net import DBNet

LIVE_GENERATOR = ("training from the live document generator is not ported "
                  "yet (ROADMAP.md queue 1, the generators item): pass a "
                  "generate-detector directory (--data-yaml / data_dir)")


@dataclass
class DBTrainConfig:
    """The JAX package's fields that training from a directory reads (the
    live generator's are left out until the generators are ported)."""

    steps: int = 2000
    batch_size: int = 8
    lr: float = 2e-3
    weight_decay: float = 1e-4
    grad_clip: float = 5.0
    k: float = 50.0          # DB binarization steepness
    alpha: float = 1.0       # binary (dice) weight
    beta: float = 10.0       # threshold L1 weight
    neg_ratio: float = 3.0   # OHEM negative:positive
    seed: int = 42
    out_dir: str = "checkpoints_db"
    log_every: int = 50
    n_devices: Optional[int] = None
    data_dir: Optional[str] = None


def db_loss(net: DBNet, batch: Dict[str, torch.Tensor], *, k: float,
            alpha: float, beta: float, neg_ratio: float):
    """batch: image [B, H, W, 1] float32 in [-1, 1], prob_gt, thresh_gt,
    tmask [B, H, W]. Returns (loss, metrics as 0-d tensors).

    The hard negatives are the top N // 4 of the negatives' BCE (N pixels,
    a static count as in the JAX package), of which the first
    min(#negatives, neg_ratio * #positives) count."""
    prob, thresh = net(batch["image"].permute(0, 3, 1, 2), train=True)
    gt = batch["prob_gt"]
    eps = 1e-6
    bce = -(gt * torch.log(prob + eps) + (1 - gt) * torch.log(1 - prob + eps))
    pos = gt > 0.5
    n_pos = pos.sum().clamp(min=1)
    n_neg = torch.minimum((~pos).sum(), (neg_ratio * n_pos).long())
    pos_loss = torch.where(pos, bce, 0.0).sum() / n_pos
    neg_vals = torch.where(pos, float("-inf"), bce).reshape(-1)
    k_neg = neg_vals.numel() // 4
    top_neg = torch.topk(neg_vals, k_neg, sorted=True).values
    rank = torch.arange(k_neg, device=top_neg.device)
    neg_loss = (torch.where(rank < n_neg, top_neg, 0.0).sum()
                / n_neg.clamp(min=1))
    l_prob = pos_loss + neg_loss

    b = torch.sigmoid(k * (prob - thresh))
    l_bin = 1.0 - 2.0 * (b * gt).sum() / (b.sum() + gt.sum() + eps)

    tm = batch["tmask"]
    l_thr = ((thresh - batch["thresh_gt"]).abs() * tm).sum() / \
        tm.sum().clamp(min=1.0)

    loss = l_prob + alpha * l_bin + beta * l_thr
    return loss, {"loss": loss, "prob_loss": l_prob, "bin_loss": l_bin,
                  "thresh_loss": l_thr}


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule`` on the host, in float32 as its jitted
    form computes it."""
    f32 = np.float32

    def schedule(count: int) -> float:
        c = f32(min(count, decay_steps))
        cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay_steps)))
        return float(f32(init_value) * (f32(1 - alpha) * cos + f32(alpha)))

    return schedule


def device_batches(batches: List[Dict[str, np.ndarray]], device
                   ) -> List[Dict[str, torch.Tensor]]:
    return [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
            for b in batches]


def run_steps(net: torch.nn.Module, pool, steps: int, seed: int, loss_fn,
              optimizer: torch.optim.Optimizer, grad_clip: float,
              schedule: Optional[Callable[[int], float]], save,
              log_every: int, verbose: bool,
              history: Optional[List[Dict[str, float]]]) -> None:
    """The detector trainers' loop: a batch of ``pool`` drawn by
    ``default_rng(seed)`` each step, loss, clip, optimizer step (at
    ``schedule(step)`` when given), all in float32 without TF32;
    ``save(step, loss)`` every 500 steps and at the last; each step's
    metrics appended to ``history``."""
    params = [p for p in net.parameters()]
    for p in params:
        p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    nprng = np.random.default_rng(seed)
    kept = []
    t0 = time.time()
    for step in range(steps):
        batch = pool[int(nprng.integers(len(pool)))]
        with no_tf32():
            loss, metrics = loss_fn(net, batch)
            loss.backward()
        clip_by_global_norm(grads, grad_clip)
        if schedule is not None:
            for group in optimizer.param_groups:
                group["lr"] = schedule(step)
        optimizer.step()
        torch._foreach_zero_(grads)
        keys = sorted(metrics)
        kept.append(torch.stack([metrics[k].detach() for k in keys]))
        if verbose and log_every and (step + 1) % log_every == 0:
            m = dict(zip(keys, kept[-1].tolist()))
            print(f"  step {step + 1}/{steps} "
                  + " ".join(f"{k}={v:.5f}" for k, v in m.items())
                  + f" ({time.time() - t0:.0f}s)")
        if (step + 1) % 500 == 0 or step + 1 == steps:
            save(step, float(loss))
    if history is not None and kept:
        history.extend(dict(zip(keys, row))
                       for row in torch.stack(kept).tolist())


def train_db(tc: DBTrainConfig, verbose: bool = True,
             net: Optional[DBNet] = None, device=None,
             history: Optional[List[Dict[str, float]]] = None) -> DBNet:
    """Train the DB net on ``tc.data_dir`` (from scratch, seeded by
    ``tc.seed``, unless ``net`` is given) on the card unless ``device`` says
    otherwise; writes ``<out_dir>/detector.safetensors``. Returns the net."""
    from . import save_db_checkpoint

    if not tc.data_dir:
        raise NotImplementedError(LIVE_GENERATOR)
    if (tc.n_devices or 1) > 1:
        raise NotImplementedError(MULTI_DEVICE)
    dev = resolve_device(device)
    if net is None:
        net = DBNet().init_weights(torch.Generator().manual_seed(tc.seed))
    net = net.to(dev)
    if verbose:
        n = sum(p.numel() for p in net.parameters())
        print(f"DB net: {n / 1e6:.2f}M params")
    pool = device_batches(load_detector_batches(tc.data_dir, "db",
                                                tc.batch_size), dev)
    if verbose:
        print(f"Loaded {len(pool)} batches from {tc.data_dir}")
    optimizer = torch.optim.AdamW(net.parameters(), lr=tc.lr,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=tc.weight_decay,
                                  fused=dev.type == "cuda" or None)
    out = Path(tc.out_dir)
    out.mkdir(parents=True, exist_ok=True)

    def loss_fn(n, batch):
        return db_loss(n, batch, k=tc.k, alpha=tc.alpha, beta=tc.beta,
                       neg_ratio=tc.neg_ratio)

    run_steps(net, pool, tc.steps, tc.seed, loss_fn, optimizer, tc.grad_clip,
              cosine_decay_schedule(tc.lr, tc.steps, alpha=0.05),
              lambda step, loss: save_db_checkpoint(
                  out / "detector.safetensors", net),
              tc.log_every, verbose, history)
    return net
