"""DB detector training: the port of ``kiri_tpu/detect/db/train.py``.

    L = L_prob (balanced BCE, hard negatives at neg_ratio : 1)
      + alpha * L_binary (dice on b = sigmoid(k (p - t)))
      + beta * L_thresh (L1 inside the border band)

Global-norm clipping at ``grad_clip`` as optax computes it, then AdamW
(betas (0.9, 0.999), eps 1e-8, decay on every parameter) under optax's
cosine decay to ``alpha=0.05`` of the peak, computed on the host. One card.

The batches come from a ``generate-detector`` directory (``data_dir``,
uploaded to the card once) or from the live document generator: a pool of
``pool_size`` documents made on the host before the first step (a fresh
batch every step when 0), each drawn batch uploaded to the card. A
document is degraded by a robustness condition with probability
``aug_conditions``; its ground truth is rasterized after the condition.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ...data.docsynth import (DocumentGenerator, apply_condition,
                              db_ground_truth, load_detector_batches)
from ...device import no_tf32, resolve_device
from ...train.trainer import MULTI_DEVICE, clip_by_global_norm
from .net import DBNet


@dataclass
class DBTrainConfig:
    """The JAX package's training configuration."""

    steps: int = 2000
    batch_size: int = 8
    lr: float = 2e-3
    weight_decay: float = 1e-4
    grad_clip: float = 5.0
    image_size: int = 640
    k: float = 50.0          # DB binarization steepness
    alpha: float = 1.0       # binary (dice) weight
    beta: float = 10.0       # threshold L1 weight
    neg_ratio: float = 3.0   # OHEM negative:positive
    seed: int = 42
    khmer_ratio: float = 0.3   # fraction of Khmer lines in synthetic docs
    out_dir: str = "checkpoints_db"
    log_every: int = 50
    n_devices: Optional[int] = None
    # Documents generated before the first step and drawn from at random
    # (0: a fresh batch every step).
    pool_size: int = 512
    # Probability of degrading a document with a robustness condition.
    aug_conditions: float = 0.0
    # Per-condition sampling weights (name -> weight, 1.0 when unlisted).
    aug_weights: Optional[Dict[str, float]] = None
    # A generate-detector directory: batches from disk instead.
    data_dir: Optional[str] = None


_TRAIN_CONDITIONS = ("rotated", "noisy", "textured", "low_contrast")
# "inverted" is absent: inference normalizes polarity up front.


def pick_condition(rng, weights: Optional[Dict[str, float]] = None) -> str:
    """Sample a training condition, optionally weighted (uniform default)."""
    if weights:
        w = [float(weights.get(c, 1.0)) for c in _TRAIN_CONDITIONS]
        return rng.choices(_TRAIN_CONDITIONS, weights=w)[0]
    return rng.choice(_TRAIN_CONDITIONS)


def make_batch(gen: DocumentGenerator, batch_size: int,
               size: int, aug_conditions: float = 0.0,
               aug_weights: Optional[Dict[str, float]] = None,
               ) -> Dict[str, np.ndarray]:
    """One host batch of ``batch_size`` fresh documents: image [B, S, S, 1]
    in [-1, 1], prob_gt, thresh_gt, tmask [B, S, S] (float32)."""
    imgs = np.zeros((batch_size, size, size, 1), np.float32)
    probs = np.zeros((batch_size, size, size), np.float32)
    threshs = np.zeros((batch_size, size, size), np.float32)
    tmasks = np.zeros((batch_size, size, size), np.float32)
    for i in range(batch_size):
        doc = gen.generate()
        if aug_conditions and gen.rng.random() < aug_conditions:
            doc = apply_condition(doc, pick_condition(gen.rng, aug_weights),
                                  gen.rng)
        img = doc["image"].astype(np.float32)
        imgs[i, :, :, 0] = (img / 255.0 - 0.5) / 0.5
        p, t, m = db_ground_truth(doc["image"].shape, doc["lines"])
        probs[i], threshs[i], tmasks[i] = p, t, m
    return {"image": imgs, "prob_gt": probs, "thresh_gt": threshs,
            "tmask": tmasks}


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


def to_device(batch: Dict[str, np.ndarray], device
              ) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def batch_source(tc, kind: str, make, device, verbose: bool):
    """(pool, fresh) for ``run_steps``: the directory's batches on the
    card, or the live pool of ``tc.pool_size`` documents (host batches
    from ``make()``, uploaded when drawn), or no pool and ``fresh``."""
    if tc.data_dir:
        pool = [to_device(b, device) for b in
                load_detector_batches(tc.data_dir, kind, tc.batch_size)]
        if verbose:
            print(f"Loaded {len(pool)} batches from {tc.data_dir}")
        return pool, None
    pool = []
    if tc.pool_size:
        if verbose:
            print(f"Pre-generating {tc.pool_size} documents...")
        for _ in range((tc.pool_size + tc.batch_size - 1) // tc.batch_size):
            pool.append(make())
    return pool, make


def run_steps(net: torch.nn.Module, pool, steps: int, seed: int, loss_fn,
              optimizer: torch.optim.Optimizer, grad_clip: float,
              schedule: Optional[Callable[[int], float]], save,
              log_every: int, verbose: bool,
              history: Optional[List[Dict[str, float]]],
              fresh: Optional[Callable[[], Dict]] = None) -> None:
    """The detector trainers' loop: a batch of ``pool`` drawn by
    ``default_rng(seed)`` each step (``fresh()`` when the pool is empty;
    a host batch is uploaded to the net's device), loss, clip, optimizer
    step (at ``schedule(step)`` when given), all in float32 without TF32;
    ``save(step, loss)`` every 500 steps and at the last; each step's
    metrics appended to ``history``."""
    params = [p for p in net.parameters()]
    for p in params:
        p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    nprng = np.random.default_rng(seed)
    kept = []
    t0 = time.time()
    dev = params[0].device
    for step in range(steps):
        batch = pool[int(nprng.integers(len(pool)))] if pool else fresh()
        if any(isinstance(v, np.ndarray) for v in batch.values()):
            batch = to_device(batch, dev)
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
    """Train the DB net on ``tc.data_dir`` or the live generator (from
    scratch, seeded by ``tc.seed``, unless ``net`` is given) on the card
    unless ``device`` says otherwise; writes ``<out_dir>/detector.safetensors``.
    Returns the net."""
    from . import save_db_checkpoint

    if (tc.n_devices or 1) > 1:
        raise NotImplementedError(MULTI_DEVICE)
    dev = resolve_device(device)
    if net is None:
        net = DBNet().init_weights(torch.Generator().manual_seed(tc.seed))
    net = net.to(dev)
    if verbose:
        n = sum(p.numel() for p in net.parameters())
        print(f"DB net: {n / 1e6:.2f}M params")
    make = None
    if not tc.data_dir:
        gen = DocumentGenerator(tc.image_size, tc.image_size, seed=tc.seed,
                                khmer_ratio=tc.khmer_ratio)

        def make():
            return make_batch(gen, tc.batch_size, tc.image_size,
                              tc.aug_conditions, tc.aug_weights)

    pool, fresh = batch_source(tc, "db", make, dev, verbose)
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
              tc.log_every, verbose, history, fresh)
    return net
