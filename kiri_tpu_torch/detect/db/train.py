"""DB detector training: the port of ``kiri_tpu/detect/db/train.py``.

    L = L_prob (balanced BCE, hard negatives at neg_ratio : 1)
      + alpha * L_binary (dice on b = sigmoid(k (p - t)))
      + beta * L_thresh (L1 inside the border band)

Global-norm clipping at ``grad_clip`` as optax computes it, then AdamW
(betas (0.9, 0.999), eps 1e-8, decay on every parameter) under optax's
cosine decay to ``alpha=0.05`` of the peak, computed on the host.

``n_devices`` above 1 trains data-parallel, one process per device (joined
by ``kiri_tpu_torch.parallel.initialize``), where ``kiri_tpu``'s trainer
takes the field and runs on one device: every rank draws the same global
batch and keeps its rows. The DB net normalizes with GroupNorm, which holds
no batch statistics, so only the loss couples the rows: the positive count,
the hard negatives (the global top values, found from each rank's own top
values), the dice sums and the border-band count are taken over the global
batch, and each rank's loss term is its share, so that the gradients summed
over the ranks are one device's. The batch must divide by ``n_devices``;
rank 0 writes the checkpoint.

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
from ... import parallel as P
from ...train.trainer import clip_by_global_norm
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


def _global_top_sum(vals: torch.Tensor, m: int, mesh) -> torch.Tensor:
    """This rank's share of the sum of the global top ``m`` values of
    ``vals`` over the data axis (the whole sum without a mesh): each rank's
    own top m hold the global ones; the m-th largest of their union is the
    threshold, and values equal to it are taken in rank order, as one
    device's sorted top-k takes them from its rows in order."""
    if m == 0:
        return vals.sum() * 0.0
    top = torch.topk(vals, min(m, vals.numel()), sorted=True).values
    if mesh is None or mesh.data_size == 1:
        return top.sum()
    pad = top.new_full((m,), float("-inf"))
    pad[: top.numel()] = top.detach()
    union = torch.cat(P.gather_tensor(pad, mesh.data_group, mesh.data_size,
                                      mesh.data_index))
    t = torch.topk(union, m, sorted=True).values[-1]
    above = int((union > t).sum())
    ties = [int((p == t).sum()) for p in union.view(mesh.data_size, m)]
    before = sum(ties[: mesh.data_index])
    take = max(0, min(ties[mesh.data_index], m - above - before))
    mine = int((top > t).sum()) + take
    return top[:mine].sum()


def db_loss(net: DBNet, batch: Dict[str, torch.Tensor], *, k: float,
            alpha: float, beta: float, neg_ratio: float, mesh=None):
    """batch: image [B, H, W, 1] float32 in [-1, 1], prob_gt, thresh_gt,
    tmask [B, H, W]. Returns (loss, metrics as 0-d tensors).

    The hard negatives are the top min(#negatives, neg_ratio * #positives)
    of the negatives' BCE, at most N // 4 of them (N pixels, a static
    count as in the JAX package).

    Over ``mesh`` the batch is this rank's rows of the global batch (every
    rank as many) and the loss is this rank's term: the terms of all ranks
    add up to the global loss, and the sums that couple the rows go through
    ``parallel.data_sum``, whose backward adds every rank's gradient, so
    the gradients summed over the ranks are the global batch's. The
    metrics are the global batch's."""
    dp = 1 if mesh is None else mesh.data_size
    prob, thresh = net(batch["image"].permute(0, 3, 1, 2), train=True)
    gt = batch["prob_gt"]
    eps = 1e-6
    bce = -(gt * torch.log(prob + eps) + (1 - gt) * torch.log(1 - prob + eps))
    pos = gt > 0.5
    counts = P.data_sum_value(torch.stack([pos.sum(), (~pos).sum()]), mesh)
    n_pos = counts[0].clamp(min=1)
    n_neg = torch.minimum(counts[1], (neg_ratio * n_pos).long())
    pos_part = torch.where(pos, bce, 0.0).sum() / n_pos
    neg_vals = torch.where(pos, float("-inf"), bce).reshape(-1)
    m = min(int(n_neg), neg_vals.numel() * dp // 4)
    neg_part = _global_top_sum(neg_vals, m, mesh) / n_neg.clamp(min=1)

    b = torch.sigmoid(k * (prob - thresh))
    sums = P.data_sum(torch.stack([(b * gt).sum(), b.sum(), gt.sum()]), mesh)
    l_bin = 1.0 - 2.0 * sums[0] / (sums[1] + sums[2] + eps)

    tm = batch["tmask"]
    thr_part = ((thresh - batch["thresh_gt"]).abs() * tm).sum() / \
        P.data_sum_value(tm.sum(), mesh).clamp(min=1.0)

    part = pos_part + neg_part + alpha * l_bin / dp + beta * thr_part
    l_prob = P.data_sum_value(pos_part + neg_part, mesh)
    l_thr = P.data_sum_value(thr_part, mesh)
    loss = l_prob + alpha * l_bin + beta * l_thr
    return part, {"loss": loss, "prob_loss": l_prob, "bin_loss": l_bin,
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
              fresh: Optional[Callable[[], Dict]] = None,
              mesh=None) -> None:
    """The detector trainers' loop: a batch of ``pool`` drawn by
    ``default_rng(seed)`` each step (``fresh()`` when the pool is empty;
    a host batch is uploaded to the net's device), loss, clip, optimizer
    step (at ``schedule(step)`` when given), all in float32 without TF32;
    ``save(step, loss)`` every 500 steps and at the last; each step's
    metrics appended to ``history``. Over ``mesh`` each rank keeps its rows
    of the batch and the gradients are summed over the data axis."""
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
        if mesh is not None:
            batch = P.shard_batch_global(batch, mesh)
        if any(isinstance(v, np.ndarray) for v in batch.values()):
            batch = to_device(batch, dev)
        with no_tf32():
            loss, metrics = loss_fn(net, batch)
            loss.backward()
        P.sync_gradients(grads, mesh)
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
            save(step, float(metrics["loss"].detach()))
    if history is not None and kept:
        history.extend(dict(zip(keys, row))
                       for row in torch.stack(kept).tolist())


def train_db(tc: DBTrainConfig, verbose: bool = True,
             net: Optional[DBNet] = None, device=None,
             history: Optional[List[Dict[str, float]]] = None) -> DBNet:
    """Train the DB net on ``tc.data_dir`` or the live generator (from
    scratch, seeded by ``tc.seed``, unless ``net`` is given) on the card
    unless ``device`` says otherwise; writes ``<out_dir>/detector.safetensors``.
    ``tc.n_devices`` above 1: data-parallel over the ranks of
    ``parallel.initialize``. Returns the net."""
    from . import save_db_checkpoint
    from ...train.trainer import TrainConfig, train_mesh

    mesh = train_mesh(TrainConfig(n_devices=tc.n_devices))
    if mesh is not None and tc.batch_size % mesh.data_size:
        raise ValueError(f"batch_size {tc.batch_size} does not divide over "
                         f"{mesh.data_size} devices")
    writer = mesh is None or mesh.rank == 0
    verbose = verbose and writer
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
                       neg_ratio=tc.neg_ratio, mesh=mesh)

    def save(step, loss):
        if writer:
            save_db_checkpoint(out / "detector.safetensors", net)

    run_steps(net, pool, tc.steps, tc.seed, loss_fn, optimizer, tc.grad_clip,
              cosine_decay_schedule(tc.lr, tc.steps, alpha=0.05), save,
              tc.log_every, verbose, history, fresh, mesh)
    return net
