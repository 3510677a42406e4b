"""CRAFT detector training: the port of ``kiri_tpu/detect/craft/train.py``.

MSE of sigmoid(region) and sigmoid(affinity) against the Gaussian maps at
half resolution; global-norm clipping at ``grad_clip`` as optax computes it,
then Adam (betas (0.9, 0.999), eps 1e-8) at a constant rate; ``last`` and
``best`` checkpoints. The batches come from a ``generate-detector``
directory or the live document pool, as in ``detect/db/train.py``; with
``scale_aug`` a document is rendered small by one of the generators of
``scale_aug_factors`` (sharing the main generator's fonts), degraded at that
scale and resized up to ``image_size``, as a magnifying serving path
presents text.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...data.docsynth import (DocumentGenerator, apply_condition,
                              craft_ground_truth, rescale_doc)
from ...device import resolve_device
from ..db.train import batch_source, pick_condition, run_steps
from .net import CRAFTNet


@dataclass
class CRAFTTrainConfig:
    """The JAX package's training configuration."""

    steps: int = 2000
    batch_size: int = 8
    lr: float = 1e-4
    grad_clip: float = 5.0
    image_size: int = 640
    seed: int = 42
    khmer_ratio: float = 0.3   # fraction of Khmer lines in synthetic docs
    out_dir: str = "checkpoints_craft"
    log_every: int = 50
    pool_size: int = 256
    # Probability of degrading a document with a robustness condition.
    aug_conditions: float = 0.0
    # Per-condition sampling weights (see db.train.pick_condition).
    aug_weights: Optional[Dict[str, float]] = None
    # Probability of a document rendered small and resized up to
    # image_size, by a factor of scale_aug_factors.
    scale_aug: float = 0.0
    scale_aug_factors: Tuple[float, ...] = (1.5, 2.0)
    # A generate-detector directory: batches from disk instead.
    data_dir: Optional[str] = None


def craft_loss(net: CRAFTNet, batch: Dict[str, torch.Tensor]):
    """batch: image [B, H, W, 1], region_gt and affinity_gt [B, H/2, W/2].
    Returns (loss, {"loss": loss})."""
    region, affinity = net(batch["image"].permute(0, 3, 1, 2))
    loss = (((torch.sigmoid(region) - batch["region_gt"]) ** 2).mean()
            + ((torch.sigmoid(affinity) - batch["affinity_gt"]) ** 2).mean())
    return loss, {"loss": loss}


def make_batch(gen: DocumentGenerator, batch_size: int, size: int,
               aug_conditions: float = 0.0,
               aug_weights: Optional[Dict[str, float]] = None,
               scale_aug: float = 0.0,
               scale_gens: Optional[List[DocumentGenerator]] = None,
               ) -> Dict[str, np.ndarray]:
    """One host batch: image [B, S, S, 1] in [-1, 1], region_gt and
    affinity_gt [B, S/2, S/2] (float32)."""
    half = size // 2
    imgs = np.zeros((batch_size, size, size, 1), np.float32)
    regions = np.zeros((batch_size, half, half), np.float32)
    affs = np.zeros((batch_size, half, half), np.float32)
    for i in range(batch_size):
        if scale_aug and scale_gens and gen.rng.random() < scale_aug:
            # Render small, degrade at native scale, then upscale.
            small = scale_gens[gen.rng.randrange(len(scale_gens))]
            doc = small.generate()
            if aug_conditions and gen.rng.random() < aug_conditions:
                doc = apply_condition(
                    doc, pick_condition(gen.rng, aug_weights), gen.rng)
            doc = rescale_doc(doc, size, size)
        else:
            doc = gen.generate()
            if aug_conditions and gen.rng.random() < aug_conditions:
                doc = apply_condition(
                    doc, pick_condition(gen.rng, aug_weights), gen.rng)
        img = doc["image"].astype(np.float32)
        imgs[i, :, :, 0] = (img / 255.0 - 0.5) / 0.5
        region, aff = craft_ground_truth(doc["image"].shape, doc["chars"])
        regions[i] = region[::2, ::2]
        affs[i] = aff[::2, ::2]
    return {"image": imgs, "region_gt": regions, "affinity_gt": affs}


def scale_generators(tc: CRAFTTrainConfig, gen: DocumentGenerator
                     ) -> Optional[List[DocumentGenerator]]:
    """The small-scale generators of ``tc.scale_aug_factors`` (seeds
    ``seed + 17 i``, the main generator's fonts), or None."""
    if not tc.scale_aug:
        return None
    return [DocumentGenerator(int(round(tc.image_size / f)),
                              int(round(tc.image_size / f)),
                              seed=tc.seed + 17 * i, fonts=gen.fonts,
                              khmer_ratio=tc.khmer_ratio)
            for i, f in enumerate(tc.scale_aug_factors, 1)]


def train_craft(tc: CRAFTTrainConfig, verbose: bool = True,
                net: Optional[CRAFTNet] = None, device=None,
                history: Optional[List[Dict[str, float]]] = None
                ) -> CRAFTNet:
    """Train the CRAFT net on ``tc.data_dir`` or the live generator;
    writes ``last`` and ``best`` ``.safetensors`` under ``tc.out_dir``.
    Returns the net."""
    from . import save_craft_checkpoint

    dev = resolve_device(device)
    if net is None:
        net = CRAFTNet().init_weights(torch.Generator().manual_seed(tc.seed))
    net = net.to(dev)
    if verbose:
        n = sum(p.numel() for p in net.parameters())
        print(f"CRAFT net: {n / 1e6:.2f}M params")
    make = None
    if not tc.data_dir:
        gen = DocumentGenerator(tc.image_size, tc.image_size, seed=tc.seed,
                                khmer_ratio=tc.khmer_ratio)
        scale_gens = scale_generators(tc, gen)

        def make():
            return make_batch(gen, tc.batch_size, tc.image_size,
                              tc.aug_conditions, tc.aug_weights,
                              tc.scale_aug, scale_gens)

    pool, fresh = batch_source(tc, "craft", make, dev, verbose)
    optimizer = torch.optim.Adam(net.parameters(), lr=tc.lr,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 fused=dev.type == "cuda" or None)
    out = Path(tc.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    best = [float("inf")]

    def save(step, loss):
        save_craft_checkpoint(out / "last.safetensors", net)
        if loss < best[0]:
            best[0] = loss
            save_craft_checkpoint(out / "best.safetensors", net)

    run_steps(net, pool, tc.steps, tc.seed, craft_loss, optimizer,
              tc.grad_clip, None, save, tc.log_every, verbose, history,
              fresh)
    return net
