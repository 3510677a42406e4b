"""CRAFT detector training from a ``generate-detector`` directory: the port
of ``kiri_tpu/detect/craft/train.py``.

MSE of sigmoid(region) and sigmoid(affinity) against the Gaussian maps at
half resolution; global-norm clipping at ``grad_clip`` as optax computes it,
then Adam (betas (0.9, 0.999), eps 1e-8) at a constant rate; ``last`` and
``best`` checkpoints. The live document generator waits for the generators
item of ``ROADMAP.md``.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import torch

from ...data.docsynth import load_detector_batches
from ...device import resolve_device
from ..db.train import LIVE_GENERATOR, device_batches, run_steps
from .net import CRAFTNet


@dataclass
class CRAFTTrainConfig:
    """The JAX package's fields that training from a directory reads (the
    live generator's are left out until the generators are ported)."""

    steps: int = 2000
    batch_size: int = 8
    lr: float = 1e-4
    grad_clip: float = 5.0
    seed: int = 42
    out_dir: str = "checkpoints_craft"
    log_every: int = 50
    data_dir: Optional[str] = None


def craft_loss(net: CRAFTNet, batch: Dict[str, torch.Tensor]):
    """batch: image [B, H, W, 1], region_gt and affinity_gt [B, H/2, W/2].
    Returns (loss, {"loss": loss})."""
    region, affinity = net(batch["image"].permute(0, 3, 1, 2))
    loss = (((torch.sigmoid(region) - batch["region_gt"]) ** 2).mean()
            + ((torch.sigmoid(affinity) - batch["affinity_gt"]) ** 2).mean())
    return loss, {"loss": loss}


def train_craft(tc: CRAFTTrainConfig, verbose: bool = True,
                net: Optional[CRAFTNet] = None, device=None,
                history: Optional[List[Dict[str, float]]] = None
                ) -> CRAFTNet:
    """Train the CRAFT net on ``tc.data_dir``; writes ``last`` and ``best``
    ``.safetensors`` under ``tc.out_dir``. Returns the net."""
    from . import save_craft_checkpoint

    if not tc.data_dir:
        raise NotImplementedError(LIVE_GENERATOR)
    dev = resolve_device(device)
    if net is None:
        net = CRAFTNet().init_weights(torch.Generator().manual_seed(tc.seed))
    net = net.to(dev)
    if verbose:
        n = sum(p.numel() for p in net.parameters())
        print(f"CRAFT net: {n / 1e6:.2f}M params")
    pool = device_batches(load_detector_batches(tc.data_dir, "craft",
                                                tc.batch_size), dev)
    if verbose:
        print(f"Loaded {len(pool)} batches from {tc.data_dir}")
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
              tc.grad_clip, None, save, tc.log_every, verbose, history)
    return net
