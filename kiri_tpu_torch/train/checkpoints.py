"""Training checkpoints: the save half of ``kiri_tpu/train/checkpoints.py``.

* ``<name>.safetensors``: the model's state dict under its torch names, the
  keys and shapes of ``kiri_tpu/utils/convert.py::to_torch_state_dict``
  (``num_batches_tracked`` written as 0, as the JAX package writes it), so
  the file loads in either package;
* ``<name>_meta.json``: the JAX package's keys (config, vocab_path, epoch,
  step, best_val_acc, framework);
* ``<name>_optim_torch.npz``: the AdamW moments and step count of each
  trained parameter under its torch name, and the dropout generator's state.
  The JAX package restores its own ``_optim.npz`` by leaf count and shape,
  which could take a transposed moment without complaint, so the port writes
  a file of another name: the JAX package resumes a port checkpoint with
  fresh moments, and the port one of the JAX package's likewise.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..checkpoints import write_safetensors


def _stem(path: Union[str, Path]) -> str:
    path = str(path)
    if not path.endswith(".safetensors"):
        raise ValueError(f"{path}: checkpoints are .safetensors files")
    return path[: -len(".safetensors")]


def state_arrays(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The model's state dict as float32 numpy arrays, the BatchNorm
    counters as int64 zeros."""
    out = {}
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            out[k] = np.asarray(0, np.int64)
        else:
            out[k] = v.detach().float().cpu().numpy()
    return out


def save_checkpoint(path, model: torch.nn.Module, cfg, vocab_path: str = "",
                    epoch: int = 0, step: int = 0, best_val_acc: float = 0.0,
                    opt_state: Optional[Dict[str, np.ndarray]] = None
                    ) -> None:
    """Write ``path`` (``.safetensors``), its ``_meta.json`` and, given
    ``opt_state`` (arrays by name), its ``_optim_torch.npz``."""
    stem = _stem(path)
    write_safetensors(path, state_arrays(model))
    meta = {"config": cfg.to_dict(), "vocab_path": str(vocab_path),
            "epoch": int(epoch), "step": int(step),
            "best_val_acc": float(best_val_acc),
            "framework": "kiri_tpu_torch"}
    Path(stem + "_meta.json").write_text(json.dumps(meta, indent=2))
    if opt_state is not None:
        np.savez(stem + "_optim_torch.npz", **opt_state)


def load_opt_state(path) -> Optional[Dict[str, Any]]:
    """The arrays of ``save_checkpoint``'s ``_optim_torch.npz`` beside
    ``path``, None when there is none."""
    npz = Path(_stem(path) + "_optim_torch.npz")
    if not npz.exists():
        return None
    with np.load(npz) as f:
        return {k: f[k] for k in f.files}
