"""Sharded checkpoints on ``torch.distributed.checkpoint``: the port of
``kiri_tpu/train/sharded_ckpt.py``.

Every rank writes only its shards, and a restore onto a mesh reads each
rank's shards straight into their place, so neither gathers the model.
Layout on disk, as ``kiri_tpu``'s:

    <dir>/state/           the DCP files: "model.<torch name>" for each
                           tensor of the state dict and, optionally,
                           "opt_state.<torch name>.<moment>" for AdamW's
                           exp_avg / exp_avg_sq / step; a tensor sharded
                           over the model axis is stored as its M shards,
                           "<key>@<i>of<M>"
    <dir>/kiri_meta.json   config, vocab_path, epoch, step, best_val_acc,
                           use_dec_pos_enc, has_opt_state, framework
                           ("kiri_tpu_torch"); rank 0 writes it

``kiri_tpu``'s ``state/`` is an orbax (OCDBT) tree and this one a DCP tree:
neither package reads the other's (the card machine has no orbax). The
two meet at ``to_reference``'s single ``.safetensors`` file, which both
packages' loaders read.
"""
from __future__ import annotations

import json
import re
import warnings
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from .. import parallel as P
from ..checkpoints import load_state
from ..config import CFG
from ..device import resolve_device
from ..models.recognizer import Recognizer

_SHARD = re.compile(r"^(.*)@(\d+)of(\d+)$")


def _dcp():
    import torch.distributed.checkpoint as dcp

    return dcp


def _quiet(fn, *args, **kwargs):
    """A DCP call with ``no_dist`` meant: its warning that it assumes one
    process is left out."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*single process.*")
        return fn(*args, **kwargs)


def save_sharded(ckpt_dir, model: Recognizer, cfg: CFG, vocab_path: str = "",
                 epoch: int = 0, step: int = 0, best_val_acc: float = 0.0,
                 opt_state: Optional[Dict[str, Any]] = None) -> None:
    """Write a sharded checkpoint of ``model`` (a ``Recognizer``, whole or
    placed on a mesh by ``parallel.shard_variables``). Every rank of the
    process group calls it; each writes its own shards (a tensor its data
    axis holds more than once is written once). ``opt_state``: the
    trainer's ``opt_state(whole=False)`` (moments by torch name, this rank's
    shards)."""
    ckpt_dir = Path(ckpt_dir).resolve()
    mesh = getattr(model, "mesh", None)
    specs = getattr(model, "shard_specs", {})
    mp, m = (1, 0) if mesh is None else (mesh.model_size, mesh.model_index)

    def key(prefix: str, name: str, spec_name: str) -> str:
        spec = specs.get(spec_name)
        split = spec is not None and spec.dim is not None and mp > 1
        return f"{prefix}.{name}" + (f"@{m}of{mp}" if split else "")

    state = {key("model", k, k): v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    if opt_state is not None:
        for k, v in opt_state.items():
            name, _, moment = k.rpartition(".")
            shard_name = name if moment in ("exp_avg", "exp_avg_sq") else ""
            state[key("opt_state", k, shard_name)] = torch.as_tensor(v).clone()
    rank, world = P.process_info()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    _quiet(_dcp().save, state, checkpoint_id=str(ckpt_dir / "state"),
           no_dist=world == 1)
    if rank == 0:
        meta = {
            "config": cfg.to_dict(),
            "vocab_path": str(vocab_path),
            "epoch": int(epoch),
            "step": int(step),
            "best_val_acc": float(best_val_acc),
            "use_dec_pos_enc": hasattr(model, "dec_pos_enc"),
            "has_opt_state": opt_state is not None,
            "framework": "kiri_tpu_torch",
        }
        (ckpt_dir / "kiri_meta.json").write_text(json.dumps(meta, indent=2))
    if world > 1:
        torch.distributed.barrier()


def _stored(ckpt_dir: Path) -> Dict[str, Dict[str, Any]]:
    """{key without its shard suffix: {"shards": M, "meta": {i: storage
    metadata}}} of the stored tensors."""
    reader = _dcp().FileSystemReader(str(ckpt_dir / "state"))
    out: Dict[str, Dict[str, Any]] = {}
    for k, md in reader.read_metadata().state_dict_metadata.items():
        hit = _SHARD.match(k)
        base, i, count = (hit.group(1), int(hit.group(2)),
                          int(hit.group(3))) if hit else (k, 0, 1)
        entry = out.setdefault(base, {"shards": count, "meta": {}})
        entry["meta"][i] = md
    return out


def _read(ckpt_dir: Path, wanted: Dict[str, torch.Tensor]) -> None:
    """Fill the tensors of ``wanted`` (by stored key) from the files; each
    process reads on its own (no collective)."""
    _quiet(_dcp().load, wanted, checkpoint_id=str(ckpt_dir / "state"),
           no_dist=True)


def restore_sharded(ckpt_dir, mesh=None, with_opt_state: bool = False,
                    device=None) -> Tuple[Recognizer, CFG, Dict[str, Any],
                                          Optional[Dict[str, torch.Tensor]]]:
    """Restore a sharded checkpoint: (model, cfg, meta dict, opt_state or
    None). With ``mesh`` the model comes placed on it (``parallel.
    shard_variables``'s layout): where the checkpoint's shards are the
    mesh's, each rank reads only its own; otherwise the whole tensors are
    read and cut. ``opt_state`` (moments by torch name, this rank's shards
    over a mesh) only with ``with_opt_state`` and where one was saved.
    ``device=None`` means the card."""
    ckpt_dir = Path(ckpt_dir).resolve()
    meta = json.loads((ckpt_dir / "kiri_meta.json").read_text())
    cfg = CFG.from_dict(meta.get("config", {}))
    stored = _stored(ckpt_dir)
    mp, m = (1, 0) if mesh is None else (mesh.model_size, mesh.model_index)

    def pieces(base: str, only: Optional[int] = None):
        """The stored pieces of a key (its shards in order, or the one
        tensor), or only shard ``only``."""
        entry = stored[base]
        n = entry["shards"]
        idx = range(n) if only is None else [only]
        keys = {i: base if n == 1 else f"{base}@{i}of{n}" for i in idx}
        bufs = {keys[i]: torch.empty(tuple(entry["meta"][i].size),
                                     dtype=entry["meta"][i].properties.dtype)
                for i in idx}
        _read(ckpt_dir, bufs)
        return [bufs[keys[i]] for i in idx]

    def shape(name):
        return tuple(stored[f"model.{name}"]["meta"][0].size)

    # A skeleton at the checkpoint's shapes, placed on the mesh first, so
    # that each tensor's local shape and spec are known before reading.
    vocab = shape("dec_emb.weight")[0] - 3
    skeleton = Recognizer(cfg, vocab,
                          use_dec_pos_enc="model.dec_pos_enc.pe" in stored,
                          ctc_head="model.ctc_head.0.weight" in stored,
                          lm_head="model.lm_head.weight" in stored)
    model = skeleton if mesh is None else P.shard_variables(skeleton, mesh)
    specs = P.variable_shardings(skeleton, mesh) if mesh is not None else {}

    def local(base: str, name: str) -> torch.Tensor:
        """This rank's part of a stored tensor of parameter ``name``."""
        spec = specs.get(name)
        split = spec is not None and spec.dim is not None and mp > 1
        n = stored[base]["shards"]
        if split and n == mp:
            return pieces(base, m)[0]
        got = pieces(base)
        whole = got[0] if n == 1 else P.join_shards(
            got, P.param_spec(name, got[0].dim()))
        return P.local_shard(whole, spec, m, mp) if split else whole

    sd = {name: local(f"model.{name}", name)
          for name in model.state_dict()}
    load_state(model, sd)
    model = model.to(resolve_device(device)).eval()

    opt_state = None
    if with_opt_state and meta.get("has_opt_state"):
        opt_state = {}
        for base in stored:
            if not base.startswith("opt_state."):
                continue
            k = base[len("opt_state."):]
            name, _, moment = k.rpartition(".")
            opt_state[k] = (local(base, name)
                            if moment in ("exp_avg", "exp_avg_sq")
                            else pieces(base)[0])
    return model, cfg, meta, opt_state


def to_reference(ckpt_dir, out_path, vocab_path: str = "") -> None:
    """Convert a sharded checkpoint to the single-file ``.safetensors``
    (with its ``_meta.json``) that both packages' loaders read."""
    from .checkpoints import save_checkpoint

    model, cfg, meta, _ = restore_sharded(ckpt_dir, device="cpu")
    save_checkpoint(out_path, model, cfg,
                    vocab_path=vocab_path or meta.get("vocab_path", ""),
                    epoch=meta.get("epoch", 0), step=meta.get("step", 0),
                    best_val_acc=meta.get("best_val_acc", 0.0))
