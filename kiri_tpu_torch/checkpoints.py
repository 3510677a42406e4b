"""Recognizer checkpoints in every format ``kiri_tpu`` loads, behind one
loader (the load half of ``kiri_tpu/train/checkpoints.py``; training writes
them with ``train/checkpoints.py``):

* ``<name>.safetensors`` with ``<name>_meta.json``: the config from the meta;
* ``<name>.safetensors`` alone: the config inferred from the tensor shapes
  (``convert.infer_cfg_from_state_dict``);
* any other suffix: a ``torch.save`` file, either the reference's
  ``{"config", "model", ...}`` dict or a bare state dict, the config then
  inferred from the shapes as well.

Every tensor is cast to float32. The machine with the card has no
``safetensors`` package, so the file is read and written here with numpy:
an 8-byte little-endian header length, a JSON header mapping each tensor
name to its dtype, shape and byte range, then the raw little-endian bytes.
The reader takes the dtypes ``safetensors.numpy`` reads; BF16, which numpy
has no type for, raises ``ValueError`` (``kiri_tpu`` raises ``KeyError``).
"""
from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .config import CFG
from .convert import infer_cfg_from_state_dict
from .device import resolve_device
from .models.recognizer import Recognizer

_DTYPES = {"F64": np.dtype("<f8"), "F32": np.dtype("<f4"),
           "F16": np.dtype("<f2"), "I64": np.dtype("<i8"),
           "U64": np.dtype("<u8"), "I32": np.dtype("<i4"),
           "U32": np.dtype("<u4"), "I16": np.dtype("<i2"),
           "U16": np.dtype("<u2"), "I8": np.dtype("i1"),
           "U8": np.dtype("u1"), "BOOL": np.dtype("?")}


def read_safetensors(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """All tensors of a ``.safetensors`` file as numpy arrays, in the
    file's own dtypes."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype "
                             f"{info['dtype']}")
        dtype = _DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        count = int(np.prod(info["shape"], dtype=np.int64))
        if end - start != count * dtype.itemsize or end > len(data):
            raise ValueError(f"{path}: tensor {name} has a bad byte range")
        out[name] = np.frombuffer(data, dtype, count, start).reshape(
            info["shape"]).astype(dtype.newbyteorder("="))
    return out


def write_safetensors(path: Union[str, Path],
                      tensors: Dict[str, np.ndarray]) -> str:
    """Write arrays (numpy or torch) of the reader's dtypes as ``path``, in
    name order, readable by ``read_safetensors`` and by the ``safetensors``
    package."""
    kinds = {v.newbyteorder("="): k for k, v in _DTYPES.items()}
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        v = tensors[name]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        v = np.asarray(v)
        if v.dtype not in kinds:
            raise ValueError(f"{name}: dtype {v.dtype} has no safetensors "
                             "type here")
        raw = np.ascontiguousarray(v, v.dtype.newbyteorder("<")).tobytes()
        header[name] = {"dtype": kinds[v.dtype], "shape": list(v.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
    return str(path)


def build_model(sd: Dict[str, np.ndarray], cfg: CFG) -> Recognizer:
    """A ``Recognizer`` holding the torch-named state dict ``sd`` (numpy or
    torch values), loaded by ``load_state``. The heads and the decoder's
    position table are made where ``sd`` has them, whatever ``cfg``
    says."""
    model = Recognizer(cfg, vocab_size=int(sd["dec_emb.weight"].shape[0]) - 3,
                       use_dec_pos_enc="dec_pos_enc.pe" in sd,
                       ctc_head="ctc_head.0.weight" in sd,
                       lm_head="lm_head.weight" in sd)
    load_state(model, sd)
    return model.eval()


def load_state(model: Recognizer, sd: Dict[str, Any]) -> None:
    """Copy ``sd`` into ``model`` in place with ``strict=True``, as
    ``kiri_tpu`` reads a state dict: the decoder's position table keeps the
    model's own values (``kiri_tpu`` ignores the file's) and a missing
    ``num_batches_tracked`` reads as 0."""
    own = model.state_dict()
    sd = dict(sd)
    for k in own:
        if k.endswith("num_batches_tracked") and k not in sd:
            sd[k] = own[k]
    if "dec_pos_enc.pe" in sd and "dec_pos_enc.pe" in own:
        sd["dec_pos_enc.pe"] = own["dec_pos_enc.pe"]
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()},
                          strict=True)


def _float32(sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Every tensor as float32 numpy (``num_batches_tracked``, which the
    model keeps as int64, as it is)."""
    out = {}
    for k, v in sd.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        v = np.asarray(v)
        out[k] = v if k.endswith("num_batches_tracked") else v.astype(
            np.float32)
    return out


def read_checkpoint(path: Union[str, Path], cfg: Optional[CFG] = None
                    ) -> Tuple[Dict[str, np.ndarray], CFG, Dict[str, Any]]:
    """(float32 state dict, cfg, meta dict) of a recognizer file in any of
    the formats above, with ``kiri_tpu``'s precedence: a given ``cfg`` wins
    over the meta's or the ``.pt``'s config, and the shapes are read over
    whichever config a meta-less file starts from."""
    path = str(path)
    meta: Dict[str, Any] = {}
    if path.endswith(".safetensors"):
        sd = read_safetensors(path)
        meta_path = Path(path[: -len(".safetensors")] + "_meta.json")
        if meta_path.exists():
            meta = json.loads(meta_path.read_text())
            cfg = CFG.from_dict(meta.get("config", {})) if cfg is None else cfg
        else:
            cfg = infer_cfg_from_state_dict(sd, cfg or CFG())
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(ckpt, dict) and "config" in ckpt:
            config_data = ckpt["config"]
            if not isinstance(config_data, dict):
                config_data = {k: v for k, v in vars(config_data).items()
                               if not k.startswith("_")}
            cfg = CFG.from_dict(config_data) if cfg is None else cfg
            state = ckpt["model"]
            meta = {"vocab_path": ckpt.get("vocab_path", ""),
                    "epoch": ckpt.get("epoch", 0),
                    "step": ckpt.get("step", 0)}
        else:
            state = ckpt
            cfg = cfg or CFG()
        sd = {k: v.detach().cpu().numpy() for k, v in state.items()}
        cfg = infer_cfg_from_state_dict(sd, cfg)
    return _float32(sd), cfg, meta


def load_checkpoint(path: Union[str, Path], cfg: Optional[CFG] = None,
                    device=None) -> Tuple[Recognizer, CFG, Dict[str, Any]]:
    """Load a recognizer file in any of the formats above.

    Returns (model on ``device``, cfg, the meta dict). ``device=None``
    means the card.
    """
    dev = resolve_device(device)
    sd, cfg, meta = read_checkpoint(path, cfg)
    return build_model(sd, cfg).to(dev), cfg, meta


def find_vocab_file(vocab_path: str, model_path: str) -> Optional[str]:
    """The vocab named in the meta, else one beside the model file."""
    model_dir = Path(model_path).parent
    candidates = [
        vocab_path or None,
        model_dir / Path(vocab_path).name if vocab_path else None,
        model_dir / "vocab.json",
        model_dir / "vocab_auto.json",
        model_dir / "vocab_char.json",
    ]
    for c in candidates:
        if c and Path(c).exists():
            return str(c)
    return None
