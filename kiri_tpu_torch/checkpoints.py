"""Checkpoint loading: torch-named ``.safetensors`` weights + ``_meta.json``
(the load half of ``kiri_tpu/train/checkpoints.py``; training writes them
with ``train/checkpoints.py``).

The machine with the card has no ``safetensors`` package, so the file is
read and written here with numpy: an 8-byte little-endian header length, a
JSON header mapping each tensor name to its dtype, shape and byte range,
then the raw little-endian bytes. Only F32 and I64 occur.
"""
from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .config import CFG
from .device import resolve_device
from .models.recognizer import Recognizer

_DTYPES = {"F32": np.dtype("<f4"), "I64": np.dtype("<i8")}


def read_safetensors(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """All tensors of a ``.safetensors`` file as numpy arrays (F32 and I64,
    the types the checkpoints of this project hold)."""
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
    """Write float32 and int64 arrays (numpy or torch) as ``path``, in name
    order, readable by ``read_safetensors`` and by the ``safetensors``
    package."""
    kinds = {v: k for k, v in _DTYPES.items()}
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        v = tensors[name]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        v = np.asarray(v)
        if v.dtype not in kinds:
            raise ValueError(f"{name}: dtype {v.dtype} is neither float32 "
                             "nor int64")
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
    torch values), loaded with ``strict=True``."""
    model = Recognizer(cfg, vocab_size=int(sd["dec_emb.weight"].shape[0]) - 3,
                       use_dec_pos_enc="dec_pos_enc.pe" in sd)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()},
                          strict=True)
    return model.eval()


def load_checkpoint(path: Union[str, Path], device=None
                    ) -> Tuple[Recognizer, CFG, Dict[str, Any]]:
    """Load ``<name>.safetensors`` and its ``<name>_meta.json``.

    Returns (model on ``device``, cfg from the meta, the meta dict).
    ``device=None`` means the card.
    """
    dev = resolve_device(device)
    cfg, meta = read_meta(path)
    return build_model(read_safetensors(path), cfg).to(dev), cfg, meta


def read_meta(path: Union[str, Path]) -> Tuple[CFG, Dict[str, Any]]:
    """(cfg, meta dict) of ``<name>.safetensors`` from its
    ``<name>_meta.json``."""
    path = str(path)
    if not path.endswith(".safetensors"):
        raise ValueError(f"{path}: only .safetensors checkpoints are read")
    meta_path = Path(path[: -len(".safetensors")] + "_meta.json")
    if not meta_path.exists():
        raise FileNotFoundError(f"{meta_path} not found: the model's "
                                "configuration is read from it")
    meta = json.loads(meta_path.read_text())
    return CFG.from_dict(meta.get("config", {})), meta


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
