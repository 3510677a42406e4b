"""The reference's own reader of ``.safetensors`` files: the 8-byte header
length, the JSON header, then each tensor's bytes at its offsets. Only the
dtypes the committed checkpoints hold are read."""
from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict

import numpy as np

_DTYPES = {"F32": np.float32, "F16": np.float16, "F64": np.float64,
           "I64": np.int64, "I32": np.int32}


def read_safetensors(path) -> Dict[str, np.ndarray]:
    raw = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8: 8 + n])
    body = memoryview(raw)[8 + n:]
    out = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        lo, hi = info["data_offsets"]
        arr = np.frombuffer(body[lo:hi], dtype=_DTYPES[info["dtype"]])
        out[key] = arr.reshape(info["shape"]).copy()
    return out
