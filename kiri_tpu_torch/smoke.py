"""The committed smoke lines (``assets/smoke_lines.npz``, written by
``scripts/make_torch_smoke_lines.py``): 64 rendered bilingual line crops,
their host-preprocessed images, ground truth and the JAX package's CTC
texts, for checks on machines that have no text renderer."""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

SMOKE_LINES = Path(__file__).resolve().parent / "assets" / "smoke_lines.npz"


def load_smoke_lines() -> Tuple[Dict[str, np.ndarray], List[np.ndarray]]:
    """(every array of the file, the raw crops as a list of [h, w] u8)."""
    with np.load(SMOKE_LINES) as f:
        data = {k: f[k] for k in f.files}
    crops, o = [], 0
    for h, w in data["crop_shapes"]:
        crops.append(data["crops_flat"][o: o + h * w].reshape(h, w))
        o += h * w
    return data, crops
