"""The committed smoke lines (``assets/smoke_lines.npz``, written by
``scripts/make_torch_smoke_lines.py``): 64 rendered bilingual line crops,
their host-preprocessed images, ground truth and the JAX package's answers,
and 16 of the crops degraded for the enhancement path, for checks on
machines that have no text renderer."""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

SMOKE_LINES = Path(__file__).resolve().parent / "assets" / "smoke_lines.npz"


def _split(flat: np.ndarray, shapes: np.ndarray) -> List[np.ndarray]:
    """Row-major crops concatenated in ``flat`` -> a list of [h, w]."""
    crops, o = [], 0
    for h, w in shapes:
        crops.append(flat[o: o + h * w].reshape(h, w))
        o += h * w
    return crops


def load_smoke_lines() -> Tuple[Dict[str, np.ndarray], List[np.ndarray]]:
    """(every array of the file, the raw crops as a list of [h, w] u8)."""
    with np.load(SMOKE_LINES) as f:
        data = {k: f[k] for k in f.files}
    return data, _split(data["crops_flat"], data["crop_shapes"])


def noisy_crops(data: Dict[str, np.ndarray]
                ) -> Tuple[List[np.ndarray], np.ndarray]:
    """(the degraded crops as a list of [h, w] u8, their sharpen mask)."""
    return (_split(data["noisy_crops_flat"], data["noisy_crop_shapes"]),
            data["noisy_sharpen"])
