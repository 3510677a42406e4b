"""Reading page images from files.

The port works on u8 numpy arrays and ships no image reader (the machine
with the card has neither cv2 nor PIL). A path is read through whichever of
the two can be imported at the time of the call.
"""
from __future__ import annotations

import importlib
from pathlib import Path
from typing import Optional, Union

import numpy as np


def imread_bgr(path: Union[str, Path]) -> Optional[np.ndarray]:
    """u8 BGR [H, W, 3] of an image file (None when it cannot be decoded),
    read by cv2 or else PIL; raises when neither can be imported."""
    try:
        cv2 = importlib.import_module("cv2")
        return cv2.imread(str(path))
    except ImportError:
        pass
    try:
        image = importlib.import_module("PIL.Image")
    except ImportError:
        raise RuntimeError(
            f"cannot read {path}: reading an image file needs cv2 or PIL, "
            "and neither can be imported here; pass the page as a u8 numpy "
            "array") from None
    try:
        with image.open(path) as im:
            return np.ascontiguousarray(np.asarray(im.convert("RGB"))[..., ::-1])
    except (OSError, ValueError):
        return None
