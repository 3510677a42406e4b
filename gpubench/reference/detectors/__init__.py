"""A page configuration's reference detector, found by the name its
``detector.method`` gives (the program's ``det_method``):
``reference/detectors/<method>.py`` exposes

    load(det: Dict, root: Path, device, control: bool = False)

which returns an object whose ``boxes(page)`` gives the reference's own
boxes of a u8 page in reading order, ``[{"box": (x, y, w, h), "score":
float}]``. ``control=True`` loads the reference one precision step below
the configuration (the control of ``control.py``). A new detector
architecture is a new file here and one in ``flops/detectors/``.
"""
from __future__ import annotations

import importlib
from pathlib import Path
from typing import Dict


def load(det: Dict, root: Path, device, control: bool = False):
    mod = importlib.import_module(f"{__name__}.{det['method']}")
    return mod.load(det, root, device, control)
