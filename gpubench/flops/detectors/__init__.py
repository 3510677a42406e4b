"""A page configuration's detector FLOP, found by the name its
``detector.method`` gives: ``flops/detectors/<method>.py`` exposes

    page_flop(det: Dict, h: int, w: int) -> float

the net's model FLOP for an h x w page at the canvas the configuration
sizes it to. A new detector architecture is a new file here and one in
``reference/detectors/``.
"""
from __future__ import annotations

import importlib
from typing import Dict


def page_flop(det: Dict, h: int, w: int) -> float:
    mod = importlib.import_module(f"{__name__}.{det['method']}")
    return mod.page_flop(det, h, w)
