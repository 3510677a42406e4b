"""DB: the probability map's FLOP on the page's canvas
(``flops/dbnet.py``)."""
from __future__ import annotations

from typing import Dict

from .. import dbnet


def page_flop(det: Dict, h: int, w: int) -> float:
    return dbnet.map_flop(*dbnet.canvas(h, w))
