"""DB: the reference net's u16 map (``reference/detector.py``, TF32 on for
the control) and the boxes drawn from it (``reference/boxes.py``)."""
from __future__ import annotations

from pathlib import Path
from typing import Dict

from ..boxes import page_boxes
from ..detector import RefDB


class DB:
    def __init__(self, det: Dict, root: Path, device, control: bool = False):
        self.det = det
        self.net = RefDB(root / det["checkpoint"], device, tf32=control)

    def boxes(self, page):
        return page_boxes(self.net.u16_map(page), page, self.det)


load = DB
