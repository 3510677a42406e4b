"""Detection data structures (a copy of ``kiri_tpu/detect/base.py``)."""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import List, Tuple


class DetectionLevel(Enum):
    BLOCK = "block"
    PARAGRAPH = "paragraph"
    LINE = "line"
    WORD = "word"
    CHARACTER = "character"


@dataclass
class TextBox:
    x: int
    y: int
    width: int
    height: int
    confidence: float = 1.0
    level: DetectionLevel = DetectionLevel.LINE
    children: List["TextBox"] = field(default_factory=list)

    @property
    def bbox(self) -> Tuple[int, int, int, int]:
        return (self.x, self.y, self.width, self.height)

    @property
    def xyxy(self) -> Tuple[int, int, int, int]:
        return (self.x, self.y, self.x + self.width, self.y + self.height)

    @property
    def area(self) -> int:
        return self.width * self.height

    @property
    def center(self) -> Tuple[float, float]:
        return (self.x + self.width / 2, self.y + self.height / 2)

    @property
    def baseline_y(self) -> float:
        return self.y + self.height * 0.8

    def __repr__(self):
        return (f"TextBox({self.x}, {self.y}, {self.width}, {self.height}, "
                f"conf={self.confidence:.2f})")
