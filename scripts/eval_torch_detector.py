"""The port's detector accuracy on synthetic data: ``scripts/eval_detector.py``'s
flags, defaults and JSON lines, run by ``kiri_tpu_torch.evaluate`` on the
card (``--device cpu`` to run on the CPU; ``--no-fonts`` to draw with the
pseudo-glyph pool only).

Usage: python scripts/eval_torch_detector.py [flags of scripts/eval_detector.py]
           [--device cpu] [--no-fonts]
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kiri_tpu_torch.evaluate import detector_main  # noqa: E402

if __name__ == "__main__":
    detector_main()
