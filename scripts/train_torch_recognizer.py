"""Train the flagship recognizer with the port on the card: the recipe of
``scripts/train_recognizer.py`` (its flags and defaults), run by
``kiri_tpu_torch.train.recipe`` (``--device cpu`` to train on the CPU;
``--no-fonts`` to draw with the pseudo-glyph pool only).

Usage: python scripts/train_torch_recognizer.py [--samples 20000]
           [--epochs 12] [--out-dir models] [--device cpu] [--no-fonts]
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kiri_tpu_torch.train.recipe import main  # noqa: E402

if __name__ == "__main__":
    main()
