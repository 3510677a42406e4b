"""Tests of the benchmark itself (``python -m pytest gpubench/tests``).

They run on the CPU; the one marked ``card`` needs the card and skips
elsewhere. The harness's modules are importable as top-level names, and
the program from the checkout's root."""
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for p in (str(ROOT), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips "
                            "without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card machine)")
    return "cuda"
