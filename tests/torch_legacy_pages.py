"""Pages for the classic-CV detector's tests (tests/test_torch_cvops.py,
tests/test_torch_legacy.py): the six hard documents of
tests/test_legacy_hard_docs.py (normal, inverted, low-contrast, coloured,
textured, two polarities), one page over 1600 px (the detector scales it
down) and the committed smoke pages."""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

from test_legacy_hard_docs import _doc


def _two_polarities() -> np.ndarray:
    from PIL import Image, ImageDraw, ImageFont

    img = Image.new("L", (480, 360), 255)
    draw = ImageDraw.Draw(img)
    font = ImageFont.truetype(
        "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf", 26)
    for i in range(3):
        draw.text((30, 30 + i * 60), f"Dark body text line {i} here", fill=0,
                  font=font)
    draw.rectangle([0, 230, 480, 360], fill=25)
    for i in range(2):
        draw.text((30, 250 + i * 55), f"Light banner line {i} words",
                  fill=245, font=font)
    return np.asarray(img)


@lru_cache(maxsize=1)
def hard_docs() -> Dict[str, np.ndarray]:
    noisy = _doc(fg=0, bg=235)[0]
    rng = np.random.default_rng(0)
    noisy = np.clip(noisy.astype(np.int16)
                    + rng.integers(-25, 25, noisy.shape), 0, 255
                    ).astype(np.uint8)
    return {"normal": _doc(fg=0, bg=255)[0],
            "inverted": _doc(fg=255, bg=20)[0],
            "low_contrast": _doc(fg=120, bg=165)[0],
            "colored": _doc(fg=(40, 40, 200), bg=(250, 240, 120),
                            color=True)[0],
            "textured": noisy,
            "two_polarities": _two_polarities()}


@lru_cache(maxsize=1)
def large_page() -> np.ndarray:
    """A 1700x1240 colour page (over the detector's 1600 px side): two
    smoke pages placed on one canvas and tinted."""
    from kiri_tpu_torch.smoke import load_smoke_pages, tint

    pages = load_smoke_pages()["pages"]
    a, b = pages[0]["image"], pages[8]["image"]
    gray = np.zeros((1240, 1700), np.uint8) + 255
    gray[:640, :640] = a
    gray[600:1240, 1000:1640] = np.minimum(gray[600:1240, 1000:1640], b)
    return tint(gray)


def smoke_page_images() -> List[Tuple[str, np.ndarray]]:
    from kiri_tpu_torch.smoke import load_smoke_pages

    sp = load_smoke_pages()
    return ([(f"page{i}", p["image"]) for i, p in enumerate(sp["pages"])]
            + [(f"rot{i}", p["image"]) for i, p in enumerate(sp["rot_pages"])])
