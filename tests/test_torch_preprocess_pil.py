"""The reference-exact PIL input path of the port
(``kiri_tpu_torch/ops/preprocess.py``: ``ResizeKeepRatioPadNoCrop``,
``preprocess_pil``, ``preprocess_pil_u8``) against kiri_tpu's, array for
array (exact), and the module's import without Pillow."""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from kiri_tpu.config import CFG as JCFG
from kiri_tpu.ops import preprocess as JP
from kiri_tpu_torch.config import CFG
from kiri_tpu_torch.ops import preprocess as P

REPO = Path(__file__).resolve().parent.parent
SHAPES = [(30, 100), (48, 640), (48, 700), (80, 200), (10, 1000), (1, 3),
          (200, 40)]


def _image(hw, mode, seed):
    rng = np.random.default_rng(seed)
    shape = hw + ((3,) if mode == "RGB" else (4,) if mode == "RGBA" else ())
    return Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_preprocess_pil_is_kiri_tpus(mode):
    for i, hw in enumerate(SHAPES):
        for size in ((48, 640), (32, 320)):
            kw = dict(IMG_H=size[0], IMG_W=size[1])
            cfg, jcfg = CFG(**kw), JCFG(**kw)
            img = _image(hw, mode, i)
            got, want = P.preprocess_pil(cfg, img), JP.preprocess_pil(jcfg,
                                                                      img)
            assert got.dtype == want.dtype == np.float32
            assert got.shape == (1, 1) + size
            np.testing.assert_array_equal(got, want)
            got8 = P.preprocess_pil_u8(cfg, img)
            np.testing.assert_array_equal(got8, JP.preprocess_pil_u8(jcfg,
                                                                     img))
            assert got8.dtype == np.uint8


def test_transform_is_kiri_tpus():
    """The transform alone, on "L" images, with the empty-image branch."""
    for i, hw in enumerate(SHAPES):
        img = _image(hw, "L", 10 + i)
        got = P.ResizeKeepRatioPadNoCrop(48, 320)(img)
        want = JP.ResizeKeepRatioPadNoCrop(48, 320)(img)
        assert got.size == want.size and got.mode == want.mode
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    empty = Image.new("L", (0, 5))
    assert P.ResizeKeepRatioPadNoCrop(48, 320)(empty).size == (320, 48)


def test_module_imports_without_pillow():
    """Importing the module does not import PIL; with PIL unimportable the
    module and the port still import, and the PIL path says it needs
    Pillow."""
    code = (
        "import sys\n"
        "import kiri_tpu_torch, kiri_tpu_torch.ops.preprocess as P\n"
        "assert 'PIL' not in sys.modules, 'imported PIL'\n"
        "sys.modules['PIL'] = None\n"
        "class Im:\n"
        "    size = (10, 10)\n"
        "    def convert(self, m): return self\n"
        "from kiri_tpu_torch.config import CFG\n"
        "try:\n"
        "    P.preprocess_pil_u8(CFG(), Im())\n"
        "except RuntimeError as e:\n"
        "    assert 'Pillow' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('no error')\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
