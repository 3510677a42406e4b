"""The FLOP and byte counts against hand counts at one shape."""
import json

import pytest

from flops import dbnet, detectors, recognizer, stem
from harness import spec
from traffic import make

CFG = dict(json.loads((spec.HERE / "configs" / "kiri-ocr-v13.json")
                      .read_text())["model"], VOCAB=208)


def test_stem_hand_count():
    # One line 48 x 160: conv0 1->48 at 48x160, conv1 48->96 at 24x80,
    # conv2 96->160 at 12x40, conv3 160->256 at 6x40.
    hand = 2 * 9 * (1 * 48 * 48 * 160 + 48 * 96 * 24 * 80
                    + 96 * 160 * 12 * 40 + 160 * 256 * 6 * 40)
    assert sum(c["flop"] for c in stem.stem_convs(1, 48, 160)) == hand
    # 128 lines at 640, the bound of PERF.md's kernel table (0.2935 ms).
    ops, nbytes = stem.bound_s(stem.stem_convs(128, 48, 640))
    assert stem.least_s(128, 640) == ops
    assert ops * 1e3 == pytest.approx(0.29346, rel=1e-4)
    assert nbytes < ops


def test_recognizer_hand_count():
    w, t, d, ff = 320, 80, 256, 1024
    stem_f = sum(c["flop"] for c in stem.stem_convs(1, 48, w))
    layer = (2 * t * d * 3 * d + 2 * 2 * t * t * d + 2 * t * d * d
             + 2 * 2 * t * d * ff)
    hand = stem_f + 4 * layer + 2 * t * d * 210
    assert recognizer.encode_flop(CFG, w) == hand
    assert recognizer.line_flop(CFG, w, "ctc", 7) == hand
    # Two decoder steps (one token and eos) over T = 80 frames.
    once = 2 * t * d * d + 3 * 2 * t * d * 2 * d
    steps = 0
    for p in range(2):
        steps += 3 * (2 * d * 3 * d + 2 * 2 * (p + 1) * d + 2 * d * d
                      + 2 * d * d + 2 * 2 * t * d + 2 * d * d
                      + 2 * 2 * d * ff) + 2 * 2 * d * 211
    assert recognizer.line_flop(CFG, w, "decoder", 2) == hand + once + steps


def test_dbnet_hand_count():
    h = w = 64
    conv = dbnet.conv
    f = conv(1, 16, 3, 32, 32)
    f += (conv(16, 32, 3, 16, 16) + conv(32, 32, 3, 16, 16)
          + conv(16, 32, 1, 16, 16) + 2 * conv(32, 32, 3, 16, 16)
          + conv(32, 64, 1, 16, 16) + conv(64, 64, 3, 16, 16))
    for c0, c, s in ((32, 64, 8), (64, 128, 4), (128, 256, 2)):
        f += (conv(c0, c, 3, s, s) + conv(c, c, 3, s, s)
              + conv(c0, c, 1, s, s) + 2 * conv(c, c, 3, s, s)
              + conv(c, 64, 1, s, s) + conv(64, 64, 3, s, s))
    f += conv(256, 64, 3, 16, 16) + 2 * 64 * 64 * 4 * 16 * 16
    f += 2 * 64 * 4 * 32 * 32
    assert dbnet.map_flop(h, w) == f
    assert dbnet.canvas(1280, 960) == (960, 704)
    assert dbnet.canvas(640, 640) == (704, 704)
    assert dbnet.canvas(960, 1280) == (704, 960)


def test_db_page_flop_is_the_nets_on_its_canvas():
    det = json.loads((spec.HERE / "configs" / "kiri-ocr-v13-db.json")
                     .read_text())["detector"]
    sizes = make.load_mix("pages-batch")["sizes"]
    assert len(sizes) == 32
    for w, h in sizes:
        assert detectors.page_flop(det, h, w) == dbnet.map_flop(
            *dbnet.canvas(h, w))
