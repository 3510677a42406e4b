"""Model FLOP of the DB net's probability map on one canvas, from shapes:
every convolution and transposed convolution at 2 per multiply-add;
GroupNorm, ReLU, the nearest upsampling and the sigmoid left out.

Canvas H x W: the 3x3 stride-2 stem 1 -> 16 (H/2); per stage s (32, 64,
128, 256 channels at H/4 .. H/32) two blocks of two 3x3 convs, the first at
stride 2 with a 1x1 stride-2 shortcut; the four 1x1 laterals to 64 and four
3x3 64 -> 64 smoothing convs at their levels; the head's 3x3 256 -> 64 at
H/4, the 2x2 stride-2 transposed convs 64 -> 64 (to H/2) and 64 -> 1 (to H).
The threshold head serves only training and is not counted.
"""
from __future__ import annotations

STAGES = ((32, 2), (64, 2), (128, 2), (256, 2))
BUCKETS = (320, 448, 576, 704, 832, 960)
MAX_SIDE = 960
FPN = 64


def canvas(h: int, w: int):
    """The canvas (H, W) a page of h x w pixels runs at: long side at most
    960, each side rounded to a multiple of 32, then to its size bucket."""
    r = MAX_SIDE / max(h, w) if max(h, w) > MAX_SIDE else 1.0
    return tuple(next((b for b in BUCKETS if b >= s), BUCKETS[-1])
                 for s in (max(32, int(round(v * r / 32) * 32))
                           for v in (h, w)))


def conv(cin: int, cout: int, k: int, oh: int, ow: int) -> float:
    return 2.0 * cin * cout * k * k * oh * ow


def map_flop(h: int, w: int) -> float:
    f = conv(1, 16, 3, h // 2, w // 2)
    cin, scale = 16, 2
    for c, blocks in STAGES:
        scale *= 2
        oh, ow = h // scale, w // scale
        for b in range(blocks):
            f += conv(cin, c, 3, oh, ow) + conv(c, c, 3, oh, ow)
            if cin != c:
                f += conv(cin, c, 1, oh, ow)
            cin = c
        f += conv(c, FPN, 1, oh, ow) + conv(FPN, FPN, 3, oh, ow)
    q_h, q_w = h // 4, w // 4
    f += conv(4 * FPN, FPN, 3, q_h, q_w)
    f += 2.0 * FPN * FPN * 4 * q_h * q_w          # deconv to H/2
    f += 2.0 * FPN * 1 * 4 * (h // 2) * (w // 2)  # deconv to H
    return f
