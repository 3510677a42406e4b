"""The stem's least time: a frozen copy of ``_stem_convs`` and ``_bound_ms``
of chip_smoke.py at commit 0bc739aac3bff3542a3b3238ea9226e557ccfdbd, with
the folded weights' shapes written out (conv0's weights float32, convs 1-3
in bfloat16, every bias float32; [9 * Cin, Cout] each).

The bf16 stem (``stem_conv01_kernel`` + ``stem_layer_kernel``) takes
normalised bf16 lines [B, 48, W] and writes bf16 [B, 6, W / 4, 256]: conv0
runs on the CUDA cores at the float32 rate, convs 1-3 on the tensor cores at
the bf16 rate; the input, the weights and the output move once.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from . import PEAK_BF16, PEAK_BYTES, PEAK_F32

STRIDES = ((1, 1), (2, 2), (2, 2), (2, 1))
CHANNELS = (1, 48, 96, 160, 256)


def stem_convs(batch: int, h: int, w: int) -> List[Dict]:
    """Per conv of the stem on [batch, h, w] lines: its FLOP, the values it
    reads and writes, and the bytes of its weights and bias."""
    convs, n_in = [], batch * h * w
    for i, (sh, sw) in enumerate(STRIDES):
        cin, cout = CHANNELS[i], CHANNELS[i + 1]
        h, w = (h - 1) // sh + 1, (w - 1) // sw + 1
        n_out = batch * h * w * cout
        convs.append({"flop": 2.0 * n_out * 9 * cin, "n_in": n_in,
                      "n_out": n_out, "conv0": i == 0,
                      "w_bytes": 9 * cin * cout * (4 if i == 0 else 2)
                      + 4 * cout})
        n_in = n_out
    return convs


def bound_s(convs: List[Dict], in_size: int = 2,
            peak_convs: float = PEAK_BF16) -> Tuple[float, float]:
    """(operations s, bytes s) of the convs run as one function: conv0 at
    the float32 rate, the others at ``peak_convs``; the first one's input,
    the weights and the last one's output moved once."""
    ops = sum(c["flop"] / PEAK_F32 if c["conv0"] else c["flop"] / peak_convs
              for c in convs)
    nbytes = ((convs[0]["n_in"] + convs[-1]["n_out"]) * in_size
              + sum(c["w_bytes"] for c in convs))
    return ops, nbytes / PEAK_BYTES


def least_s(rows: int, width: int, height: int = 48) -> float:
    """The least time of the bf16 stem over ``rows`` lines of one width
    bucket: the larger of its two bounds."""
    return max(bound_s(stem_convs(rows, height, width)))
