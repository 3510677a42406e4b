"""Model FLOP of the v13 recognizer a line needs, from shapes: every
convolution and matrix product counted at 2 per multiply-add, elementwise
work, norms and softmax left out. Independent of how the program computes
it: padding rows and repeated passes are not counted.

Per line at width bucket W (T = W / 4 frames, D = 256, FF = 1024):
the stem (``stem.stem_convs``), each encoder layer (q/k/v and output
projections, the two attention products over T x T, the FFN), the CTC head
(D x C). With the decoder: the memory projection (D x D a frame) and each
decoder layer's cross-attention keys and values (2 D x D a frame), once a
line; then each output token, eos included, is one step at position p
(p + 1 keys): self-attention q/k/v and output projections, the products over
p + 1 keys, cross-attention's query and output projections and products
over T, the FFN, and the two output heads (decoder and LM, D x V each).

``cfg`` is the configuration's model dict with ``VOCAB``, the vocabulary's
size (<unk> included): C = VOCAB + 2 CTC classes, V = VOCAB + 3 decoder ids.
"""
from __future__ import annotations

from typing import Dict

from .stem import stem_convs


def encode_flop(cfg: Dict, width: int) -> float:
    d, ff = int(cfg["ENC_DIM"]), int(cfg["ENC_FF"])
    t = width // 4
    stem = sum(c["flop"] for c in stem_convs(1, int(cfg["IMG_H"]), width))
    layer = 2.0 * t * d * 3 * d + 2 * 2.0 * t * t * d + 2.0 * t * d * d \
        + 2 * 2.0 * t * d * ff
    ctc_classes = int(cfg["VOCAB"]) + 2
    return stem + int(cfg["ENC_LAYERS"]) * layer + 2.0 * t * d * ctc_classes


def decode_flop(cfg: Dict, width: int, tokens: int) -> float:
    """Decoder FLOP of ``tokens`` steps (the text's tokens and eos)."""
    d, ff, layers = int(cfg["DEC_DIM"]), int(cfg["DEC_FF"]), int(
        cfg["DEC_LAYERS"])
    t = width // 4
    v = int(cfg["VOCAB"]) + 3
    once = 2.0 * t * int(cfg["ENC_DIM"]) * d + layers * 2.0 * t * d * 2 * d
    steps = 0.0
    for p in range(tokens):
        per_layer = (2.0 * d * 3 * d + 2 * 2.0 * (p + 1) * d + 2.0 * d * d
                     + 2.0 * d * d + 2 * 2.0 * t * d + 2.0 * d * d
                     + 2 * 2.0 * d * ff)
        steps += layers * per_layer + 2 * 2.0 * d * v
    return once + steps


def line_flop(cfg: Dict, width: int, method: str, tokens: int = 0) -> float:
    f = encode_flop(cfg, width)
    if method in ("decoder", "accurate"):
        f += decode_flop(cfg, width, tokens)
    return f
