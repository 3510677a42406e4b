"""The recognizer as an ``nn.Module``: CNN stem + Transformer encoder + CTC
head, with the decoder's parameters held for the decode paths (the port of
``kiri_tpu/models/recognizer.py``, inference only).

Submodule and parameter names are the checkpoint's own torch names
(``stem.net.{0..11}``, ``enc.layers.i.*``, ``ctc_head.{0,2}``, ``mem_proj``,
``dec_emb``, ``dec.layers.i.*``, ``dec_ln``, ``dec_head``, ``lm_head``,
``dec_pos_enc.pe``), so ``load_state_dict(strict=True)`` takes a committed
``.safetensors`` file as it is. The forward math is the functions of
``layers.py`` over these parameters; the stem goes through
``kernels.stem.stem_fused`` on weights folded once (``Stem.folded``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..kernels.stem import STRIDES, FoldedStem, StemWeightCache, stem_fused
from ..ops.preprocess import normalize_u8
from . import layers as L

STEM_CHANNELS = (48, 96, 160)   # the last block goes to ENC_DIM


class Stem(nn.Module):
    def __init__(self, enc_dim: int):
        super().__init__()
        chans = (1,) + STEM_CHANNELS + (enc_dim,)
        mods = []
        for i, stride in enumerate(STRIDES):
            mods += [nn.Conv2d(chans[i], chans[i + 1], 3, stride, 1,
                               bias=False),
                     nn.BatchNorm2d(chans[i + 1]), nn.SiLU()]
        self.net = nn.Sequential(*mods)
        self._folded = StemWeightCache()

    def folded(self, dtype: torch.dtype) -> FoldedStem:
        """The BN-folded weights for ``dtype`` on the parameters' device,
        folded once and again only after the parameters or buffers change."""
        return self._folded.get(self.net, dtype)


class Attention(nn.Module):
    """Parameters of ``nn.MultiheadAttention`` (fused q/k/v projection)."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)


class EncoderLayer(nn.Module):
    def __init__(self, dim: int, ff: int):
        super().__init__()
        self.self_attn = Attention(dim)
        self.linear1 = nn.Linear(dim, ff)
        self.linear2 = nn.Linear(ff, dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)


class DecoderLayer(nn.Module):
    def __init__(self, dim: int, ff: int):
        super().__init__()
        self.self_attn = Attention(dim)
        self.multihead_attn = Attention(dim)
        self.linear1 = nn.Linear(dim, ff)
        self.linear2 = nn.Linear(ff, dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)


class Stack(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class PositionTable(nn.Module):
    def __init__(self, length: int, dim: int):
        super().__init__()
        self.register_buffer(
            "pe", torch.from_numpy(L.sinusoid_table(length, dim))[None])


@functools.lru_cache(maxsize=16)
def _pos_enc_2d(h: int, w: int, c: int) -> torch.Tensor:
    return torch.from_numpy(L.pos_enc_2d(h, w, c))


class Recognizer(nn.Module):
    """``vocab_size`` counts the tokenizer's characters (with <unk>): the
    CTC head has vocab_size + 2 classes and the decoder vocab_size + 3."""

    def __init__(self, cfg, vocab_size: int, use_dec_pos_enc: bool = True):
        super().__init__()
        d, dd = cfg.ENC_DIM, cfg.DEC_DIM
        self.enc_heads = cfg.ENC_HEADS
        self.stem = Stem(d)
        self.enc_ln_in = nn.LayerNorm(d)
        self.enc = Stack(EncoderLayer(d, cfg.ENC_FF)
                         for _ in range(cfg.ENC_LAYERS))
        self.enc_ln = nn.LayerNorm(d)
        if cfg.USE_CTC:
            # Index 1 is the training-time Dropout, which holds no weights.
            self.ctc_head = nn.Sequential(nn.LayerNorm(d),
                                          nn.Dropout(cfg.DROPOUT),
                                          nn.Linear(d, vocab_size + 2))
        self.mem_proj = nn.Linear(d, dd, bias=False)
        self.dec_emb = nn.Embedding(vocab_size + 3, dd)
        if use_dec_pos_enc:
            self.dec_pos_enc = PositionTable(cfg.MAX_DEC_LEN + 10, dd)
        self.dec = Stack(DecoderLayer(dd, cfg.DEC_FF)
                         for _ in range(cfg.DEC_LAYERS))
        self.dec_ln = nn.LayerNorm(dd)
        self.dec_head = nn.Linear(dd, vocab_size + 3)
        if cfg.USE_LM:
            self.lm_head = nn.Linear(dd, vocab_size + 3)

    def encode(self, images: torch.Tensor, dtype: torch.dtype
               ) -> torch.Tensor:
        """u8 [B, H, W] (or [B, 1, H, W]), or lines already normalized to
        [-1, 1], -> encoder memory [B, W/4, D] in ``dtype``: stem -> 2D
        position table -> mean over height -> LN -> encoder -> LN."""
        if images.dim() == 4:
            images = images[:, 0]
        x = (normalize_u8(images, dtype) if images.dtype == torch.uint8
             else images.to(dtype))
        feat = stem_fused(x, self.stem.folded(dtype))
        _, h, w, c = feat.shape
        feat = feat + _pos_enc_2d(h, w, c).to(feat.device, dtype)
        seq = feat.mean(dim=1)
        seq = L.layer_norm(seq, self.enc_ln_in.weight, self.enc_ln_in.bias)
        for layer in self.enc.layers:
            seq = L.encoder_layer(layer, seq, self.enc_heads)
        return L.layer_norm(seq, self.enc_ln.weight, self.enc_ln.bias)

    def ctc_logits(self, mem: torch.Tensor) -> torch.Tensor:
        """CTC head (LN -> Linear), float32 logits [B, T, C]."""
        ln, proj = self.ctc_head[0], self.ctc_head[2]
        h = L.layer_norm(mem, ln.weight, ln.bias)
        return L.dense(h, proj.weight, proj.bias).float()

    def mem_project(self, mem: torch.Tensor) -> torch.Tensor:
        return L.dense(mem, self.mem_proj.weight)
