"""Transformer building blocks as functions over torch tensors, the port of
``kiri_tpu/models/layers.py`` (inference only).

Parameters keep torch's layout (``nn.Linear`` weights are [out, in]; the
attention projections are the fused ``in_proj_weight`` [3D, D] split into
q/k/v thirds). The numerics follow the JAX package: matmuls run in the
compute dtype of the activations, LayerNorm and softmax in float32, attention
scores and the attention-weighted sum accumulate in float32, GELU is exact.
Attention is written out as matmul -> softmax -> matmul, as the JAX package
writes it.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ weight.T (+ bias) in x's dtype; the bias is added in float32."""
    y = F.linear(x, weight.to(x.dtype))
    if bias is not None:
        y = (y.float() + bias.float()).to(x.dtype)
    return y


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32, output back in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(x.dtype)


def mha(q_in: torch.Tensor, kv_in: torch.Tensor, in_proj_weight: torch.Tensor,
        in_proj_bias: torch.Tensor, out_weight: torch.Tensor,
        out_bias: torch.Tensor, n_heads: int,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full (non-cached) multi-head attention over [B, T, D] inputs.

    ``mask`` broadcasts to [B, heads, Tq, Tk]; True = masked out.
    """
    b, tq, d = q_in.shape
    tk = kv_in.shape[1]
    hd = d // n_heads
    wq, wk, wv = in_proj_weight.split(d)
    bq, bk, bv = in_proj_bias.split(d)
    q = dense(q_in, wq, bq).view(b, tq, n_heads, hd).transpose(1, 2)
    k = dense(kv_in, wk, bk).view(b, tk, n_heads, hd).transpose(1, 2)
    v = dense(kv_in, wv, bv).view(b, tk, n_heads, hd).transpose(1, 2)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
    if mask is not None:
        scores = scores.masked_fill(mask, float("-inf"))
    attn = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.matmul(attn.float(), v.float()).to(q.dtype)   # [B, H, Tq, hd]
    out = out.transpose(1, 2).reshape(b, tq, d)
    return dense(out, out_weight, out_bias)


def ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
        w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    return dense(F.gelu(dense(x, w1, b1)), w2, b2)


def encoder_layer(layer, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Pre-norm GELU encoder layer over an ``EncoderLayer`` module's
    parameters (torch ``TransformerEncoderLayer(norm_first=True)`` names)."""
    a = layer.self_attn
    h = layer_norm(x, layer.norm1.weight, layer.norm1.bias)
    x = x + mha(h, h, a.in_proj_weight, a.in_proj_bias, a.out_proj.weight,
                a.out_proj.bias, n_heads)
    h = layer_norm(x, layer.norm2.weight, layer.norm2.bias)
    return x + ffn(h, layer.linear1.weight, layer.linear1.bias,
                   layer.linear2.weight, layer.linear2.bias)


def sinusoid_table(length: int, dim: int) -> np.ndarray:
    """pe[pos, 0::2] = sin(pos*div), pe[pos, 1::2] = cos(pos*div)."""
    pos = np.arange(length, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                 * (-math.log(10000.0) / dim))
    pe = np.zeros((length, dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def pos_enc_2d(h: int, w: int, c: int) -> np.ndarray:
    """2D sinusoid table [h, w, c]: the first half of the channels encodes
    y, the second half x."""
    num = c // 2
    out = np.zeros((h, w, c), dtype=np.float32)
    if num == 0:
        return out
    out[:, :, :num] = sinusoid_table(h, num)[:, None, :]
    out[:, :, num:2 * num] = sinusoid_table(w, num)[None, :, :]
    return out
