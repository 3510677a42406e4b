"""Transformer building blocks as functions over torch tensors, the port of
``kiri_tpu/models/layers.py`` (inference only).

Parameters keep torch's layout (``nn.Linear`` weights are [out, in]; the
attention projections are the fused ``in_proj_weight`` [3D, D] split into
q/k/v thirds). The numerics follow the JAX package: matmuls run in the
compute dtype of the activations, LayerNorm and softmax in float32, attention
scores and the attention-weighted sum accumulate in float32, GELU is exact.
Attention is written out as matmul -> softmax -> matmul, as the JAX package
writes it. The decoder has a whole-sequence layer (``decoder_layer``) and a
one-position layer over a K/V cache (``decoder_step_layer``), where the step
counter is a host integer: the cache is written in place at it and read up
to it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ weight.T (+ bias) in x's dtype. A bias of x's dtype goes into the
    matmul (one launch); a float32 bias under a bf16 x is added in float32."""
    if bias is None or bias.dtype == x.dtype:
        return F.linear(x, weight.to(x.dtype), bias)
    return (F.linear(x, weight.to(x.dtype)).float() + bias).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32, output back in x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], weight, bias, eps).to(x.dtype)


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


def decoder_layer(layer, x: torch.Tensor, mem: torch.Tensor, n_heads: int,
                  causal_mask: torch.Tensor) -> torch.Tensor:
    """Pre-norm decoder layer over a whole sequence: self-attention under
    ``causal_mask`` -> cross-attention over ``mem`` -> FFN (a ``DecoderLayer``
    module's parameters, torch ``TransformerDecoderLayer(norm_first=True)``
    names)."""
    a, c = layer.self_attn, layer.multihead_attn
    h = layer_norm(x, layer.norm1.weight, layer.norm1.bias)
    x = x + mha(h, h, a.in_proj_weight, a.in_proj_bias, a.out_proj.weight,
                a.out_proj.bias, n_heads, mask=causal_mask)
    h = layer_norm(x, layer.norm2.weight, layer.norm2.bias)
    x = x + mha(h, mem, c.in_proj_weight, c.in_proj_bias, c.out_proj.weight,
                c.out_proj.bias, n_heads)
    h = layer_norm(x, layer.norm3.weight, layer.norm3.bias)
    return x + ffn(h, layer.linear1.weight, layer.linear1.bias,
                   layer.linear2.weight, layer.linear2.bias)


# --------------------------------------------------------------------------
# KV-cached decoder step
# --------------------------------------------------------------------------
def precompute_cross_kv(layer, mem: torch.Tensor, n_heads: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project the memory [N, T, D] to one layer's cross-attention K and V,
    once per line: each [N, heads, T, hd], computed in ``mem``'s dtype and
    then held in float32, the type the step's attention products run in."""
    n, t, d = mem.shape
    c = layer.multihead_attn
    _, wk, wv = c.in_proj_weight.split(d)
    _, bk, bv = c.in_proj_bias.split(d)

    def heads(x):
        return x.view(n, t, n_heads, d // n_heads).transpose(1, 2).float()
    return heads(dense(mem, wk, bk)), heads(dense(mem, wv, bv))


def init_self_cache(n_layers: int, batch: int, max_len: int, n_heads: int,
                    head_dim: int, dtype: torch.dtype, device
                    ) -> torch.Tensor:
    """Self-attention K/V cache as one tensor [L, B, Tmax, 2, H, hd]
    (slot 0 = K, slot 1 = V), so that a beam step reorders it by parent in
    one gather."""
    return torch.zeros((n_layers, batch, max_len, 2, n_heads, head_dim),
                       dtype=dtype, device=device)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v over float32 [.., Tq, hd] x [.., Tk, hd],
    with the weights and the result rounded to ``dtype`` as ``mha`` does."""
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    attn = torch.softmax(scores, dim=-1).to(dtype)
    return torch.matmul(attn.float(), v).to(dtype)


def decoder_step_layer(layer, x: torch.Tensor, layer_idx: int,
                       cache: torch.Tensor, pos: int, cross_k: torch.Tensor,
                       cross_v: torch.Tensor, n_heads: int) -> torch.Tensor:
    """One decoder layer for one new position, with the K/V cache.

    x [B, 1, D] activations of the current token; ``pos`` is the host's step
    counter: this step's K/V are written in place at ``cache[layer_idx, :,
    pos]`` and attention runs over the slice ``[:pos + 1]``, so no mask is
    needed and no slot that was never written is read. ``cross_k``/``cross_v``
    are ``precompute_cross_kv``'s [N, H, T, hd] with B = N * K: the K beams
    of a line are consecutive rows and share the line's memory K/V, which is
    read once per line and not once per beam. Returns the new x.
    """
    b, _, d = x.shape
    hd = d // n_heads
    a, c = layer.self_attn, layer.multihead_attn

    h = layer_norm(x, layer.norm1.weight, layer.norm1.bias)
    qkv = dense(h, a.in_proj_weight, a.in_proj_bias)       # fused, [B, 1, 3D]
    # k and v lie side by side in qkv, in the cache's (2, H, hd) order.
    cache[layer_idx, :, pos] = qkv[:, 0, d:].view(b, 2, n_heads, hd)
    kv = cache[layer_idx, :, :pos + 1].float()             # [B, t, 2, H, hd]
    q = qkv[:, 0, :d].view(b, n_heads, hd)
    sa = _attend(q.float().unsqueeze(2), kv[:, :, 0].transpose(1, 2),
                 kv[:, :, 1].transpose(1, 2), x.dtype)     # [B, H, 1, hd]
    x = x + dense(sa.reshape(b, 1, d), a.out_proj.weight, a.out_proj.bias)

    h = layer_norm(x, layer.norm2.weight, layer.norm2.bias)
    n = cross_k.shape[0]
    q = dense(h, c.in_proj_weight[:d], c.in_proj_bias[:d])
    q = q.view(n, b // n, n_heads, hd).transpose(1, 2)     # [N, H, K, hd]
    ca = _attend(q.float(), cross_k, cross_v, x.dtype)     # [N, H, K, hd]
    x = x + dense(ca.transpose(1, 2).reshape(b, 1, d), c.out_proj.weight,
                  c.out_proj.bias)

    h = layer_norm(x, layer.norm3.weight, layer.norm3.bias)
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
