"""Transformer building blocks as functions over torch tensors, the port of
``kiri_tpu/models/layers.py``.

Parameters keep torch's layout (``nn.Linear`` weights are [out, in]; the
attention projections are the fused ``in_proj_weight`` [3D, D] split into
q/k/v thirds). The numerics follow the JAX package: matmuls run in the
compute dtype of the activations, LayerNorm and softmax in float32, attention
scores and the attention-weighted sum accumulate in float32, GELU is exact.
Attention is written out as matmul -> softmax -> matmul, as the JAX package
writes it. The decoder has a whole-sequence layer (``decoder_layer``) and a
one-position layer over a K/V cache (``decoder_step_layer``), where the step
counter is a device scalar: the cache is written in place at it and read
whole, the positions past it masked, so a step's shapes do not depend on the
counter (the step loop can be replayed as a CUDA graph).

Training passes a dropout rate and a ``torch.Generator`` to the whole-sequence
functions: dropout sits where the JAX package puts it (the attention weights,
the FFN's hidden layer, each residual branch) in its form ``x * keep / (1 -
p)``, with keep drawn from the generator. At rate 0 they are the inference
functions; a rate above 0 with no generator raises.

Tensor parallelism (``kiri_tpu_torch.parallel``): a layer whose weights are
shards carries the mesh (``tp`` on an attention, ``tp_ffn`` on a layer's
FFN). Its input goes in through ``copy_to_model``, each rank runs its heads
or its slice of the hidden layer, and the output projection's partial sums
are added over the model axis (``reduce_from_model``) before its bias. Its
dropout masks are drawn whole from a ``GlobalDraw`` and cut to the rank's
heads or slice, so a sharded step draws what one device draws.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def wide(x: torch.Tensor) -> torch.Tensor:
    """x in float32, the type LayerNorm, softmax and the attention products
    run in; float64 stays float64 (a reference run of the training
    forward)."""
    return x if x.dtype == torch.float64 else x.float()


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ weight.T (+ bias) in x's dtype. A bias of x's dtype goes into the
    matmul (one launch); a float32 bias under a bf16 x is added in float32."""
    if bias is None or bias.dtype == x.dtype:
        return F.linear(x, weight.to(x.dtype), bias)
    return (F.linear(x, weight.to(x.dtype)).float() + bias).to(x.dtype)


class GlobalDraw:
    """A generator's draws for a global batch of ``n`` rows of which this
    rank holds rows [lo, hi), and, along a tensor-parallel dimension, part
    ``tp_index`` of ``tp_size``: each draw is made at the global shape, as
    one device makes it, and cut to this rank's part, so every rank's
    generator stays in step and a sharded run draws one device's masks."""

    def __init__(self, gen: torch.Generator, lo: int, hi: int, n: int,
                 tp_index: int = 0, tp_size: int = 1):
        self.gen, self.lo, self.hi, self.n = gen, lo, hi, n
        self.tp_index, self.tp_size = tp_index, tp_size

    def _whole(self, shape, tp_dim: Optional[int]):
        full = list(shape)
        full[0] = self.n
        if tp_dim is not None:
            full[tp_dim] *= self.tp_size
        return full

    def _cut(self, r: torch.Tensor, shape, tp_dim: Optional[int]):
        r = r[self.lo: self.hi]
        if tp_dim is not None and self.tp_size > 1:
            w = shape[tp_dim]
            r = r.narrow(tp_dim, self.tp_index * w, w)
        return r

    def rand(self, shape, device, tp_dim: Optional[int] = None):
        return self._cut(torch.rand(self._whole(shape, tp_dim),
                                    generator=self.gen, device=device),
                         shape, tp_dim)

    def randint(self, low: int, high: int, shape, device, dtype):
        return self._cut(torch.randint(low, high, self._whole(shape, None),
                                       generator=self.gen, device=device,
                                       dtype=dtype), shape, None)


def rand(gen, shape, device, tp_dim: Optional[int] = None) -> torch.Tensor:
    """Uniform [0, 1) draws of ``shape`` from a ``torch.Generator`` or a
    ``GlobalDraw`` (this rank's part of the global draw; ``tp_dim`` is the
    dimension sharded over the model axis, if any)."""
    if isinstance(gen, GlobalDraw):
        return gen.rand(shape, device, tp_dim)
    return torch.rand(shape, generator=gen, device=device)


def randint(gen, low: int, high: int, shape, device, dtype) -> torch.Tensor:
    if isinstance(gen, GlobalDraw):
        return gen.randint(low, high, shape, device, dtype)
    return torch.randint(low, high, shape, generator=gen, device=device,
                         dtype=dtype)


def dropout(x: torch.Tensor, rate: float, gen, shape=None,
            tp_dim: Optional[int] = None) -> torch.Tensor:
    """``x * keep / (1 - rate)``, keep ~ Bernoulli(1 - rate) drawn from
    ``gen`` (a ``torch.Generator`` or a ``GlobalDraw``) in ``shape`` (x's
    by default; a smaller shape broadcasts, as Dropout2d's one draw a
    channel does); x itself at rate 0. A rate above 0 needs a generator.
    ``tp_dim``: x is this rank's part of that dimension."""
    if rate <= 0.0:
        return x
    if gen is None:
        raise ValueError(f"dropout at rate {rate} needs a torch.Generator")
    keep = rand(gen, x.shape if shape is None else shape, x.device,
                tp_dim) < 1.0 - rate
    return x * keep / (1.0 - rate)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32, output back in x's dtype."""
    return F.layer_norm(wide(x), x.shape[-1:], weight, bias, eps).to(x.dtype)


def _row_parallel(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor], tp) -> torch.Tensor:
    """``dense`` of a layer sharded on its input: each rank's partial
    product, added over the model axis in float32, then the bias."""
    if tp is None:
        return dense(x, weight, bias)
    from ..parallel import reduce_from_model

    y = reduce_from_model(wide(F.linear(x, weight.to(x.dtype))), tp)
    return (y if bias is None else y + bias).to(x.dtype)


def mha(q_in: torch.Tensor, kv_in: torch.Tensor, in_proj_weight: torch.Tensor,
        in_proj_bias: torch.Tensor, out_weight: torch.Tensor,
        out_bias: torch.Tensor, n_heads: int,
        mask: Optional[torch.Tensor] = None, drop: float = 0.0,
        gen: Optional[torch.Generator] = None, tp=None) -> torch.Tensor:
    """Full (non-cached) multi-head attention over [B, T, D] inputs.

    ``mask`` broadcasts to [B, heads, Tq, Tk]; True = masked out. ``drop``
    is the dropout rate of the attention weights. ``n_heads`` counts the
    model's heads; with ``tp`` the projections are this rank's heads
    (``in_proj_weight`` [3 D / M, D]) and the output is summed over the
    model axis.
    """
    b, tq, d = q_in.shape
    tk = kv_in.shape[1]
    hd = d // n_heads
    dl = in_proj_weight.shape[0] // 3
    heads = dl // hd
    if tp is not None:
        from ..parallel import copy_to_model

        same = kv_in is q_in
        q_in = copy_to_model(q_in, tp)
        kv_in = q_in if same else copy_to_model(kv_in, tp)
    wq, wk, wv = in_proj_weight.split(dl)
    bq, bk, bv = in_proj_bias.split(dl)
    q = dense(q_in, wq, bq).view(b, tq, heads, hd).transpose(1, 2)
    k = dense(kv_in, wk, bk).view(b, tk, heads, hd).transpose(1, 2)
    v = dense(kv_in, wv, bv).view(b, tk, heads, hd).transpose(1, 2)
    scores = torch.matmul(wide(q), wide(k).transpose(-1, -2)) / math.sqrt(hd)
    if mask is not None:
        scores = scores.masked_fill(mask, float("-inf"))
    attn = torch.softmax(scores, dim=-1).to(q.dtype)
    attn = (dropout(attn, drop, gen) if tp is None
            else dropout(attn, drop, gen, tp_dim=1))   # this rank's heads
    out = torch.matmul(wide(attn), wide(v)).to(q.dtype)      # [B, H, Tq, hd]
    out = out.transpose(1, 2).reshape(b, tq, dl)
    return _row_parallel(out, out_weight, out_bias, tp)


def ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
        w2: torch.Tensor, b2: torch.Tensor, drop: float = 0.0,
        gen: Optional[torch.Generator] = None, tp=None) -> torch.Tensor:
    """GELU FFN; with ``tp`` the hidden layer is this rank's slice."""
    if tp is None:
        return dense(dropout(F.gelu(dense(x, w1, b1)), drop, gen), w2, b2)
    from ..parallel import copy_to_model

    h = F.gelu(dense(copy_to_model(x, tp), w1, b1))
    return _row_parallel(dropout(h, drop, gen, tp_dim=h.dim() - 1), w2, b2,
                         tp)


def encoder_layer(layer, x: torch.Tensor, n_heads: int, drop: float = 0.0,
                  gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Pre-norm GELU encoder layer over an ``EncoderLayer`` module's
    parameters (torch ``TransformerEncoderLayer(norm_first=True)`` names)."""
    a = layer.self_attn
    h = layer_norm(x, layer.norm1.weight, layer.norm1.bias)
    h = mha(h, h, a.in_proj_weight, a.in_proj_bias, a.out_proj.weight,
            a.out_proj.bias, n_heads, drop=drop, gen=gen,
            tp=getattr(a, "tp", None))
    x = x + dropout(h, drop, gen)
    h = layer_norm(x, layer.norm2.weight, layer.norm2.bias)
    h = ffn(h, layer.linear1.weight, layer.linear1.bias,
            layer.linear2.weight, layer.linear2.bias, drop, gen,
            getattr(layer, "tp_ffn", None))
    return x + dropout(h, drop, gen)


def decoder_layer(layer, x: torch.Tensor, mem: torch.Tensor, n_heads: int,
                  causal_mask: torch.Tensor, drop: float = 0.0,
                  gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Pre-norm decoder layer over a whole sequence: self-attention under
    ``causal_mask`` -> cross-attention over ``mem`` -> FFN (a ``DecoderLayer``
    module's parameters, torch ``TransformerDecoderLayer(norm_first=True)``
    names)."""
    a, c = layer.self_attn, layer.multihead_attn
    h = layer_norm(x, layer.norm1.weight, layer.norm1.bias)
    h = mha(h, h, a.in_proj_weight, a.in_proj_bias, a.out_proj.weight,
            a.out_proj.bias, n_heads, mask=causal_mask, drop=drop, gen=gen,
            tp=getattr(a, "tp", None))
    x = x + dropout(h, drop, gen)
    h = layer_norm(x, layer.norm2.weight, layer.norm2.bias)
    h = mha(h, mem, c.in_proj_weight, c.in_proj_bias, c.out_proj.weight,
            c.out_proj.bias, n_heads, drop=drop, gen=gen,
            tp=getattr(c, "tp", None))
    x = x + dropout(h, drop, gen)
    h = layer_norm(x, layer.norm3.weight, layer.norm3.bias)
    h = ffn(h, layer.linear1.weight, layer.linear1.bias,
            layer.linear2.weight, layer.linear2.bias, drop, gen,
            getattr(layer, "tp_ffn", None))
    return x + dropout(h, drop, gen)


# --------------------------------------------------------------------------
# KV-cached decoder step
# --------------------------------------------------------------------------
def precompute_cross_kv(layer, mem: torch.Tensor, n_heads: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project the memory [N, T, D] to one layer's cross-attention K and V,
    once per line: each [N, heads, T, hd] (this rank's heads under tensor
    parallelism), computed in ``mem``'s dtype and then held in float32, the
    type the step's attention products run in."""
    n, t, d = mem.shape
    c = layer.multihead_attn
    dl = c.in_proj_weight.shape[0] // 3
    _, wk, wv = c.in_proj_weight.split(dl)
    _, bk, bv = c.in_proj_bias.split(dl)
    hd = d // n_heads

    def heads(x):
        return x.view(n, t, dl // hd, hd).transpose(1, 2).float()
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
            dtype: torch.dtype, mask: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v over float32 [.., Tq, hd] x [.., Tk, hd],
    with the weights and the result rounded to ``dtype`` as ``mha`` does;
    ``mask`` [Tk] True = key left out (its weight is exactly 0)."""
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores.masked_fill(mask, float("-inf"))
    attn = torch.softmax(scores, dim=-1).to(dtype)
    return torch.matmul(attn.float(), v).to(dtype)


def decoder_step_layer(layer, x: torch.Tensor, layer_idx: int,
                       cache: torch.Tensor, pos: torch.Tensor,
                       cross_k: torch.Tensor, cross_v: torch.Tensor,
                       n_heads: int) -> torch.Tensor:
    """One decoder layer for one new position, with the K/V cache.

    x [B, 1, D] activations of the current token; ``pos`` is the step
    counter, an int32 scalar on x's device: this step's K/V are written in
    place at ``cache[layer_idx, :, pos]`` and attention runs over the whole
    cache with the keys past ``pos`` masked (as the JAX package does), so
    the launches and their shapes are the same at every step and no host
    value is read. A masked key's weight is exactly 0, so the slots never
    written add nothing. ``cross_k``/``cross_v``
    are ``precompute_cross_kv``'s [N, H, T, hd] with B = N * K: the K beams
    of a line are consecutive rows and share the line's memory K/V, which is
    read once per line and not once per beam. Under tensor parallelism the
    cache and the cross K/V hold this rank's heads. Returns the new x.
    """
    b, _, d = x.shape
    hd = d // n_heads
    a, c = layer.self_attn, layer.multihead_attn
    dl = a.in_proj_weight.shape[0] // 3
    tp_a, tp_c = getattr(a, "tp", None), getattr(c, "tp", None)

    h = layer_norm(x, layer.norm1.weight, layer.norm1.bias)
    qkv = dense(h, a.in_proj_weight, a.in_proj_bias)       # fused, [B, 1, 3D]
    # k and v lie side by side in qkv, in the cache's (2, H, hd) order.
    cache[layer_idx].index_copy_(1, pos.view(1).long(),
                                 qkv[:, :, dl:].view(b, 1, 2, dl // hd, hd))
    kv = cache[layer_idx].float()                       # [B, L_buf, 2, H, hd]
    later = torch.arange(kv.shape[1], device=x.device) > pos
    q = qkv[:, 0, :dl].view(b, dl // hd, hd)
    sa = _attend(q.float().unsqueeze(2), kv[:, :, 0].transpose(1, 2),
                 kv[:, :, 1].transpose(1, 2), x.dtype, later)  # [B, H, 1, hd]
    x = x + _row_parallel(sa.reshape(b, 1, dl), a.out_proj.weight,
                          a.out_proj.bias, tp_a)

    h = layer_norm(x, layer.norm2.weight, layer.norm2.bias)
    n = cross_k.shape[0]
    dc = c.in_proj_weight.shape[0] // 3
    q = dense(h, c.in_proj_weight[:dc], c.in_proj_bias[:dc])
    q = q.view(n, b // n, dc // hd, hd).transpose(1, 2)    # [N, H, K, hd]
    ca = _attend(q.float(), cross_k, cross_v, x.dtype)     # [N, H, K, hd]
    x = x + _row_parallel(ca.transpose(1, 2).reshape(b, 1, dc),
                          c.out_proj.weight, c.out_proj.bias, tp_c)

    h = layer_norm(x, layer.norm3.weight, layer.norm3.bias)
    return x + ffn(h, layer.linear1.weight, layer.linear1.bias,
                   layer.linear2.weight, layer.linear2.bias,
                   tp=getattr(layer, "tp_ffn", None))


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
