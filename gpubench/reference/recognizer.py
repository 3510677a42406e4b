"""Plain PyTorch reference of the kiri-ocr v13 line recognizer, float32.

Written from the architecture (kiri-ocr v0.2.15 ``kiri_ocr/model.py``, the
checkpoint's own torch names), with no code of the program under test:

    u8 line [B, 48, W] -> (x / 255 - 0.5) / 0.5
    -> 4 x (conv3x3 pad 1, BatchNorm (running stats, eps 1e-5), SiLU),
       channels 1 -> 48 -> 96 -> 160 -> 256, strides (1,1) (2,2) (2,2) (2,1)
    -> + 2D sinusoid table (first half of the channels y, second half x)
    -> mean over height -> LayerNorm -> 4 pre-norm encoder layers (8 heads,
       exact GELU FFN 1024, no mask) -> LayerNorm = memory [B, W/4, 256]
    CTC head: LayerNorm -> Linear (210 classes)
    decoder: memory @ mem_proj; token embedding + sinusoid table -> 3
       pre-norm decoder layers (causal self-attention, cross-attention over
       the projected memory, GELU FFN) -> LayerNorm -> dec_head and lm_head.

TF32 is switched off for every call. ``precision="fp8"`` is the control:
each operand of every convolution and matrix product is rounded to float8
e4m3 with one scale per tensor (its absolute maximum over 448), the step
below the configuration's bfloat16.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .weights import read_safetensors

STRIDES = ((1, 1), (2, 2), (2, 2), (2, 1))
FP8_MAX = 448.0


@contextlib.contextmanager
def full_float32():
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (mm.allow_tf32, dnn.allow_tf32)
    mm.allow_tf32, dnn.allow_tf32 = False, False
    try:
        yield
    finally:
        mm.allow_tf32, dnn.allow_tf32 = before


def sinusoid(length: int, dim: int) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float64)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float64)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros(length, dim, dtype=torch.float64)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.float()


class RefRecognizer:
    def __init__(self, ckpt_path, cfg: Dict, device, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision is f32 or fp8, not {precision!r}")
        self.precision = precision
        self.cfg = cfg
        self.dev = torch.device(device)
        self.w = {k: torch.from_numpy(v).to(self.dev)
                  for k, v in read_safetensors(ckpt_path).items()
                  if v.dtype != np.int64}
        self.enc_heads = int(cfg["ENC_HEADS"])
        self.dec_heads = int(cfg["DEC_HEADS"])
        self.enc_layers = int(cfg["ENC_LAYERS"])
        self.dec_layers = int(cfg["DEC_LAYERS"])

    # ------------------------------------------------------------ numerics
    def _q(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "f32":
            return x
        scale = x.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def linear(self, x, name: str, bias: bool = True):
        w = self.w[f"{name}.weight"]
        return F.linear(self._q(x), self._q(w),
                        self.w[f"{name}.bias"] if bias else None)

    def _ln(self, x, name: str):
        return F.layer_norm(x, x.shape[-1:], self.w[f"{name}.weight"],
                            self.w[f"{name}.bias"], 1e-5)

    def _mha(self, q_in, kv_in, name: str, heads: int,
             mask: Optional[torch.Tensor] = None):
        b, tq, d = q_in.shape
        tk = kv_in.shape[1]
        hd = d // heads
        wq, wk, wv = self.w[f"{name}.in_proj_weight"].split(d)
        bq, bk, bv = self.w[f"{name}.in_proj_bias"].split(d)
        q = F.linear(self._q(q_in), self._q(wq), bq)
        k = F.linear(self._q(kv_in), self._q(wk), bk)
        v = F.linear(self._q(kv_in), self._q(wv), bv)
        q = q.view(b, tq, heads, hd).transpose(1, 2)
        k = k.view(b, tk, heads, hd).transpose(1, 2)
        v = v.view(b, tk, heads, hd).transpose(1, 2)
        s = self._q(q) @ self._q(k).transpose(-1, -2) / math.sqrt(hd)
        if mask is not None:
            s = s.masked_fill(mask, float("-inf"))
        o = self._q(torch.softmax(s, dim=-1)) @ self._q(v)
        o = o.transpose(1, 2).reshape(b, tq, d)
        return self.linear(o, f"{name}.out_proj")

    def _ffn(self, x, name: str):
        return self.linear(F.gelu(self.linear(x, f"{name}.linear1")),
                           f"{name}.linear2")

    # ------------------------------------------------------------- encoder
    @torch.no_grad()
    def encode(self, imgs_u8: torch.Tensor) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
        """u8 [B, 48, W] on the device -> (memory [B, T, D], CTC logits
        [B, T, C]), float32."""
        with full_float32():
            x = (imgs_u8.float() / 255.0 - 0.5) / 0.5
            h = x[:, None]
            for i, stride in enumerate(STRIDES):
                c, bn = f"stem.net.{3 * i}", f"stem.net.{3 * i + 1}"
                h = F.conv2d(self._q(h), self._q(self.w[f"{c}.weight"]),
                             stride=stride, padding=1)
                h = F.batch_norm(h, self.w[f"{bn}.running_mean"],
                                 self.w[f"{bn}.running_var"],
                                 self.w[f"{bn}.weight"], self.w[f"{bn}.bias"],
                                 False, 0.0, 1e-5)
                h = F.silu(h)
            feat = h.permute(0, 2, 3, 1)                     # [B, H, T, C]
            _, hh, t, c = feat.shape
            half = c // 2
            pe = torch.zeros(hh, t, c, device=feat.device)
            pe[:, :, :half] = sinusoid(hh, half).to(feat.device)[:, None]
            pe[:, :, half:2 * half] = sinusoid(t, half).to(feat.device)[None]
            seq = self._ln((feat + pe).mean(dim=1), "enc_ln_in")
            for i in range(self.enc_layers):
                p = f"enc.layers.{i}"
                a = self._ln(seq, f"{p}.norm1")
                seq = seq + self._mha(a, a, f"{p}.self_attn", self.enc_heads)
                seq = seq + self._ffn(self._ln(seq, f"{p}.norm2"), p)
            mem = self._ln(seq, "enc_ln")
            ctc = self.linear(self._ln(mem, "ctc_head.0"), "ctc_head.2")
        return mem, ctc

    # ------------------------------------------------------------- decoder
    @torch.no_grad()
    def mem_project(self, mem: torch.Tensor) -> torch.Tensor:
        with full_float32():
            return self.linear(mem, "mem_proj", bias=False)

    @torch.no_grad()
    def decoder_logits(self, memp: torch.Tensor, tokens: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced pass: memp [B, T, D], tokens [B, L] (bos first)
        -> (dec_head logits, lm_head logits) [B, L, V], float32: position p
        predicts token p + 1."""
        with full_float32():
            lt = tokens.shape[1]
            x = self.w["dec_emb.weight"][tokens.long()]
            x = x + sinusoid(lt, x.shape[-1]).to(x.device)
            causal = torch.ones((lt, lt), dtype=torch.bool,
                                device=x.device).triu(1)
            for i in range(self.dec_layers):
                p = f"dec.layers.{i}"
                a = self._ln(x, f"{p}.norm1")
                x = x + self._mha(a, a, f"{p}.self_attn", self.dec_heads,
                                  causal)
                x = x + self._mha(self._ln(x, f"{p}.norm2"), memp,
                                  f"{p}.multihead_attn", self.dec_heads)
                x = x + self._ffn(self._ln(x, f"{p}.norm3"), p)
            x = self._ln(x, "dec_ln")
            return self.linear(x, "dec_head"), self.linear(x, "lm_head")
