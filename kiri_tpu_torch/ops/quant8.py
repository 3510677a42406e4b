"""The recognizer's int8 fast path, encode + CTC: the port of
``kiri_tpu/ops/quant8.py``.

``Q8Encoder`` runs the stem convolutions and the encoder's weight matmuls
as s8 x s8 -> s32 contractions with a float32 dequant epilogue, through the
hand-written kernels of ``kernels/quant8.py`` (``q8_stem01`` for conv0 and
conv1 in one launch, ``q8_conv3x3`` for conv2 and conv3, ``q8_linear``);
attention products, softmax, LayerNorm, GELU, residuals and the CTC head
stay in the compute dtype and float32, as in ``kiri_tpu``. The scheme is
``kiri_tpu``'s post-training quantization:

* weights symmetric per output channel in int8 (``_qw``), the stem's with
  BatchNorm folded in (``kernels/stem.fold_stem_weights``);
* activations symmetric int8 with static scales, calibrated once on a
  batch (``calibrate``): per tensor for the matmuls, per channel for convs
  1-3, where each channel's scale is folded into the next conv's weights
  before they are quantized;
* conv0 is exact: the u8 line is int8(u8 - 128) + 0.5, and the +0.5 term is
  a float32 convolution of a constant image (``corr``), computed once per
  (H, W) on the device with TF32 off.

``parts`` picks the groups that run int8: any subset of {"stem", "attn",
"ffn"}. A group left out, and calibration, run the plain path as
``kiri_tpu`` does: the stem as a convolution in the compute dtype, rounded to
it, then the float32 bias and SiLU (not ``stem_fused``, which rounds once
after them), the matmuls through ``models/layers.dense``.

The q, k and v projections run as one GEMM against the packed
``in_proj_weight``: they read the same input, so their three calibrated
scales are equal, and per-output-channel weight scales are unchanged by the
packing. ``scales["enc"]`` keeps one entry per ``kiri_tpu`` matmul anyway
(wq, wk, wv, wo, lin1, lin2 a layer, for the parts chosen), so the two
packages' scale lists compare one to one.

Layouts: stem weights are [Cout, 9 * Cin] in (dy, dx, cin) order (``pack``'s
``wf`` the folded float32 [9 * Cin, Cout], ``kiri_tpu``'s HWIO reshaped),
linear weights torch's [out, in], quantized per row.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import no_tf32, resolve_device
from ..kernels.quant8 import (f32, q8_conv3x3, q8_linear, q8_stem01,
                              quantize)
from ..kernels.stem import STRIDES, fold_stem_weights
from ..models import layers as L
from ..models.recognizer import _COMPUTE_DTYPES, _pos_enc_2d
from .preprocess import normalize_u8

PARTS = ("stem", "attn", "ffn")
_PART_OF = {"qkv": "attn", "wo": "attn", "lin1": "ffn", "lin2": "ffn"}


def _qw(w: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel weight quantization along ``axis``:
    (int8 weights, float32 scale [w.shape[axis]])."""
    wf = w.float()
    red = tuple(i for i in range(wf.dim()) if i != axis)
    amax = wf.abs().amax(dim=red, keepdim=True)
    scale = amax.clamp(min=1e-12) / 127.0
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale.reshape(-1)


def _inv(scale: float) -> float:
    """1 / scale in float32, as ``kiri_tpu``'s ``_qa`` takes it."""
    return float(np.float32(1.0) / np.float32(scale))


def _qa(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Quantize activations with a static per-tensor scale."""
    return quantize(x, _inv(scale))


class Q8Encoder:
    """Quantized fast-path forward: u8 lines [B, H, W] -> (mem, ctc_logits).

    Built from a port ``Recognizer`` (moved to ``device``; ``None`` is the
    card); ``calibrate`` on one representative u8 batch before the first
    quantized call, or set ``scales`` (``convert.q8_scales_from_jax``
    carries ``kiri_tpu``'s across)."""

    def __init__(self, model, cfg, parts=PARTS, device=None):
        unknown = set(parts) - set(PARTS)
        if unknown:
            raise ValueError(f"unknown parts {sorted(unknown)}; choose from "
                             f"{PARTS}")
        self.cfg = cfg
        self.parts = frozenset(parts)
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.dtype = _COMPUTE_DTYPES[cfg.COMPUTE_DTYPE]
        with torch.no_grad():
            folded = fold_stem_weights(self.model.stem.net, torch.float32)
            stem = []
            for i in range(4):
                wf, b = folded[2 * i], folded[2 * i + 1]
                qw, ws = _qw(wf.t(), axis=0)
                stem.append({"w": qw.contiguous(), "ws": ws, "wf": wf,
                             "b": b})
            enc = []
            for layer in self.model.enc.layers:
                a = layer.self_attn
                ql = {}
                for name, wt, bias in (
                        ("qkv", a.in_proj_weight, a.in_proj_bias),
                        ("wo", a.out_proj.weight, a.out_proj.bias),
                        ("lin1", layer.linear1.weight, layer.linear1.bias),
                        ("lin2", layer.linear2.weight, layer.linear2.bias)):
                    qw, ws = _qw(wt, axis=0)
                    ql[name] = {"w": qw, "ws": ws,
                                "b": None if bias is None
                                else bias.detach().float()}
                enc.append(ql)
        self.pack: Dict = {"stem": stem, "enc": enc}
        self.scales: Optional[Dict] = None
        self._prepared = (None, None)
        self._corr: Dict[Tuple[int, int], torch.Tensor] = {}

    # ------------------------------------------------------------ helpers
    def _correction(self, h: int, w: int) -> torch.Tensor:
        """conv0's float32 convolution of the constant 0.5 / 127.5 image
        with zero padding, [H, W, 48], per (H, W) on the device."""
        if (h, w) not in self._corr:
            wf = self.pack["stem"][0]["wf"]                 # [9, Cout]
            half = torch.full((1, 1, h, w), f32(0.5 / 127.5),
                              dtype=torch.float32, device=self.device)
            oihw = wf.reshape(3, 3, 1, -1).permute(3, 2, 0, 1)
            with torch.no_grad(), no_tf32():
                c = F.conv2d(half, oihw, stride=STRIDES[0], padding=1)
            self._corr[(h, w)] = c[0].permute(1, 2, 0).contiguous()
        return self._corr[(h, w)]

    def _runtime(self) -> Dict:
        """The calibrated scales as the kernels take them, on the device,
        made again only when ``scales`` is replaced."""
        if self._prepared[0] is self.scales:
            return self._prepared[1]
        dev, s = self.device, self.scales
        stem = [{k: v.to(dev) for k, v in q.items()} for q in s["stem"]]
        scales = iter(s["enc"])
        enc = []
        for ql in self.pack["enc"]:
            layer = {}
            for name, part in _PART_OF.items():
                if part not in self.parts:
                    continue
                a_s = next(scales)
                if name == "qkv":
                    same = (next(scales), next(scales))
                    if any(f32(v) != f32(a_s) for v in same):
                        raise ValueError("q, k and v read one input, so "
                                         "their three scales must be equal")
                layer[name] = (_inv(a_s), ql[name]["ws"] * f32(a_s))
            enc.append(layer)
        out = {"conv0": self.pack["stem"][0]["ws"] / 127.5, "stem": stem,
               "enc": enc}
        self._prepared = (s, out)
        return out

    # ------------------------------------------------------------ forward
    def _forward(self, images_u8, record: Optional[List[torch.Tensor]]):
        """With ``record`` a list: the plain forward, appending each
        quantized operation's input abs-max (calibration); otherwise the
        int8 path on the calibrated scales."""
        m = self.model
        dtype = self.dtype
        imgs = torch.as_tensor(images_u8).to(self.device)
        run = None if record is not None else self._runtime()
        quant_stem = "stem" in self.parts
        x = normalize_u8(imgs, dtype).unsqueeze(-1)          # NHWC
        for i, stride in enumerate(STRIDES):
            p = self.pack["stem"][i]
            if quant_stem and run is not None and i == 0:
                q1, p1 = run["stem"][0], self.pack["stem"][1]
                x = q8_stem01(imgs.contiguous(), p["w"], run["conv0"],
                              p["b"], self._correction(*imgs.shape[1:]),
                              q1["wq"], q1["ws"], p1["b"], q1["inv"], dtype)
            elif quant_stem and run is not None and i == 1:
                continue                      # inside q8_stem01
            elif quant_stem and run is not None:
                qs = run["stem"][i - 1]
                x = q8_conv3x3(x.contiguous(), qs["wq"], qs["ws"], p["b"],
                               stride, inv=qs["inv"])
            else:
                if quant_stem and i > 0:      # calibration: per channel
                    record.append(x.float().abs().amax(dim=(0, 1, 2)))
                wf = p["wf"]
                oihw = wf.reshape(3, 3, -1, wf.shape[1]).permute(3, 2, 0, 1)
                y = F.conv2d(x.permute(0, 3, 1, 2), oihw.to(dtype),
                             stride=stride, padding=1)
                x = F.silu(y.permute(0, 2, 3, 1).float() + p["b"]).to(dtype)
        _, h, w, c = x.shape
        seq = (x + _pos_enc_2d(h, w, c).to(x.device, dtype)).mean(dim=1)
        seq = L.layer_norm(seq, m.enc_ln_in.weight, m.enc_ln_in.bias)
        for li, layer in enumerate(m.enc.layers):
            seq = self._layer(li, layer, seq, run, record)
        mem = L.layer_norm(seq, m.enc_ln.weight, m.enc_ln.bias)
        return mem, m.ctc_logits(mem)

    def _layer(self, li, layer, x, run, record):
        """One pre-norm encoder layer with its matmuls quantized per
        ``parts`` (``kiri_tpu``'s ``_enc_layer_q8``)."""
        ql = self.pack["enc"][li]
        b, t, d = x.shape
        a = layer.self_attn
        plain = {"wo": a.out_proj, "lin1": layer.linear1,
                 "lin2": layer.linear2}

        def proj(name, inp):
            if _PART_OF[name] not in self.parts:
                return L.dense(inp, plain[name].weight, plain[name].bias)
            if record is not None:
                record.append(inp.float().abs().amax())
                return L.dense(inp, plain[name].weight, plain[name].bias)
            inv, sc = run["enc"][li][name]
            return q8_linear(inp.contiguous(), inv, ql[name]["w"], sc,
                             ql[name]["b"])

        hn = L.layer_norm(x, layer.norm1.weight, layer.norm1.bias)
        if "attn" in self.parts and record is None:
            inv, sc = run["enc"][li]["qkv"]
            q, k, v = q8_linear(hn, inv, ql["qkv"]["w"], sc,
                                ql["qkv"]["b"]).split(d, dim=-1)
        else:
            if "attn" in self.parts:          # wq, wk, wv read hn alike
                record.extend([hn.float().abs().amax()] * 3)
            q, k, v = (L.dense(hn, wt, bias) for wt, bias in zip(
                a.in_proj_weight.split(d), a.in_proj_bias.split(d)))
        heads = self.cfg.ENC_HEADS
        hd = d // heads

        def split(z):
            return z.reshape(b, t, heads, hd).transpose(1, 2).float()
        scores = torch.matmul(split(q), split(k).transpose(-1, -2))
        attn = torch.softmax(scores / math.sqrt(hd), dim=-1).to(x.dtype)
        out = torch.matmul(attn.float(), split(v)).to(x.dtype)
        x = x + proj("wo", out.transpose(1, 2).reshape(b, t, d))
        hn = L.layer_norm(x, layer.norm2.weight, layer.norm2.bias)
        return x + proj("lin2", F.gelu(proj("lin1", hn)))

    # -------------------------------------------------------- public API
    @torch.inference_mode()
    def calibrate(self, images_u8, headroom: float = 1.0) -> None:
        """Record static activation scales from one batch: the per-channel
        input abs-max of convs 1-3 (conv0 is exact) and one abs-max per
        quantized matmul, each times ``headroom``."""
        record: List[torch.Tensor] = []
        with no_tf32():
            self._forward(images_u8, record)
        vals = [v.float().cpu() for v in record]
        n_stem = 3 if "stem" in self.parts else 0
        stem = []
        for i, amax_c in enumerate(vals[:n_stem]):
            # Fold each channel's scale into the NEXT conv's weights
            # (conv(x / s[c], w * s[c]) = conv(x, w)) before quantizing them.
            amax_c = (amax_c * headroom).clamp(min=1e-6)
            wf = self.pack["stem"][i + 1]["wf"].cpu()
            cin, cout = amax_c.shape[0], wf.shape[1]
            w_fold = (wf.reshape(9, cin, cout)
                      * (amax_c / 127.0)[None, :, None]).reshape(-1, cout)
            wq, ws = _qw(w_fold.t(), axis=0)
            stem.append({"inv": 127.0 / amax_c, "wq": wq.contiguous(),
                         "ws": ws})
        self.scales = {
            "stem": stem,
            "enc": [f32(max(float(a) * headroom, 1e-6) / 127.0)
                    for a in vals[n_stem:]]}

    @torch.inference_mode()
    def __call__(self, images_u8) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.scales is None:
            raise RuntimeError("call calibrate() before quantized forward")
        with no_tf32():
            return self._forward(images_u8, None)

    @torch.inference_mode()
    def bf16(self, images_u8) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference fast path on the same weights: the port's
        ``Recognizer.encode`` (the stem kernel) and ``ctc_logits``, in the
        compute dtype."""
        imgs = torch.as_tensor(images_u8).to(self.device)
        mem = self.model.encode(imgs, self.dtype)
        return mem, self.model.ctc_logits(mem)
