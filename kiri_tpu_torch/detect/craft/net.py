"""The CRAFT text-detection net as an ``nn.Module`` (the port of
``kiri_tpu/detect/craft/net.py``, NCHW).

A VGG-style encoder of four stages (3x3 convs without bias, GroupNorm with 8
groups, ReLU; a 2x2 max-pool after each stage), a context block (a 3x3 conv
at dilation 2 and a 1x1 conv), three decoder stages (bilinear 2x upsample,
concatenation with the encoder's skip, two conv-GroupNorm-ReLU) and a 1x1
head with bias: region and affinity logits at half the input resolution.

JAX's bilinear ``jax.image.resize`` renormalises its triangle kernel over
the taps inside the image, which at 2x upsampling reads the edge pixel
itself: ``F.interpolate(..., align_corners=False)`` clamps the source
position to the same pixel.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

ENC = ((32, 2), (64, 2), (128, 3), (256, 3))  # (channels, convs) per stage
CTX_CH = 256
DEC_CH = (128, 64, 32)
GROUPS = 8
#: Input sides must be multiples of this (four 2x2 pools on even sizes).
MULTIPLE = 16


class ConvGN(nn.Module):
    """Bias-free k x k conv ("SAME" at stride 1), GroupNorm, ReLU."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=dilation * (k - 1) // 2,
                              dilation=dilation, bias=False)
        self.gn = nn.GroupNorm(GROUPS, cout, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.gn(self.conv(x)))


class CRAFTNet(nn.Module):
    """images [B, 1, H, W] normalized to [-1, 1] (H, W multiples of 16) ->
    (region logits, affinity logits), each [B, H/2, W/2]."""

    def __init__(self):
        super().__init__()
        layers: Dict[str, nn.Module] = {}
        cin = 1
        for si, (c, convs) in enumerate(ENC):
            for ci in range(convs):
                layers[f"e{si}c{ci}"] = ConvGN(cin, c, 3)
                cin = c
        layers["ctx1"] = ConvGN(cin, CTX_CH, 3, dilation=2)
        layers["ctx2"] = ConvGN(CTX_CH, CTX_CH, 1)
        skip_ch = [c for c, _ in ENC[1:]][::-1]
        dcin = CTX_CH
        for di, (dc, sc) in enumerate(zip(DEC_CH, skip_ch)):
            layers[f"d{di}c1"] = ConvGN(dcin + sc, dc, 3)
            layers[f"d{di}c2"] = ConvGN(dc, dc, 3)
            dcin = dc
        self.layers = nn.ModuleDict(layers)
        self.head = nn.Conv2d(dcin, 2, 1)

    def forward(self, images: torch.Tensor):
        h, w = images.shape[-2:]
        if h % MULTIPLE or w % MULTIPLE:
            raise ValueError(f"CRAFT input sides must be multiples of "
                             f"{MULTIPLE}, got {h}x{w}")
        L = self.layers
        x = images
        skips: List[torch.Tensor] = []
        for si, (_, convs) in enumerate(ENC):
            for ci in range(convs):
                x = L[f"e{si}c{ci}"](x)
            skips.append(x)
            x = F.max_pool2d(x, 2)
        x = L["ctx2"](L["ctx1"](x))
        for di in range(len(DEC_CH)):
            x = F.interpolate(x, scale_factor=2, mode="bilinear",
                              align_corners=False)
            x = torch.cat([x, skips[-(di + 1)]], dim=1)
            x = L[f"d{di}c2"](L[f"d{di}c1"](x))
        head = self.head(x)
        return head[:, 0], head[:, 1]

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> "CRAFTNet":
        """From-scratch weights with the JAX package's distributions: conv
        kernels normal with std sqrt(2 / fan in), the head's bias 0,
        GroupNorm at 1 and 0. ``gen`` is a CPU generator."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                w = m.weight
                std = (2.0 / w[0].numel()) ** 0.5
                w.copy_(torch.randn(w.shape, generator=gen) * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.reset_parameters()
        return self


def state_dict_from_flat(flat: Dict[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
    """The JAX package's CRAFT parameters, flat as its checkpoint stores
    them (``params.<layer>.w`` HWIO, ``.gn.scale``, ``.gn.bias``;
    ``params.head.w`` / ``.b``), as ``CRAFTNet``'s state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for key, val in flat.items():
        parts = key.split(".")
        if parts[0] != "params":
            raise ValueError(f"unexpected CRAFT checkpoint entry {key}")
        layer, leaf = parts[1], ".".join(parts[2:])
        v = np.asarray(val, np.float32)
        pre = "head" if layer == "head" else f"layers.{layer}"
        if leaf == "w":
            name = f"{pre}.weight" if layer == "head" else f"{pre}.conv.weight"
            sd[name] = torch.from_numpy(np.ascontiguousarray(
                v.transpose(3, 2, 0, 1)))
        elif leaf == "b" and layer == "head":
            sd["head.bias"] = torch.from_numpy(v.copy())
        elif leaf in ("gn.scale", "gn.bias"):
            name = "weight" if leaf == "gn.scale" else "bias"
            sd[f"{pre}.gn.{name}"] = torch.from_numpy(v.copy())
        else:
            raise ValueError(f"unexpected CRAFT checkpoint entry {key}")
    return sd


def flat_from_state_dict(sd: Dict[str, torch.Tensor]
                         ) -> Dict[str, np.ndarray]:
    """Inverse of ``state_dict_from_flat``: ``CRAFTNet``'s state dict as
    the JAX package's flat ``params.<layer>.<leaf>`` float32 arrays."""
    flat: Dict[str, np.ndarray] = {}
    for key, val in sd.items():
        v = val.detach().float().cpu().numpy()
        parts = key.split(".")
        if parts[0] == "head":
            layer, kind, name = "head", "conv", parts[1]
        else:
            _, layer, kind, name = parts
        pre = f"params.{layer}"
        if kind == "conv" and name == "weight":
            flat[f"{pre}.w"] = np.ascontiguousarray(v.transpose(2, 3, 1, 0))
        elif kind == "conv":
            flat[f"{pre}.b"] = v
        else:
            flat[f"{pre}.gn.{'scale' if name == 'weight' else 'bias'}"] = v
    return flat


def build_craft_net(flat: Dict[str, np.ndarray]) -> CRAFTNet:
    """A ``CRAFTNet`` holding the JAX-layout parameters ``flat``, loaded
    with ``strict=True``."""
    net = CRAFTNet()
    net.load_state_dict(state_dict_from_flat(flat), strict=True)
    return net.eval()
