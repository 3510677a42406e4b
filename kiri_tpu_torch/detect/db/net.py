"""The DB (Differentiable Binarization) text-detection net as an
``nn.Module`` (the port of ``kiri_tpu/detect/db/net.py``, NCHW).

A residual backbone with GroupNorm (8 groups) at strides 4/8/16/32, an FPN
fused at stride 4, and two heads (probability and threshold) of conv3x3 ->
deconv2 -> deconv2 -> sigmoid. Two details carry the JAX net's numbers:

- JAX's ``"SAME"`` padding is asymmetric where the stride is 2: a 3x3
  stride-2 conv on an even size pads (0, 1), so the input is padded
  explicitly before an unpadded conv;
- ``jax.lax.conv_transpose`` does not flip its kernel: the weight converter
  flips the deconvolutions' kernels in H and W for ``F.conv_transpose2d``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (channels, blocks, stride) per stage; the stem halves the input first.
STAGES = ((32, 2, 2), (64, 2, 2), (128, 2, 2), (256, 2, 2))
FPN_CH = 64
GROUPS = 8
HEADS = ("prob", "thresh")


def _pad_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """JAX's "SAME" padding for a k x k kernel at stride s (low side gets
    the smaller half)."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class Conv(nn.Module):
    """Bias-free k x k conv with "SAME" padding, optionally GroupNorm."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 norm: bool = True):
        super().__init__()
        self.k, self.stride = k, stride
        self.conv = nn.Conv2d(cin, cout, k, stride, bias=False)
        self.gn = nn.GroupNorm(GROUPS, cout, eps=1e-5) if norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(_pad_same(x, self.k, self.stride))
        return y if self.gn is None else self.gn(y)


class Deconv(nn.Module):
    """2x2 stride-2 transposed conv with bias, optionally GroupNorm."""

    def __init__(self, cin: int, cout: int, norm: bool):
        super().__init__()
        self.deconv = nn.ConvTranspose2d(cin, cout, 2, 2)
        self.gn = nn.GroupNorm(GROUPS, cout, eps=1e-5) if norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.deconv(x)
        return y if self.gn is None else self.gn(y)


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class DBNet(nn.Module):
    """images [B, 1, H, W] normalized to [-1, 1] (H, W divisible by 32) ->
    probability map [B, H, W]; with ``train=True`` (probability map,
    threshold map), the threshold head being the one only training reads.
    GroupNorm holds no running state: both modes give the same numbers."""

    def __init__(self):
        super().__init__()
        layers: Dict[str, nn.Module] = {"stem": Conv(1, 16, 3, 2)}
        cin = 16
        for si, (c, blocks, stride) in enumerate(STAGES):
            for bi in range(blocks):
                st = stride if bi == 0 else 1
                layers[f"s{si}b{bi}_c1"] = Conv(cin, c, 3, st)
                layers[f"s{si}b{bi}_c2"] = Conv(c, c, 3)
                if cin != c:
                    layers[f"s{si}b{bi}_sc"] = Conv(cin, c, 1, st)
                elif st != 1:
                    raise ValueError("a strided block without a shortcut "
                                     "conv is not part of this topology")
                cin = c
        for si, (c, _, _) in enumerate(STAGES):
            layers[f"lat{si}"] = Conv(c, FPN_CH, 1, norm=False)
            layers[f"smooth{si}"] = Conv(FPN_CH, FPN_CH, 3, norm=False)
        for head in HEADS:
            layers[f"{head}_c1"] = Conv(4 * FPN_CH, FPN_CH, 3)
            layers[f"{head}_d1"] = Deconv(FPN_CH, FPN_CH, norm=True)
            layers[f"{head}_d2"] = Deconv(FPN_CH, 1, norm=False)
        self.layers = nn.ModuleDict(layers)

    def forward(self, images: torch.Tensor, train: bool = False):
        L = self.layers
        x = F.relu(L["stem"](images))
        feats: List[torch.Tensor] = []
        for si, (_, blocks, _) in enumerate(STAGES):
            for bi in range(blocks):
                pre = f"s{si}b{bi}"
                y = L[f"{pre}_c2"](F.relu(L[f"{pre}_c1"](x)))
                sc = L[f"{pre}_sc"](x) if f"{pre}_sc" in L else x
                x = F.relu(y + sc)
            feats.append(x)
        lats = [L[f"lat{si}"](f) for si, f in enumerate(feats)]
        for si in range(len(lats) - 2, -1, -1):
            lats[si] = lats[si] + _up2(lats[si + 1])
        smooth = [L[f"smooth{si}"](t) for si, t in enumerate(lats)]
        cat = [smooth[0]]
        for si in range(1, len(smooth)):
            u = smooth[si]
            for _ in range(si):
                u = _up2(u)
            cat.append(u)
        fused = torch.cat(cat, dim=1)
        maps = []
        for head in HEADS if train else HEADS[:1]:
            h = F.relu(L[f"{head}_c1"](fused))
            h = F.relu(L[f"{head}_d1"](h))
            maps.append(torch.sigmoid(L[f"{head}_d2"](h)[:, 0]))
        return tuple(maps) if train else maps[0]

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> "DBNet":
        """From-scratch weights with the JAX package's distributions: conv
        and deconv kernels normal with std sqrt(2 / fan in) (kh * kw * cin
        of the JAX kernel), deconv biases 0, GroupNorm at 1 and 0. ``gen``
        is a CPU generator."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                cin = w.shape[0 if isinstance(m, nn.ConvTranspose2d) else 1]
                std = (2.0 / (w.shape[2] * w.shape[3] * cin)) ** 0.5
                w.copy_(torch.randn(w.shape, generator=gen) * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.reset_parameters()
        return self


def state_dict_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX package's DB parameters, flat as ``load_db_checkpoint`` reads
    them (``params.<layer>.w``, ``.b``, ``.gn.scale``, ``.gn.bias``; HWIO
    kernels), as ``DBNet``'s state dict. ``stats.*`` entries (GroupNorm has
    no running state) must be absent or empty."""
    sd: Dict[str, torch.Tensor] = {}
    for key, val in flat.items():
        parts = key.split(".")
        if parts[0] != "params":
            raise ValueError(f"unexpected DB checkpoint entry {key}")
        layer, leaf = parts[1], ".".join(parts[2:])
        v = np.asarray(val, np.float32)
        deconv = layer.endswith(("_d1", "_d2"))
        if leaf == "w" and deconv:
            # HWIO -> [in, out, kh, kw], flipped: JAX does not flip it.
            sd[f"layers.{layer}.deconv.weight"] = torch.from_numpy(
                np.ascontiguousarray(v.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]))
        elif leaf == "w":
            sd[f"layers.{layer}.conv.weight"] = torch.from_numpy(
                np.ascontiguousarray(v.transpose(3, 2, 0, 1)))
        elif leaf == "b":
            sd[f"layers.{layer}.deconv.bias"] = torch.from_numpy(v.copy())
        elif leaf in ("gn.scale", "gn.bias"):
            name = "weight" if leaf == "gn.scale" else "bias"
            sd[f"layers.{layer}.gn.{name}"] = torch.from_numpy(v.copy())
        else:
            raise ValueError(f"unexpected DB checkpoint entry {key}")
    return sd


def flat_from_state_dict(sd: Dict[str, torch.Tensor]
                         ) -> Dict[str, np.ndarray]:
    """Inverse of ``state_dict_from_jax``: ``DBNet``'s state dict as the
    JAX package's flat ``params.<layer>.<leaf>`` float32 arrays."""
    flat: Dict[str, np.ndarray] = {}
    for key, val in sd.items():
        v = val.detach().float().cpu().numpy()
        _, layer, kind, name = key.split(".")
        pre = f"params.{layer}"
        if kind == "deconv" and name == "weight":
            flat[f"{pre}.w"] = np.ascontiguousarray(
                v[:, :, ::-1, ::-1].transpose(2, 3, 0, 1))
        elif kind == "conv":
            flat[f"{pre}.w"] = np.ascontiguousarray(v.transpose(2, 3, 1, 0))
        elif kind == "deconv":
            flat[f"{pre}.b"] = v
        else:
            flat[f"{pre}.gn.{'scale' if name == 'weight' else 'bias'}"] = v
    return flat


def build_db_net(flat: Dict[str, np.ndarray]) -> DBNet:
    """A ``DBNet`` holding the JAX-layout parameters ``flat``, loaded with
    ``strict=True``."""
    net = DBNet()
    net.load_state_dict(state_dict_from_jax(flat), strict=True)
    return net.eval()
