"""The recognizer's conv stem: four 3x3 SAME convs with BatchNorm folded
into the weights and SiLU after each; strides (1,1),(2,2),(2,2),(2,1),
channels 1 -> 48 -> 96 -> 160 -> D.

``stem_fused`` runs it through the hand-written CUDA kernel
``csrc/stem_conv.cu`` (one launch per layer), which replaces the TPU kernel
``kiri_tpu/kernels/stem.py::stem_fused_tpu``. ``stem_plain`` is the same
arithmetic with ``F.conv2d``: conv0 in float32 with float32 weights, convs
1-3 on operands rounded to the compute dtype, each layer summed in float32,
biased, passed through SiLU and rounded once to the compute dtype. The
wrapper takes the plain version only for CPU tensors; on a CUDA tensor it
launches the kernel or raises.

Layouts are the JAX package's: [B, H, W] normalized lines in, NHWC
[B, H/8, W/4, D] features out.

Bound on an H100: operations (~1.9 GFLOP per 48 x 640 line against ~0.55 MB
of input and output per line), i.e. ~0.3 ms at batch 128 on the bf16 tensor
cores; the kernel runs its products on the float32 CUDA cores.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import build

STRIDES = ((1, 1), (2, 2), (2, 2), (2, 1))
BN_EPS = 1e-5


def fold_stem_weights(net: torch.nn.Sequential, dtype: torch.dtype
                      ) -> Tuple[torch.Tensor, ...]:
    """BN-fold the stem ``net`` (conv, BN, SiLU) x 4 for inference.

    Returns (w0, b0, w1, b1, w2, b2, w3, b3): each wi is [9*Cin, Cout] with
    rows ordered (dy, dx, cin) — the JAX package's HWIO weights reshaped —
    float32 for conv0 and ``dtype`` for convs 1-3; each bi is float32 [Cout].
    """
    out = []
    for i in range(4):
        conv, bn = net[3 * i], net[3 * i + 1]
        inv = bn.weight * torch.rsqrt(bn.running_var + BN_EPS)
        w = conv.weight * inv[:, None, None, None]          # OIHW
        w = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])   # [9*Cin, Cout]
        out += [w.float() if i == 0 else w.to(dtype),
                (bn.bias - bn.running_mean * inv).float()]
    return tuple(t.contiguous() for t in out)


def stem_plain(x: torch.Tensor, folded: Tuple[torch.Tensor, ...]
               ) -> torch.Tensor:
    """x [B, H, W] in the compute dtype -> NHWC [B, H/8, W/4, D]."""
    h = x.unsqueeze(1)
    for i, stride in enumerate(STRIDES):
        w, b = folded[2 * i], folded[2 * i + 1]
        cin, cout = w.shape[0] // 9, w.shape[1]
        w = w.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
        h = F.conv2d(h.float(), w.float(), stride=stride, padding=1)
        h = F.silu(h + b[None, :, None, None]).to(x.dtype)
    return h.permute(0, 2, 3, 1).contiguous()


def stem_fused(x: torch.Tensor, folded: Tuple[torch.Tensor, ...]
               ) -> torch.Tensor:
    """The CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return stem_plain(x, folded)
    if (x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16)
            or x.device.type != "cuda"):
        raise ValueError("x must be a CUDA float32/bfloat16 [B, H, W]")
    for i, t in enumerate(folded):
        want = (torch.float32 if i % 2 or i == 0 else x.dtype)
        if t.device != x.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"folded[{i}] must be contiguous {want} on "
                             f"{x.device}")
    lib = build.load("stem_conv")
    fn = lib.kiri_stem_conv3x3_silu
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    h = x.contiguous()
    b, hh, ww = h.shape
    cin = 1
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for i, (sh, sw) in enumerate(STRIDES):
            w, bias = folded[2 * i], folded[2 * i + 1]
            cout = w.shape[1]
            if w.shape[0] != 9 * cin:
                raise ValueError(f"conv{i} weights {tuple(w.shape)} do not "
                                 f"take {cin} input channels")
            ho, wo = (hh - 1) // sh + 1, (ww - 1) // sw + 1
            out = torch.empty((b, ho, wo, cout), dtype=x.dtype,
                              device=x.device)
            if out.numel():
                err = fn(h.data_ptr(), w.data_ptr(), bias.data_ptr(),
                         out.data_ptr(), b, hh, ww, cin, cout, sh, sw,
                         int(x.dtype == torch.bfloat16), int(i == 0), stream)
                build.check(err, f"stem conv{i} launch")
                stem_fused.launches += 1
            h, hh, ww, cin = out, ho, wo, cout
    return h


stem_fused.launches = 0
