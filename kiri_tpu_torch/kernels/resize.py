"""Line-crop preprocessing: invert-if-dark, aspect resize to the model
height, pad, normalize — for a whole batch of variable-size crops.

``preprocess_lines`` is the hand-written CUDA kernel
(``csrc/preprocess_lines.cu``) that replaces the TPU kernel
``kiri_tpu/kernels/resize.py::preprocess_lines_tpu``;
``preprocess_lines_plain`` is the same function in plain torch, in the
interpolation-matrix form of the JAX package's ``preprocess_lines_ref``.
The wrapper takes the plain version only for CPU tensors; on a CUDA tensor
it launches the kernel or raises.

Bound on an H100: memory (the valid crop bytes in, 4 bytes per output
sample out); at 128 crops padded to 128 x 704 that is ~5 us, so latency
decides. The kernel runs a block per (line, 12 output rows): each block sums
the valid region with 16-byte loads for the invert decision, resamples
separably (row pass into a shared-memory strip, column pass out of it) and
stores ``float4``. Lines wider than the strip take a direct path inside the
kernel.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from . import build

# Largest output width: its column tap table (20 bytes per column) shares
# the block's shared memory with the row-pass strip.
MAX_OUT_W = 2048


def pack_crops(crops: Sequence[np.ndarray], pad_multiple: int = 64
               ) -> Tuple[np.ndarray, np.ndarray]:
    """List of [h, w] u8 crops -> zero-padded [N, Hmax, Wmax] u8 buffer and
    sizes [N, 2] = (h, w). Hmax and Wmax round up to ``pad_multiple``."""
    rnd = lambda v: int(np.ceil(v / pad_multiple) * pad_multiple)  # noqa: E731
    hmax = rnd(max(c.shape[0] for c in crops))
    wmax = rnd(max(c.shape[1] for c in crops))
    buf = np.zeros((len(crops), hmax, wmax), np.uint8)
    sizes = np.zeros((len(crops), 2), np.int32)
    for i, c in enumerate(crops):
        buf[i, : c.shape[0], : c.shape[1]] = c
        sizes[i] = c.shape[:2]
    return buf, sizes


def _resample_weights(src, pos, upscale):
    """Triangle weights, or Keys cubic (a = -0.5) where ``upscale``."""
    d = (src - pos).abs()
    tri = (1.0 - d).clamp(min=0.0)
    a = -0.5
    cub1 = ((a + 2.0) * d - (a + 3.0)) * d * d + 1.0
    cub2 = a * (((d - 5.0) * d + 8.0) * d - 4.0)
    cubic = torch.where(d <= 1.0, cub1,
                        torch.where(d < 2.0, cub2, torch.zeros_like(d)))
    return torch.where(upscale, cubic, tri)


def _interp_matrix(src_len, out_len, n_out: int, n_src: int, linear):
    """Per-line interpolation matrices [N, n_out, n_src] resampling
    ``src_len`` -> ``out_len`` samples (both [N] float), rows renormalized."""
    dev = src_len.device
    dst = torch.arange(n_out, dtype=torch.float32, device=dev)[None, :, None]
    src = torch.arange(n_src, dtype=torch.float32, device=dev)[None, None, :]
    s_len = src_len[:, None, None]
    pos = (dst + 0.5) * (s_len / out_len[:, None, None]) - 0.5
    pos = torch.minimum(pos.clamp(min=0.0), s_len - 1.0)
    upscale = ((src_len < out_len) & ~linear)[:, None, None]
    w = _resample_weights(src, pos, upscale)
    w = torch.where(src < s_len, w, torch.zeros_like(w))
    s = w.sum(dim=2, keepdim=True)
    return w / torch.where(s.abs() < 1e-6, torch.ones_like(s), s)


def preprocess_lines_plain(crops_u8: torch.Tensor, sizes: torch.Tensor,
                           out_h: int, out_w: int) -> torch.Tensor:
    """crops_u8 [N, Hmax, Wmax] u8, sizes [N, 3] int32 = (h, w, linear)
    -> normalized float32 [N, out_h, out_w]."""
    n, hmax, wmax = crops_u8.shape
    img = crops_u8.float()
    h, w = sizes[:, 0], sizes[:, 1]
    linear = sizes[:, 2] != 0
    hf, wf = h.float(), w.float()
    ys = torch.arange(hmax, device=img.device)[None, :, None]
    xs = torch.arange(wmax, device=img.device)[None, None, :]
    valid = (ys < h[:, None, None]) & (xs < w[:, None, None])
    total = torch.where(valid, img, torch.zeros_like(img)).sum(dim=(1, 2))
    mean = total / (h * w).clamp(min=1).float()
    img = torch.where((mean < 127.0)[:, None, None], 255.0 - img, img)
    nw = torch.round((w * out_h).float() / hf.clamp(min=1.0)).clamp(1, out_w)
    ry = _interp_matrix(hf, torch.full_like(hf, out_h), out_h, hmax, linear)
    cx = _interp_matrix(wf, nw, out_w, wmax, linear)
    out = torch.matmul(torch.matmul(ry, img), cx.transpose(1, 2))
    out = out.clamp(0.0, 255.0)
    cols = torch.arange(out_w, device=img.device, dtype=torch.float32)
    out = torch.where(cols[None, None, :] < nw[:, None, None], out,
                      torch.full_like(out, 128.0))
    return (out / 255.0 - 0.5) / 0.5


def preprocess_lines(crops_u8: torch.Tensor, sizes: torch.Tensor,
                     out_h: int, out_w: int) -> torch.Tensor:
    """The CUDA kernel on CUDA tensors, the plain version on CPU tensors.

    crops_u8 [N, Hmax, Wmax] u8 with each crop top-left; sizes [N, 3] int32
    = (h, w, linear flag). Returns float32 [N, out_h, out_w] in [-1, 1].
    """
    if crops_u8.device.type == "cpu":
        return preprocess_lines_plain(crops_u8, sizes, out_h, out_w)
    n = crops_u8.shape[0]
    if (crops_u8.dim() != 3 or crops_u8.dtype != torch.uint8
            or not crops_u8.is_contiguous() or crops_u8.device.type != "cuda"):
        raise ValueError("crops_u8 must be a contiguous CUDA uint8 [N, H, W]")
    if (sizes.shape != (n, 3) or sizes.dtype != torch.int32
            or sizes.device != crops_u8.device or not sizes.is_contiguous()):
        raise ValueError("sizes must be a contiguous int32 [N, 3] on the "
                         "crops' device")
    if not (0 < out_h <= 256 and 0 < out_w <= MAX_OUT_W):
        raise ValueError(f"out shape ({out_h}, {out_w}) out of range")
    if crops_u8.shape[1] * crops_u8.shape[2] >= 2 ** 31:
        raise ValueError("a padded crop must hold fewer than 2^31 bytes")
    out = torch.empty((n, out_h, out_w), dtype=torch.float32,
                      device=crops_u8.device)
    if n == 0:
        return out
    lib = build.load("preprocess_lines")
    fn = lib.kiri_preprocess_lines
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(crops_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(crops_u8.data_ptr(), sizes.data_ptr(), out.data_ptr(), n,
                 crops_u8.shape[1], crops_u8.shape[2], out_h, out_w, stream)
    build.check(err, "preprocess_lines launch")
    preprocess_lines.launches += 1
    return out


preprocess_lines.launches = 0
