"""Line-crop preprocessing: invert-if-dark, aspect resize to the model
height, pad, normalize — for a whole batch of variable-size crops.

``preprocess_lines`` is the hand-written CUDA kernel
(``csrc/preprocess_lines.cu``) that replaces the TPU kernel
``kiri_tpu/kernels/resize.py::preprocess_lines_tpu``;
``preprocess_lines_plain`` is the same function in plain torch, in the
interpolation-matrix form of the JAX package's ``preprocess_lines_ref``.
The wrapper takes the plain version only for CPU tensors; on a CUDA tensor
it launches the kernel or raises. ``enhance_lines`` and ``post_blur_masked``,
the adaptive crop cleanup around it, are plain torch ops on every device, as
they are plain XLA in the JAX package.

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
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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


def _gauss_taps(device) -> torch.Tensor:
    """The 5 float32 taps of the sigma-0.8 gaussian, normalized to sum 1.
    They are computed on the CPU on every device, so that a card's own
    ``exp`` cannot move them by an ulp."""
    x = torch.arange(-2, 3, dtype=torch.float32)
    k = torch.exp(-x * x / (2 * 0.8 ** 2))
    return (k / k.sum()).to(device)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two float32 values is exact in float64, so only the sum
    rounds (a second rounding, float64 to float32, could differ from a
    single one only on a float64 tie)."""
    return (a.double() * b.double() + c.double()).float()


def _gauss_rows_cols(x: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap gaussian of float32 [N, H, W] with edge replication:
    rows, then columns. The taps are added as the JAX package's compiled
    CPU code adds them: tap 1's product, then tap 0, 2, 3, 4 each as a
    fused multiply-add into the sum, so that the bytes agree."""
    k = _gauss_taps(x.device)

    def taps(p, sl):
        g = _fma(k[0], p[sl(0)], k[1] * p[sl(1)])
        for i in range(2, 5):
            g = _fma(k[i], p[sl(i)], g)
        return g
    h, w = x.shape[1], x.shape[2]
    p = F.pad(x[:, None], (0, 0, 2, 2), mode="replicate")[:, 0]
    g = taps(p, lambda i: (slice(None), slice(i, i + h)))
    p = F.pad(g[:, None], (2, 2, 0, 0), mode="replicate")[:, 0]
    return taps(p, lambda i: (slice(None), slice(None), slice(i, i + w)))


def post_blur_masked(norm: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The sigma-0.8 gaussian on the lines of a normalized [N, H, W] batch
    where ``mask`` [N] is set: small noisy crops, upscaled linearly by
    ``preprocess_lines``, are denoised at the model's scale."""
    g = _gauss_rows_cols(norm)
    return torch.where(mask[:, None, None], g, norm)


def _order_statistics(x: torch.Tensor, valid: torch.Tensor,
                      *idx: torch.Tensor) -> List[torch.Tensor]:
    """Per line, the ``idx[j]``-th smallest of the valid values of [N, H, W]
    for each j (the others sort as +inf)."""
    flat = torch.where(valid, x, torch.full_like(x, float("inf")))
    vals = flat.reshape(x.shape[0], -1).sort(dim=1).values
    return [vals.gather(1, i[:, None])[:, 0] for i in idx]


def enhance_lines(crops_u8: torch.Tensor, sizes: torch.Tensor, sharpen=False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adaptive cleanup of a batch of crops before ``preprocess_lines``, the
    port of ``kiri_tpu/kernels/resize.py::enhance_lines`` (plain XLA there,
    plain torch here).

    crops_u8 [N, Hmax, Wmax] u8 with each crop top-left, sizes [N, 2+]
    int32 (h, w, ...), ``sharpen`` a bool or a bool per line. Per line:
    salt-and-pepper spikes take the mean of their 8 neighbours; the noise
    sigma is read off mean-filter residuals; a noisy line at least 36 px
    high is blurred (sigma-0.8 gaussian), a clean one asked to ``sharpen``
    gets an unsharp mask; a compressed range (p99 < 240, 1 < p99 - p1 < 200)
    is stretched to 0..255. Pixels outside the crop are kept.

    Returns (crops u8, small_noisy [N] bool): noisy lines under 36 px are
    not blurred here; the caller resizes them linearly (the linear column of
    ``preprocess_lines``' sizes) and blurs after (``post_blur_masked``).
    """
    n, hmax, wmax = crops_u8.shape
    dev = crops_u8.device
    mask = torch.as_tensor(sharpen, dtype=torch.bool, device=dev
                           ).broadcast_to((n,))
    h = sizes[:, 0].to(torch.int64)
    w = sizes[:, 1].to(torch.int64)
    ys = torch.arange(hmax, device=dev)
    xs = torch.arange(wmax, device=dev)
    valid = (ys[None, :, None] < h[:, None, None]) & (
        xs[None, None, :] < w[:, None, None])
    hw = (h * w).clamp(min=1)
    # Edge-replicate the crop over the whole buffer, so that every
    # neighbourhood sees the crop's own edge.
    yi = torch.minimum(ys[None, :], h[:, None] - 1).clamp(min=0)
    xi = torch.minimum(xs[None, :], w[:, None] - 1).clamp(min=0)
    f = crops_u8.float().gather(1, yi[:, :, None].expand(n, hmax, wmax))
    f = f.gather(2, xi[:, None, :].expand(n, hmax, wmax))

    pad = F.pad(f[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    nbrs = torch.stack([pad[:, dy: dy + hmax, dx: dx + wmax]
                        for dy in (0, 1, 2) for dx in (0, 1, 2)
                        if not (dy == 1 and dx == 1)])
    nmin, nmax = nbrs.amin(0), nbrs.amax(0)
    nmean = nbrs.sum(0) / 8.0      # sums of 8 integers: exact in any order
    spikes = (((f <= 10.0) & (nmin >= 160.0))
              | ((f >= 245.0) & (nmax <= 95.0)))
    f = torch.where(spikes, nmean, f)

    # Robust noise sigma: the median of the mean-filter residuals.
    resid = (f - (nmean * 8.0 + f) / 9.0).abs()
    sigma = _order_statistics(resid, valid, (hw - 1) // 2)[0] * 1.398

    g = _gauss_rows_cols(f)
    noisy = sigma > 2.5
    small_noisy = noisy & (h < 36)
    f = torch.where((noisy & (h >= 36))[:, None, None], g, f)
    f = torch.where((mask & ~noisy)[:, None, None],
                    (f + 1.4 * (f - g)).clamp(0.0, 255.0), f)

    # Percentile stretch, p1 and p99 as the nearest order statistics.
    lo, hi = _order_statistics(f, valid, ((hw - 1) * 1 + 50) // 100,
                               ((hw - 1) * 99 + 50) // 100)
    rng = hi - lo
    # hi < 240 keeps the stretch to captures whose range is compressed.
    do = (hi < 240.0) & (rng > 1.0) & (rng < 200.0)
    den = torch.where(do, rng, torch.ones_like(rng))
    f = torch.where(do[:, None, None],
                    (f - lo[:, None, None]) / den[:, None, None] * 255.0, f)
    out = torch.round(f).clamp(0.0, 255.0).to(torch.uint8)
    return torch.where(valid, out, crops_u8), small_noisy
