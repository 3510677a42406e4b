"""The recognizer's conv stem: four 3x3 SAME convs with BatchNorm folded
into the weights and SiLU after each; strides (1,1),(2,2),(2,2),(2,1),
channels 1 -> 48 -> 96 -> 160 -> D.

``stem_fused`` runs it through the hand-written CUDA kernels that replace
the TPU kernel ``kiri_tpu/kernels/stem.py::stem_fused_tpu``, three launches
each, conv0 computed inside conv1's persistent block by warps of its own
beside the ones that multiply, so its output never reaches device memory.
Each of convs 1-3 is an implicit GEMM on the tensor cores (``wgmma``, A
through registers by ``ldmatrix`` at tap-shifted addresses of an input patch
staged in shared memory with ``cp.async``, the weights through a
shared-memory ring that ``wgmma`` reads directly):

* bfloat16: ``csrc/stem_mma.cu``, bf16 operands and float32 sums;
  ``MMA_TILES`` and ``tile_plan`` state its tiling, ``pack_stem_weights``
  the weight layout it reads.
* float32: ``stem_fused_f32``, ``csrc/stem_f32x3.cu``, 3xTF32: each operand
  split once into tf32 hi and lo halves (``split_tf32``), three products a
  step (a_lo*w_hi, a_hi*w_lo, a_hi*w_hi) into float32 sums, which keeps
  float32 accuracy. ``F32_TILES`` states its tiling, ``pack_tf32_weights``
  its weight layout. It is what holds the port's texts to ``kiri_tpu``'s at
  float32.

``stem_plain`` is the same arithmetic with ``F.conv2d``: conv0 in float32
with float32 weights, convs 1-3 on operands rounded to the compute dtype,
each layer summed in float32, biased, passed through SiLU and rounded once
to the compute dtype. The wrappers take the plain version only for CPU
tensors; on a CUDA tensor they launch their kernel or raise.

``StemWeightCache`` folds (and packs) a stem's weights once per dtype and
device and again only when its parameters or buffers change.

Layouts are the JAX package's: [B, H, W] normalized lines in, NHWC
[B, H/8, W/4, D] features out.

Bound on an H100: operations (~1.9 GFLOP per 48 x 640 line against ~0.55 MB
of input and output per line), i.e. ~0.3 ms at batch 128 on the bf16 tensor
cores and ~1.5 ms for the three TF32 passes of the float32 route;
``PERF.md`` has the measured times of both routes.
"""
from __future__ import annotations

import ctypes
import re
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..weight_cache import WeightCache
from . import build

STRIDES = ((1, 1), (2, 2), (2, 2), (2, 1))
BN_EPS = 1e-5
#: Channels both kernels are compiled for: conv0 .. conv3 outputs.
MMA_CHANNELS = (48, 96, 160, 256)
#: Per layer of ``csrc/stem_mma.cu``: the block's rectangle of output pixels
#: (th, tw), read from the header the kernel is compiled with.
MMA_TILES = {int(layer): (int(th), int(tw)) for layer, th, tw in re.findall(
    r"#define KIRI_STEM_TILE_(\d) +(\d+), *(\d+),",
    (build.CSRC / "stem_mma_tiles.h").read_text())}
#: Per layer of ``csrc/stem_f32x3.cu``: (th, tw, nb, cc, nst), the block's
#: rectangle of output pixels and number of output channels, the input
#: channels of a chunk of the reduction and the stages of its weight ring,
#: read from the header the kernel is compiled with.
F32_TILES = {int(m[0]): tuple(int(v) for v in m[1:]) for m in re.findall(
    r"#define KIRI_STEM_F32_TILE_(\d) +" + ", *".join([r"(\d+)"] * 5),
    (build.CSRC / "stem_f32x3_tiles.h").read_text())}


class FoldedStem(tuple):
    """``(w0, b0, w1, b1, w2, b2, w3, b3)`` of ``fold_stem_weights``;
    ``packed`` holds w1..w3 in the layout of the kernel of the folded dtype
    (``pack_stem_weights`` for bfloat16, ``pack_tf32_weights`` for float32)
    once that kernel has asked for them."""

    packed: Optional[Tuple[torch.Tensor, ...]] = None


def fold_stem_weights(net: torch.nn.Sequential, dtype: torch.dtype
                      ) -> FoldedStem:
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
    return FoldedStem(t.contiguous() for t in out)


def pack_stem_weights(w: torch.Tensor) -> torch.Tensor:
    """Folded [9*Cin, Cout] weights -> the bf16 kernel's
    [9*Cin/16, 2, Cout/8, 8, 8]: steps of 16 reduction rows (one ``wgmma``),
    so that any run of steps, a stage of the kernel's shared-memory ring, is
    one contiguous copy; in a step, the unswizzled K-major layout of a
    ``wgmma`` B descriptor: 8 x 8 core matrices [channel][k] of 128
    contiguous bytes, ordered (k half, group of 8 channels)."""
    k, cout = w.shape
    if k % 16 or cout % 8:
        raise ValueError(f"[{k}, {cout}] weights do not split into steps of "
                         f"16 rows of 8 x 8 core matrices")
    w = w.reshape(k // 16, 2, 8, cout // 8, 8)
    return w.permute(0, 1, 3, 4, 2).contiguous()


def unpack_stem_weights(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_stem_weights``."""
    steps, _, groups, _, _ = packed.shape
    return packed.permute(0, 1, 4, 2, 3).reshape(steps * 16,
                                                 groups * 8).contiguous()


def split_tf32(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``t`` -> (hi, lo), float32 tensors of tf32 values (the 13 low
    mantissa bits zero): hi is ``t`` rounded to tf32 as ``cvt.rna.tf32.f32``
    rounds (to nearest, ties away from zero), lo is ``t - hi`` rounded the
    same way, so that hi + lo is ``t`` to 2^-21 of ``|t|``."""
    if t.dtype != torch.float32:
        raise ValueError(f"split_tf32 takes float32, not {t.dtype}")

    def rna(v: torch.Tensor) -> torch.Tensor:
        # Half a tf32 ulp added to the magnitude bits, then truncated.
        return ((v.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF
                ).view(torch.float32)

    hi = rna(t)
    return hi, rna(t - hi)


def pack_tf32_weights(w: torch.Tensor, chunk: int, nb: int) -> torch.Tensor:
    """Folded float32 [9*Cin, Cout] weights -> the float32 kernel's
    [Cout/nb, 9*Cin/chunk, 2, chunk/8, 2, nb/8, 8, 4]: per block of ``nb``
    output channels, the taps of each chunk of
    ``chunk`` input channels in the kernel's reduction order (chunk, dy, dx,
    channel in chunk), so that a stage of its shared-memory ring (a row of
    3 taps) is one contiguous copy; in a tap, the tf32 hi half of
    ``split_tf32`` and then the lo half; in a half, steps of 8 rows (one
    ``wgmma`` k8) in the unswizzled K-major layout of a ``wgmma`` B
    descriptor for 32-bit types: 8 x 4 core matrices [channel][k] of 128
    contiguous bytes, ordered (k half, group of 8 channels)."""
    k, cout = w.shape
    if (w.dtype != torch.float32 or k % 9 or (k // 9) % chunk or chunk % 8
            or nb % 8 or cout % nb):
        raise ValueError(f"{w.dtype} [{k}, {cout}] weights do not split "
                         f"into float32 chunks of {chunk} rows and blocks of "
                         f"{nb} channels of 8 x 4 core matrices")
    cin = k // 9

    def arrange(t: torch.Tensor) -> torch.Tensor:
        # (tap, chunk, step, k half, k, block, group, channel) -> (block,
        # chunk, tap, step, k half, group, channel, k)
        t = t.reshape(9, cin // chunk, chunk // 8, 2, 4, cout // nb, nb // 8,
                      8)
        return t.permute(5, 1, 0, 2, 3, 6, 7, 4).reshape(
            cout // nb, 9 * cin // chunk, chunk // 8, 2, nb // 8, 8, 4)

    return torch.stack([arrange(h) for h in split_tf32(w)], 2).contiguous()


def unpack_tf32_weights(packed: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of ``pack_tf32_weights``: (hi, lo), each [9*Cin, Cout]."""
    blocks, stages, _, steps, _, groups, _, _ = packed.shape
    chunks = stages // 9

    def back(t: torch.Tensor) -> torch.Tensor:
        t = t.reshape(blocks, chunks, 9, steps, 2, groups, 8, 4)
        return t.permute(2, 1, 3, 4, 7, 0, 5, 6).reshape(
            stages * steps * 8, blocks * groups * 8).contiguous()

    return back(packed[:, :, 0]), back(packed[:, :, 1])


class Tile(NamedTuple):
    """One block of a stem kernel: output pixels [oy0, oy1) x [ox0, ox1)
    (clipped to the layer's output) and the input patch it stages, rows
    [iy0, iy0 + ph) and columns [ix0, ix0 + pw) of the layer's input, which
    reach one pixel past the image where the tile touches its edge."""
    oy0: int
    oy1: int
    ox0: int
    ox1: int
    iy0: int
    ix0: int
    ph: int
    pw: int


def tile_plan(layer: int, h: int, w: int,
              tiles: Dict[int, Tuple[int, ...]] = MMA_TILES) -> List[Tile]:
    """The blocks (or, for layer 1, the tiles of the persistent blocks) of
    layer ``layer`` (1-3) of ``csrc/stem_mma.cu``, or with ``F32_TILES`` of
    ``csrc/stem_f32x3.cu``, over one image whose input to that layer is
    ``h`` x ``w``, in launch order."""
    th, tw = tiles[layer][:2]
    sh, sw = STRIDES[layer]
    ho, wo = (h - 1) // sh + 1, (w - 1) // sw + 1
    ph, pw = (th - 1) * sh + 3, (tw - 1) * sw + 3
    return [Tile(oy0, min(oy0 + th, ho), ox0, min(ox0 + tw, wo),
                 oy0 * sh - 1, ox0 * sw - 1, ph, pw)
            for oy0 in range(0, ho, th) for ox0 in range(0, wo, tw)]


def _stem_tensors(net: torch.nn.Sequential) -> List[torch.Tensor]:
    out = []
    for i in range(4):
        conv, bn = net[3 * i], net[3 * i + 1]
        out += [conv.weight, bn.weight, bn.bias, bn.running_mean,
                bn.running_var]
    return out


class StemWeightCache(WeightCache):
    """The folded weights of one stem, per (dtype, device), rebuilt when a
    parameter or buffer of the stem changes (see ``WeightCache``)."""

    def get(self, net: torch.nn.Sequential, dtype: torch.dtype) -> FoldedStem:
        return self.lookup(_stem_tensors(net), dtype,
                           lambda: fold_stem_weights(net, dtype))


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


def _check_folded(x: torch.Tensor, folded: Tuple[torch.Tensor, ...]) -> None:
    if (x.dim() != 3 or x.device.type != "cuda"
            or x.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError("x must be a CUDA float32/bfloat16 [B, H, W]")
    if len(folded) != 8:
        raise ValueError("folded must hold (w, b) of four layers")
    cin = 1
    for i, t in enumerate(folded):
        want = (torch.float32 if i % 2 or i == 0 else x.dtype)
        if t.device != x.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"folded[{i}] must be contiguous {want} on "
                             f"{x.device}")
        if i % 2 == 0:
            if t.dim() != 2 or t.shape[0] != 9 * cin:
                raise ValueError(f"conv{i // 2} weights {tuple(t.shape)} do "
                                 f"not take {cin} input channels")
            cin = t.shape[1]
        elif t.shape != (cin,):
            raise ValueError(f"conv{i // 2} bias {tuple(t.shape)} is not "
                             f"[{cin}]")


# dtype -> (source, C entry) of the kernel that serves it.
_LAYER_KERNELS = {torch.bfloat16: ("stem_mma", "kiri_stem_mma_layer"),
                  torch.float32: ("stem_f32x3", "kiri_stem_f32x3_layer")}


def stem_mma_layer(layer: int, h: torch.Tensor, folded: FoldedStem
                   ) -> torch.Tensor:
    """One launch of ``csrc/stem_mma.cu`` (bfloat16, counted in
    ``stem_fused.launches``) or ``csrc/stem_f32x3.cu`` (float32, counted in
    ``stem_fused_f32.launches``), as ``h`` and ``folded`` are. layer 1:
    lines [B, H, W] -> conv0 and conv1, NHWC [B, H/2, W/2, 96]; layers 2, 3:
    the NHWC output of the layer before -> this layer's. w1..w3 are packed
    at the first launch and kept on ``folded``."""
    if not isinstance(folded, FoldedStem):
        raise ValueError("folded must be a FoldedStem, which keeps the "
                         "packed weights")
    chans = tuple(folded[2 * i].shape[1] for i in range(4))
    if chans != MMA_CHANNELS:
        raise ValueError(f"the stem kernels are compiled for channels "
                         f"{MMA_CHANNELS}, not {chans}")
    want = 3 if layer == 1 else 4
    if (layer not in MMA_TILES or h.dim() != want or not h.is_contiguous()
            or h.dtype not in _LAYER_KERNELS or h.dtype != folded[2].dtype
            or h.device != folded[0].device or h.device.type != "cuda"
            or (layer > 1 and h.shape[3] != chans[layer - 1])):
        raise ValueError(f"layer {layer} takes a contiguous CUDA bfloat16 or "
                         f"float32 tensor of {want} dimensions, in the dtype "
                         f"of the folded weights")
    source, entry = _LAYER_KERNELS[h.dtype]
    if folded.packed is None:
        folded.packed = tuple(
            pack_stem_weights(folded[2 * i]) if h.dtype == torch.bfloat16
            else pack_tf32_weights(folded[2 * i], F32_TILES[i][3],
                                   F32_TILES[i][2])
            for i in (1, 2, 3))
    fn = getattr(build.load(source), entry)
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    b, hh, ww = h.shape[:3]
    sh, sw = STRIDES[layer]                      # conv0 keeps the size
    ho, wo = (hh - 1) // sh + 1, (ww - 1) // sw + 1
    out = torch.empty((b, ho, wo, chans[layer]), dtype=h.dtype,
                      device=h.device)
    if out.numel():
        with torch.cuda.device(h.device):
            err = fn(layer, h.data_ptr(), folded[0].data_ptr(),
                     folded[1].data_ptr(),
                     folded.packed[layer - 1].data_ptr(),
                     folded[2 * layer + 1].data_ptr(), out.data_ptr(),
                     b, hh, ww, torch.cuda.current_stream().cuda_stream)
        build.check(err, f"{source} layer {layer} launch")
        if h.dtype == torch.float32:
            stem_fused_f32.launches += 1
        else:
            stem_fused.launches += 1
    return out


def stem_fused(x: torch.Tensor, folded: Tuple[torch.Tensor, ...]
               ) -> torch.Tensor:
    """The CUDA kernels on CUDA tensors, three launches of
    ``stem_mma_layer`` (bfloat16: ``stem_mma.cu``, counted here; float32:
    ``stem_f32x3.cu``, counted in ``stem_fused_f32``), the plain version on
    CPU tensors."""
    if x.device.type == "cpu":
        return stem_plain(x, folded)
    _check_folded(x, folded)
    if not isinstance(folded, FoldedStem):
        folded = FoldedStem(folded)      # packed once for this call
    h = x.contiguous()
    for layer in (1, 2, 3):
        h = stem_mma_layer(layer, h, folded)
    return h


stem_fused.launches = 0


def stem_fused_f32(x: torch.Tensor, folded: Tuple[torch.Tensor, ...]
                   ) -> torch.Tensor:
    """The float32 route of ``stem_fused``: ``csrc/stem_f32x3.cu``, 3xTF32
    on the tensor cores, three launches (conv0 + conv1, conv2, conv3),
    counted here. Takes a contiguous CUDA float32 [B, H, W] and raises on
    anything else."""
    if (x.device.type != "cuda" or x.dtype != torch.float32
            or not x.is_contiguous()):
        raise ValueError("stem_fused_f32 takes contiguous CUDA float32 lines")
    return stem_fused(x, folded)


stem_fused_f32.launches = 0
