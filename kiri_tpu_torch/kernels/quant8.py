"""The int8 contractions of the recognizer's int8 fast path
(``ops/quant8.Q8Encoder``): s8 x s8 -> s32 products with a float32 dequant
epilogue, each a hand-written CUDA kernel on ``wgmma`` s8 beside its plain
torch version.

* ``q8_stem01``: conv0 and conv1 of the stem in one launch
  (``csrc/q8_stem.cu``, ``kiri_q8_stem01``): conv0 takes the u8 line as
  int8(u8 - 128) and adds the float32 correction ``corr`` of the +0.5 term;
  its output is rounded to the compute dtype and quantized for conv1 inside
  the kernel, and never reaches device memory.
* ``q8_conv3x3``: one 3x3 convolution, padding (1, 1), NHWC, then SiLU and
  the cast to the compute dtype; its float input quantized per channel on
  the way in. On the card it runs conv2 and conv3 (``kiri_q8_conv_layer``).
  Both replace the XLA int8 ``conv_general_dilated`` of
  ``kiri_tpu/ops/quant8.py`` (:149-153, :167-170).
* ``q8_linear``: x [..., K] quantized with one scale, times int8 weights
  [N, K], dequantized (``csrc/q8_gemm.cu``). Replaces ``_dense_q8``'s
  ``dot_general`` (:65-66) with ``_qa`` (:55-58) fused into its prologue.

Quantization is ``kiri_tpu``'s: x * inv in float32, round half to even,
clamp to +-127. The epilogues apply the float32 operations in ``kiri_tpu``'s
order, conv0 ``(acc * scale + corr) + bias``, the others ``acc * scale +
bias``, where the GEMM's scale is ``w_scale * a_scale`` formed beforehand.

The kernels read their weights packed into ``wgmma``'s 8-bit core matrices
(``pack_q8_weights``). The wrappers take the int8 [N, K] weights and pack
them on the card once for each weight tensor, the first time they meet it,
keeping the packed copy while that tensor lives and is not written to
(``_packed``). Their tilings
live in ``csrc/q8_tiles.h`` and are read from there (``Q8_TILES``,
``Q8_GEMM``), so that the CPU tests check the tile walks
(``tests/test_torch_q8_tiles.py``).

The plain versions take the integer products exactly through float64: every
int8 x int8 sum here is below 127^2 * 1440 < 2^53, so an im2col matmul in
float64 is exact (float32 is not, above 2^24), and its conversion to float32
rounds as int32 -> float32 does. The wrappers take the plain version only
for CPU tensors; on a CUDA tensor they launch their kernel or raise.
"""
from __future__ import annotations

import ctypes
import re
import weakref
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from . import build
from .stem import MMA_CHANNELS, STRIDES

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILES_H = (build.CSRC / "q8_tiles.h").read_text()
#: Per layer of ``csrc/q8_stem.cu`` (1: conv0 + conv1, 2: conv2, 3:
#: conv3): (th, tw, nst, sps, minb), the block's rectangle of output pixels,
#: the stages of its weight ring, the k32 steps a stage and the blocks an SM;
#: ``stem.tile_plan(layer, h, w, Q8_TILES)`` gives a launch's tiles.
Q8_TILES = {int(m[0]): tuple(int(v) for v in m[1:]) for m in re.findall(
    r"#define KIRI_Q8_TILE_(\d) +" + ", *".join([r"(\d+)"] * 5), _TILES_H)}
#: ``csrc/q8_gemm.cu``: (bm, nc, sps, nst), the rows of a block, the columns
#: of a chunk of N, the k32 steps of a weight stage and the ring's stages.
Q8_GEMM = tuple(int(v) for v in re.search(
    r"#define KIRI_Q8_GEMM +" + ", *".join([r"(\d+)"] * 4), _TILES_H).groups())


def f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float."""
    return float(np.float32(v))


def quantize(x: torch.Tensor, inv: Union[float, torch.Tensor]
             ) -> torch.Tensor:
    """int8 of x * inv in float32, rounded half to even, clamped to +-127;
    ``inv`` a float32 value (a float, or a tensor that broadcasts over x's
    last dimension)."""
    if not isinstance(inv, torch.Tensor):
        inv = f32(inv)
    return torch.round(x.float() * inv).clamp(-127, 127).to(torch.int8)


def q8_matmul_acc(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 xq [..., K] x int8 w [N, K]^T, the sums exact, as float64."""
    return torch.matmul(xq.double(), w.double().t())


def q8_conv_acc(xq: torch.Tensor, w: torch.Tensor,
                stride: Tuple[int, int]) -> torch.Tensor:
    """int8 NHWC xq [B, H, W, Cin] conv int8 w [Cout, 9 * Cin] ((dy, dx,
    cin) order), padding (1, 1): the exact sums as float64 NHWC
    [B, Ho, Wo, Cout] (im2col and a float64 matmul)."""
    b, h, wd, cin = xq.shape
    cout = w.shape[0]
    cols = F.unfold(xq.permute(0, 3, 1, 2).double(), 3, padding=1,
                    stride=stride)                        # [B, Cin*9, L]
    wk = w.reshape(cout, 3, 3, cin).permute(0, 3, 1, 2).reshape(cout, -1)
    ho, wo = (h - 1) // stride[0] + 1, (wd - 1) // stride[1] + 1
    return torch.matmul(wk.double(), cols).reshape(b, cout, ho, wo).permute(
        0, 2, 3, 1)


def _conv_input(x: torch.Tensor, inv: Optional[torch.Tensor]) -> torch.Tensor:
    """conv0's int8(u8 - 128) [B, H, W, 1] or convs 1-3's quantized x."""
    if inv is None:
        return (x.to(torch.int16) - 128).to(torch.int8).unsqueeze(-1)
    return quantize(x, inv)


def q8_conv3x3_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, stride: Tuple[int, int],
                     inv: Optional[torch.Tensor] = None,
                     corr: Optional[torch.Tensor] = None,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The function of ``q8_conv3x3`` in plain torch."""
    acc = q8_conv_acc(_conv_input(x, inv), w, stride).float()
    y = acc * scale
    if corr is not None:
        y = y + corr
    return F.silu(y + bias).to(out_dtype or x.dtype)


def q8_stem01_plain(x: torch.Tensor, w0: torch.Tensor, scale0: torch.Tensor,
                    bias0: torch.Tensor, corr: torch.Tensor, w1: torch.Tensor,
                    scale1: torch.Tensor, bias1: torch.Tensor,
                    inv1: torch.Tensor, out_dtype: torch.dtype
                    ) -> torch.Tensor:
    """The function of ``q8_stem01`` in plain torch: the two
    ``q8_conv3x3_plain`` calls."""
    h = q8_conv3x3_plain(x, w0, scale0, bias0, STRIDES[0], corr=corr,
                         out_dtype=out_dtype)
    return q8_conv3x3_plain(h, w1, scale1, bias1, STRIDES[1], inv=inv1)


def q8_linear_plain(x: torch.Tensor, inv: float, w: torch.Tensor,
                    scale: torch.Tensor, bias: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The function of ``q8_linear`` in plain torch."""
    y = q8_matmul_acc(quantize(x, inv), w).float() * scale
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


# ------------------------------------------------------------------ layouts
def pack_q8_weights(w: torch.Tensor, nc: Optional[int] = None,
                    k_align: int = 32) -> torch.Tensor:
    """int8 [N, K] weights (K-major) -> the int8 kernels' [N/nc, Kp/32, 2,
    nc/8, 8, 16]: N in chunks of ``nc`` columns (default all of N), K
    padded with zeros to ``Kp``, a multiple of ``k_align``, and N to a
    multiple of ``nc``; in a chunk, steps of 32 reduction bytes (one
    ``wgmma`` k32), so that any run of steps, a stage of a kernel's
    shared-memory ring, is one contiguous copy; in a step, the unswizzled
    K-major layout of an 8-bit ``wgmma`` B descriptor: core matrices of 8
    columns x 16 k bytes (128 contiguous bytes), ordered (k half, group of
    8 columns)."""
    n, k = w.shape
    nc = nc or n
    if w.dtype != torch.int8 or nc % 8 or k_align % 32:
        raise ValueError(f"{w.dtype} [{n}, {k}] weights do not split into "
                         f"chunks of {nc} columns of 8 x 16-byte core "
                         f"matrices")
    kp = -(-k // k_align) * k_align
    npad = -(-n // nc) * nc
    w = F.pad(w, (0, kp - k, 0, npad - n))
    w = w.reshape(npad // nc, nc // 8, 8, kp // 32, 2, 16)
    return w.permute(0, 3, 4, 1, 2, 5).contiguous()


def unpack_q8_weights(packed: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """Inverse of ``pack_q8_weights``: the [n, k] weights."""
    chunks, steps, _, groups, _, _ = packed.shape
    w = packed.permute(0, 3, 4, 1, 2, 5).reshape(chunks * groups * 8,
                                                  steps * 32)
    return w[:n, :k].contiguous()


# ------------------------------------------------------------------ kernels
def _fn(source: str, entry: str, argtypes):
    fn = getattr(build.load(source), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check(t: Optional[torch.Tensor], dtype: torch.dtype, shape: tuple,
           dev: torch.device, what: str) -> None:
    if (t is None or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or t.device != dev or not t.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous {dtype} {list(shape)} "
                         f"on {dev}")


#: (id(w), packing) -> (a weak reference to w, w's version, w packed).
_PACKS: dict = {}


def _packed(w: torch.Tensor, pack=pack_q8_weights) -> torch.Tensor:
    """``pack(w)``, made once while ``w`` lives and is not written to: an
    in-place write moves its version (an inference tensor has none, so a
    new one must be passed instead)."""
    version = None if w.is_inference() else w._version
    key = (id(w), pack)
    hit = _PACKS.get(key)
    if hit is not None and hit[0]() is w and hit[1] == version:
        return hit[2]
    packed = pack(w)
    _PACKS[key] = (weakref.ref(w, lambda _, key=key: _PACKS.pop(key, None)),
                   version, packed)
    return packed


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def q8_stem01(x: torch.Tensor, w0: torch.Tensor, scale0: torch.Tensor,
              bias0: torch.Tensor, corr: torch.Tensor, w1: torch.Tensor,
              scale1: torch.Tensor, bias1: torch.Tensor, inv1: torch.Tensor,
              out_dtype: torch.dtype) -> torch.Tensor:
    """conv1(conv0(x)) of the int8 stem, one launch of ``csrc/q8_stem.cu``
    on CUDA tensors (conv0 inside conv1's blocks), the plain version on CPU
    tensors.

    x u8 [B, H, W], taken as int8(u8 - 128); conv0: w0 int8 [48, 9], scale0
    and bias0 float32 [48], corr float32 [H, W, 48] added after the scale;
    its output is rounded to ``out_dtype`` (float32 or bfloat16) and
    quantized with inv1 float32 [48]; conv1: w1 int8 [96, 432] in (dy, dx,
    cin) order, scale1 and bias1 float32 [96]. Returns [B, Ho, Wo, 96] in
    ``out_dtype``, strides (1, 1) then (2, 2)."""
    if x.device.type == "cpu":
        return q8_stem01_plain(x, w0, scale0, bias0, corr, w1, scale1, bias1,
                               inv1, out_dtype)
    c0, c1 = MMA_CHANNELS[:2]
    if (x.device.type != "cuda" or x.dim() != 3 or x.dtype != torch.uint8
            or not x.is_contiguous() or out_dtype not in _DTYPES):
        raise ValueError("q8_stem01 takes contiguous CUDA u8 lines [B, H, W] "
                         "and a float32 or bfloat16 out_dtype")
    b, h, wd = x.shape
    dev = x.device
    _check(w0, torch.int8, (c0, 9), dev, "w0")
    _check(w1, torch.int8, (c1, 9 * c0), dev, "w1")
    _check(corr, torch.float32, (h, wd, c0), dev, "corr")
    for t, n, what in ((scale0, c0, "scale0"), (bias0, c0, "bias0"),
                       (inv1, c0, "inv1"), (scale1, c1, "scale1"),
                       (bias1, c1, "bias1")):
        _check(t, torch.float32, (n,), dev, what)
    packed1 = _packed(w1)
    ho, wo = (h - 1) // 2 + 1, (wd - 1) // 2 + 1
    out = torch.empty((b, ho, wo, c1), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    p = ctypes.c_void_p
    fn = _fn("q8_stem", "kiri_q8_stem01", [p] * 10 + [ctypes.c_int] * 4 + [p])
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), w0.data_ptr(), scale0.data_ptr(),
                 corr.data_ptr(), bias0.data_ptr(), inv1.data_ptr(),
                 packed1.data_ptr(), scale1.data_ptr(), bias1.data_ptr(),
                 out.data_ptr(), _DTYPES[out_dtype], b, h, wd, _stream(x))
    build.check(err, "q8_stem01 launch")
    q8_stem01.launches += 1
    return out


q8_stem01.launches = 0


def q8_conv3x3(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor, stride: Tuple[int, int],
               inv: Optional[torch.Tensor] = None,
               corr: Optional[torch.Tensor] = None,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """silu(int8 conv3x3 dequantized + bias) in NHWC: on CUDA tensors one
    launch of ``csrc/q8_stem.cu`` for conv2 or conv3 of the stem, on CPU
    tensors the plain version of any 3x3 conv.

    conv0 (``inv`` None, CPU only; on the card it runs inside ``q8_stem01``):
    x u8 [B, H, W], the line taken as int8(u8 - 128); ``corr`` float32
    [Ho, Wo, Cout] or None is added after the scale; ``out_dtype`` names the
    output's dtype. Other convs: x [B, H, W, Cin] float32 or bfloat16,
    quantized with ``inv`` float32 [Cin]; the output takes x's dtype. w int8
    [Cout, 9 * Cin] in (dy, dx, cin) order; scale, bias float32 [Cout].
    Returns [B, Ho, Wo, Cout]."""
    if x.device.type == "cpu":
        return q8_conv3x3_plain(x, w, scale, bias, stride, inv, corr,
                                out_dtype)
    layers = {(MMA_CHANNELS[i - 1], MMA_CHANNELS[i], STRIDES[i]): i
              for i in (2, 3)}
    cin = x.shape[-1] if x.dim() == 4 else 1
    layer = layers.get((cin, w.shape[0], tuple(stride)))
    if (x.device.type != "cuda" or x.dim() != 4 or not x.is_contiguous()
            or x.dtype not in _DTYPES or inv is None or corr is not None
            or out_dtype not in (None, x.dtype) or layer is None):
        raise ValueError(
            "on the card q8_conv3x3 runs conv2 (96 -> 160, stride (2, 2)) "
            "and conv3 (160 -> 256, stride (2, 1)) of the stem on a "
            "contiguous float32/bfloat16 [B, H, W, Cin] with inv; conv0 "
            "and conv1 run in q8_stem01")
    b, h, wd, _ = x.shape
    cout, dev = w.shape[0], x.device
    _check(w, torch.int8, (cout, 9 * cin), dev, "w")
    _check(inv, torch.float32, (cin,), dev, "inv")
    _check(scale, torch.float32, (cout,), dev, "scale")
    _check(bias, torch.float32, (cout,), dev, "bias")
    packed = _packed(w)
    sh, sw = stride
    out = torch.empty((b, (h - 1) // sh + 1, (wd - 1) // sw + 1, cout),
                      dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    p = ctypes.c_void_p
    fn = _fn("q8_stem", "kiri_q8_conv_layer",
             [ctypes.c_int] + [p] * 6 + [ctypes.c_int] * 4 + [p])
    with torch.cuda.device(dev):
        err = fn(layer, x.data_ptr(), inv.data_ptr(), packed.data_ptr(),
                 scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 _DTYPES[x.dtype], b, h, wd, _stream(x))
    build.check(err, f"q8_conv3x3 conv{layer} launch")
    q8_conv3x3.launches += 1
    return out


q8_conv3x3.launches = 0


def pack_q8_linear(w: torch.Tensor) -> torch.Tensor:
    """int8 [N, K] weights packed for ``q8_linear``'s kernel: chunks of
    ``Q8_GEMM``'s nc columns, K padded to a whole weight stage."""
    _, nc, sps, _ = Q8_GEMM
    return pack_q8_weights(w, nc, 32 * sps)


def q8_linear(x: torch.Tensor, inv: float, w: torch.Tensor,
              scale: torch.Tensor, bias: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """(quantize(x, inv) @ w^T) * scale + bias, cast to x's dtype: one launch
    of ``csrc/q8_gemm.cu`` on CUDA tensors, the plain version on CPU tensors.

    x [..., K] float32 or bfloat16 (contiguous, K a multiple of 8 on the
    card); ``inv`` the float32 reciprocal of the activation scale; w int8
    [N, K], N a multiple of 8 on the card; scale float32 [N] (weight scale
    x activation scale); bias float32 [N] or None. Returns [..., N]."""
    if x.device.type == "cpu":
        return q8_linear_plain(x, inv, w, scale, bias)
    k = x.shape[-1]
    n = w.shape[0]
    if (x.device.type != "cuda" or x.dtype not in _DTYPES
            or not x.is_contiguous() or k % 8 or n % 8):
        raise ValueError("q8_linear takes a contiguous CUDA float32/bfloat16 "
                         "[..., K] and int8 [N, K], K and N multiples of 8")
    _check(w, torch.int8, (n, k), x.device, "w")
    _check(scale, torch.float32, (n,), x.device, "scale")
    if bias is not None:
        _check(bias, torch.float32, (n,), x.device, "bias")
    packed = _packed(w, pack_q8_linear)
    out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    m = out.numel() // max(n, 1)
    if out.numel() == 0:
        return out
    p = ctypes.c_void_p
    fn = _fn("q8_gemm", "kiri_q8_gemm",
             [p, ctypes.c_float] + [p] * 4 + [ctypes.c_int] * 5 + [p])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), f32(inv), packed.data_ptr(), scale.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 _DTYPES[x.dtype], m, n, k, packed.shape[1] * 32, _stream(x))
    build.check(err, "q8_gemm launch")
    q8_linear.launches += 1
    return out


q8_linear.launches = 0
