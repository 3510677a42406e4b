"""The int8 contractions of the recognizer's int8 fast path
(``ops/quant8.Q8Encoder``): s8 x s8 -> s32 products with a float32 dequant
epilogue, each a hand-written CUDA kernel beside its plain torch version.

* ``q8_conv3x3``: a 3x3 convolution, padding (1, 1), NHWC, then SiLU and
  the cast to the compute dtype (``csrc/q8_conv.cu``). conv0 takes the u8
  line as int8(u8 - 128) and adds the float32 correction ``corr`` of the
  +0.5 term; convs 1-3 quantize their float input per channel on the way in.
  Replaces the XLA int8 ``conv_general_dilated`` of
  ``kiri_tpu/ops/quant8.py`` (:149-153, :167-170).
* ``q8_linear``: x [..., K] quantized with one scale, times int8 weights
  [N, K], dequantized (``csrc/q8_gemm.cu``). Replaces ``_dense_q8``'s
  ``dot_general`` (:65-66) with ``_qa`` (:55-58) fused into its prologue.

Quantization is ``kiri_tpu``'s: x * inv in float32, round half to even,
clamp to +-127. The epilogues apply the float32 operations in ``kiri_tpu``'s
order, conv0 ``(acc * scale + corr) + bias``, the others ``acc * scale +
bias``, where the GEMM's scale is ``w_scale * a_scale`` formed beforehand.

The plain versions take the integer products exactly through float64: every
int8 x int8 sum here is below 127^2 * 1440 < 2^53, so an im2col matmul in
float64 is exact (float32 is not, above 2^24), and its conversion to float32
rounds as int32 -> float32 does. The wrappers take the plain version only
for CPU tensors; on a CUDA tensor they launch their kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: conv0's output channels, at most (``kMaxC0`` of ``csrc/q8_conv.cu``).
MAX_C0 = 256


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


def q8_linear_plain(x: torch.Tensor, inv: float, w: torch.Tensor,
                    scale: torch.Tensor, bias: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The function of ``q8_linear`` in plain torch."""
    y = q8_matmul_acc(quantize(x, inv), w).float() * scale
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def _fn(source: str, entry: str, argtypes):
    fn = getattr(build.load(source), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_vector(t: Optional[torch.Tensor], n: int, dev: torch.device,
                  what: str) -> None:
    if (t is None or t.dtype != torch.float32 or t.shape != (n,)
            or t.device != dev or not t.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous float32 [{n}] on {dev}")


def q8_conv3x3(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor, stride: Tuple[int, int],
               inv: Optional[torch.Tensor] = None,
               corr: Optional[torch.Tensor] = None,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """silu(int8 conv3x3 dequantized + bias) in NHWC, one launch of
    ``csrc/q8_conv.cu`` on CUDA tensors, the plain version on CPU tensors.

    conv0 (``inv`` None): x u8 [B, H, W], the line taken as int8(u8 - 128);
    ``corr`` float32 [Ho, Wo, Cout] or None is added after the scale;
    ``out_dtype`` names the output's dtype. convs 1-3: x [B, H, W, Cin]
    float32 or bfloat16, quantized with ``inv`` float32 [Cin]; the output
    takes x's dtype. w int8 [Cout, 9 * Cin] in (dy, dx, cin) order; scale,
    bias float32 [Cout]. Returns [B, Ho, Wo, Cout]."""
    if x.device.type == "cpu":
        return q8_conv3x3_plain(x, w, scale, bias, stride, inv, corr,
                                out_dtype)
    conv0 = inv is None
    out_dtype = out_dtype or x.dtype
    want = 3 if conv0 else 4
    if (x.device.type != "cuda" or x.dim() != want or not x.is_contiguous()
            or x.dtype != (torch.uint8 if conv0 else out_dtype)
            or out_dtype not in _DTYPES):
        raise ValueError("q8_conv3x3 takes a contiguous CUDA u8 [B, H, W] "
                         "(conv0) or float32/bfloat16 [B, H, W, Cin] in the "
                         "output dtype")
    b, h, wd = x.shape[:3]
    cin = 1 if conv0 else x.shape[3]
    cout = w.shape[0]
    sh, sw = stride
    ho, wo = (h - 1) // sh + 1, (wd - 1) // sw + 1
    if (w.dtype != torch.int8 or w.shape != (cout, 9 * cin)
            or w.device != x.device or not w.is_contiguous()):
        raise ValueError(f"w must be a contiguous int8 [Cout, {9 * cin}] on "
                         f"{x.device}")
    if conv0 and (cout % 8 or cout > MAX_C0):
        raise ValueError(f"conv0 takes a multiple of 8 channels up to "
                         f"{MAX_C0}, not {cout}")
    if not conv0 and cin % 8:
        raise ValueError(f"the int8 conv takes a multiple of 8 input "
                         f"channels, not {cin}")
    _check_vector(scale, cout, x.device, "scale")
    _check_vector(bias, cout, x.device, "bias")
    if not conv0:
        _check_vector(inv, cin, x.device, "inv")
    if corr is not None and (conv0 is False or corr.dtype != torch.float32
                             or corr.shape != (ho, wo, cout)
                             or corr.device != x.device
                             or not corr.is_contiguous()):
        raise ValueError(f"corr is conv0's contiguous float32 [{ho}, {wo}, "
                         f"{cout}] on {x.device}")
    out = torch.empty((b, ho, wo, cout), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    p = ctypes.c_void_p
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if conv0:
            fn = _fn("q8_conv", "kiri_q8_conv0",
                     [p] * 6 + [ctypes.c_int] * 7 + [p])
            err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                     None if corr is None else corr.data_ptr(),
                     bias.data_ptr(), out.data_ptr(), _DTYPES[out_dtype], b,
                     h, wd, cout, sh, sw, stream)
        else:
            fn = _fn("q8_conv", "kiri_q8_conv3x3",
                     [p] * 6 + [ctypes.c_int] * 8 + [p])
            err = fn(x.data_ptr(), inv.data_ptr(), w.data_ptr(),
                     scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
                     _DTYPES[out_dtype], b, h, wd, cin, cout, sh, sw, stream)
    build.check(err, "q8_conv launch")
    q8_conv3x3.launches += 1
    return out


q8_conv3x3.launches = 0


def q8_linear(x: torch.Tensor, inv: float, w: torch.Tensor,
              scale: torch.Tensor, bias: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """(quantize(x, inv) @ w^T) * scale + bias, cast to x's dtype: one launch
    of ``csrc/q8_gemm.cu`` on CUDA tensors, the plain version on CPU tensors.

    x [..., K] float32 or bfloat16 (contiguous, K a multiple of 8 on the
    card); ``inv`` the float32 reciprocal of the activation scale; w int8
    [N, K]; scale float32 [N] (weight scale x activation scale); bias float32
    [N] or None. Returns [..., N]."""
    if x.device.type == "cpu":
        return q8_linear_plain(x, inv, w, scale, bias)
    k = x.shape[-1]
    n = w.shape[0]
    if (x.device.type != "cuda" or x.dtype not in _DTYPES
            or not x.is_contiguous() or k % 8):
        raise ValueError("q8_linear takes a contiguous CUDA float32/bfloat16 "
                         "[..., K] with K a multiple of 8")
    if (w.dtype != torch.int8 or w.shape != (n, k) or w.device != x.device
            or not w.is_contiguous()):
        raise ValueError(f"w must be a contiguous int8 [N, {k}] on "
                         f"{x.device}")
    _check_vector(scale, n, x.device, "scale")
    if bias is not None:
        _check_vector(bias, n, x.device, "bias")
    out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    m = out.numel() // max(n, 1)
    if out.numel() == 0:
        return out
    p = ctypes.c_void_p
    fn = _fn("q8_gemm", "kiri_q8_gemm",
             [p, ctypes.c_float] + [p] * 4 + [ctypes.c_int] * 4 + [p])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), f32(inv), w.data_ptr(), scale.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 _DTYPES[x.dtype], m, n, k,
                 torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "q8_gemm launch")
    q8_linear.launches += 1
    return out


q8_linear.launches = 0
