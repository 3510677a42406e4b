// The int8 stem of the recognizer's int8 fast path: 3x3 convolutions,
// padding (1, 1), NHWC, int8 x int8 -> int32 sums, a float32 dequant
// epilogue, then SiLU and the cast to the compute dtype (float32 or
// bfloat16). One launch a conv.
//
// Replaces the XLA int8 convolutions of kiri_tpu/ops/quant8.py
// (Q8Encoder._forward, the conv_general_dilated calls with
// preferred_element_type=int32 at :149-153 and :167-170); there is no Pallas
// kernel for them.
//
//  * conv0 (kiri_q8_conv0): the u8 line as int8(u8 - 128), 1 input channel,
//    K = 9. Each thread computes 8 output channels of one pixel with three
//    __dp4a a channel (taps 0-3, 4-7, 8) and writes them as one 16-byte
//    (bf16) or two (float32) stores, neighbouring threads on neighbouring
//    channel groups. Epilogue (acc * scale + corr[oy, ox, n]) + bias, with
//    scale = ws / 127.5 and corr the float32 convolution of the constant
//    0.5 / 127.5 image (:154-161).
//  * convs 1-3 (kiri_q8_conv3x3): implicit GEMMs on the tensor cores
//    (q8_mma.cuh; M = output pixels, N = Cout, K = 9 * Cin in the weights'
//    (dy, dx, cin) order). The loader gathers each chunk of 8 input channels
//    of one tap of one output pixel, zeros outside the image, and quantizes
//    it with the channels' reciprocals (x * inv[c], round half to even,
//    clamp +-127; :164-166). Epilogue acc * ws + bias (:171).
//
// The epilogue multiplies and adds with __fmul_rn / __fadd_rn, so nothing
// is contracted into an FMA, and SiLU is PyTorch's float32 formula: the
// outputs are those of kernels/quant8.py::q8_conv3x3_plain bit for bit,
// given the same expf.
//
// Bound on an H100 at batch 128 x 48 x 640: bytes. conv0 writes 377 MB in
// bfloat16 (the 48-channel image at full resolution) and conv1 reads it
// back; the 83.6 G int8 MACs of convs 1-3 take ~0.085 ms at 1979 TOPS. A
// block keeps 128 output pixels x BN channels (BN = Cout for 96 and 160,
// 128 for 256), so each input pixel is read and quantized once a column
// block.
#include "q8_mma.cuh"

namespace {

using q8::kBK;
using q8::kBM;
using q8::kRowsPerPass;
using q8::kThreads;
using q8::Raw;

constexpr int kMaxC0 = 256;   // conv0's output channels, at most

template <typename T>
struct ConvLoader {
  const T* x;
  const float* inv;
  int H, W, Cin, K;
  int base[4], iy0[4], ix0[4];   // this thread's rows: b * H (-1 past M),
                                 // oy * sh - 1, ox * sw - 1
  float iv[8];

  __device__ ConvLoader(const T* x_, const float* inv_, int H_, int W_,
                        int Cin_, int sh, int sw, int Ho, int Wo, int m0,
                        int M)
      : x(x_), inv(inv_), H(H_), W(W_), Cin(Cin_), K(9 * Cin_) {
    const int r0 = threadIdx.x / q8::kChunksPerRow;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + r0 + kRowsPerPass * i;
      const int ox = m % Wo, rest = m / Wo;
      const int oy = rest % Ho, b = rest / Ho;
      base[i] = m < M ? b * H : -1;
      iy0[i] = oy * sh - 1;
      ix0[i] = ox * sw - 1;
    }
  }

  __device__ __forceinline__ void load(int kt, Raw<T> (&r)[4]) {
    const int k = kt * kBK + (threadIdx.x % q8::kChunksPerRow) * 8;
    if (k >= K) {
#pragma unroll
      for (int j = 0; j < 8; ++j) iv[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) q8::zero8(r[i]);
      return;
    }
    const int tap = k / Cin, c = k - tap * Cin;   // 8 channels of one tap
    const int dy = tap / 3, dx = tap - 3 * dy;
    const float4 i0 = __ldg(reinterpret_cast<const float4*>(inv + c));
    const float4 i1 = __ldg(reinterpret_cast<const float4*>(inv + c) + 1);
    iv[0] = i0.x; iv[1] = i0.y; iv[2] = i0.z; iv[3] = i0.w;
    iv[4] = i1.x; iv[5] = i1.y; iv[6] = i1.z; iv[7] = i1.w;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int iy = iy0[i] + dy, ix = ix0[i] + dx;
      if (base[i] >= 0 && iy >= 0 && iy < H && ix >= 0 && ix < W)
        q8::load8(x + ((size_t(base[i] + iy) * W + ix) * Cin + c), r[i]);
      else
        q8::zero8(r[i]);
    }
  }

  __device__ __forceinline__ uint2 quantize(const Raw<T>& r) const {
    float f[8];
    q8::to_float8(r, f);
    return q8::quantize8(f, iv);
  }
};

struct ConvEpilogue {
  const float* scale;
  const float* bias;
  __device__ __forceinline__ float operator()(int acc, int, int n) const {
    const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale[n]),
                              bias[n]);
    return q8::silu(y);
  }
};

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
    q8_conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ inv,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ y,
                      int B, int H, int W, int Cin, int N, int sh, int sw,
                      int Ho, int Wo) {
  const int M = B * Ho * Wo;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  ConvLoader<T> a(x, inv, H, W, Cin, sh, sw, Ho, Wo, m0, M);
  int acc[2][BN / 16][4];
  q8::mainloop<T, BN>(a, w, N, 9 * Cin, n0, acc);
  q8::epilogue<T, BN>(acc, m0, n0, M, N, y, ConvEpilogue{scale, bias});
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[8]);
template <>
__device__ __forceinline__ void store8<float>(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
template <>
__device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* p,
                                                      const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t pack4(const int* v) {
  return (uint32_t(v[0]) & 0xffu) | (uint32_t(v[1]) & 0xffu) << 8 |
         (uint32_t(v[2]) & 0xffu) << 16 | (uint32_t(v[3]) & 0xffu) << 24;
}

// One thread: 8 output channels (group ``grp``) of one output pixel.
template <typename T>
__global__ void __launch_bounds__(256)
    q8_conv0_kernel(const uint8_t* __restrict__ x,
                    const int8_t* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ corr,
                    const float* __restrict__ bias, T* __restrict__ y, int B,
                    int H, int W, int C, int sh, int sw, int Ho, int Wo) {
  __shared__ int wp[3 * kMaxC0];   // per channel: taps 0-3, 4-7, 8 packed
  for (int n = threadIdx.x; n < C; n += blockDim.x) {
    int v[12] = {0};
    for (int j = 0; j < 9; ++j) v[j] = w[n * 9 + j];
    wp[3 * n] = int(pack4(v));
    wp[3 * n + 1] = int(pack4(v + 4));
    wp[3 * n + 2] = int(pack4(v + 8));
  }
  __syncthreads();
  const int G = C / 8;
  const unsigned total = unsigned(B) * Ho * Wo * G;
  const unsigned q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= total) return;
  const unsigned pix = q / G;
  const int grp = int(q - pix * G);
  const int ox = int(pix % Wo), rest = int(pix / Wo);
  const int oy = rest % Ho, b = rest / Ho;
  int v[12] = {0};
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int iy = oy * sh - 1 + dy, ix = ox * sw - 1 + dx;
      if (iy >= 0 && iy < H && ix >= 0 && ix < W)
        v[dy * 3 + dx] = int(x[(size_t(b) * H + iy) * W + ix]) - 128;
    }
  const int x0 = int(pack4(v)), x1 = int(pack4(v + 4)), x2 = int(pack4(v + 8));
  float out[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = grp * 8 + j;
    int acc = __dp4a(x0, wp[3 * n], 0);
    acc = __dp4a(x1, wp[3 * n + 1], acc);
    acc = __dp4a(x2, wp[3 * n + 2], acc);
    float yv = __fmul_rn(__int2float_rn(acc), scale[n]);
    if (corr != nullptr)
      yv = __fadd_rn(yv, corr[(size_t(oy) * Wo + ox) * C + n]);
    out[j] = q8::silu(__fadd_rn(yv, bias[n]));
  }
  store8<T>(y + size_t(pix) * C + grp * 8, out);
}

template <typename T, int BN>
int launch_conv(const void* x, const void* inv, const void* w,
                const void* scale, const void* bias, void* y, int B, int H,
                int W, int Cin, int N, int sh, int sw, cudaStream_t s) {
  const int Ho = (H - 1) / sh + 1, Wo = (W - 1) / sw + 1;
  const dim3 grid((B * Ho * Wo + kBM - 1) / kBM, (N + BN - 1) / BN);
  q8_conv3x3_kernel<T, BN><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(inv),
      static_cast<const int8_t*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(y), B, H, W, Cin, N,
      sh, sw, Ho, Wo);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_conv_bn(const void* x, const void* inv, const void* w,
                   const void* scale, const void* bias, void* y, int B, int H,
                   int W, int Cin, int N, int sh, int sw, cudaStream_t s) {
  // A column block as wide as Cout where it fits, so the input is gathered
  // and quantized once.
  if (N == 96)
    return launch_conv<T, 96>(x, inv, w, scale, bias, y, B, H, W, Cin, N, sh,
                              sw, s);
  if (N == 160)
    return launch_conv<T, 160>(x, inv, w, scale, bias, y, B, H, W, Cin, N,
                               sh, sw, s);
  if (N % 128 == 0)
    return launch_conv<T, 128>(x, inv, w, scale, bias, y, B, H, W, Cin, N,
                               sh, sw, s);
  return launch_conv<T, 32>(x, inv, w, scale, bias, y, B, H, W, Cin, N, sh,
                            sw, s);
}

template <typename T>
int launch_conv0(const void* x, const void* w, const void* scale,
                 const void* corr, const void* bias, void* y, int B, int H,
                 int W, int C, int sh, int sw, cudaStream_t s) {
  const int Ho = (H - 1) / sh + 1, Wo = (W - 1) / sw + 1;
  const unsigned total = unsigned(B) * Ho * Wo * (C / 8);
  q8_conv0_kernel<T><<<(total + 255) / 256, 256, 0, s>>>(
      static_cast<const uint8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(corr),
      static_cast<const float*>(bias), static_cast<T*>(y), B, H, W, C, sh, sw,
      Ho, Wo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (the output's; conv0 reads u8).
// x u8 [B, H, W]; w int8 [C, 9]; scale, bias float32 [C]; corr float32
// [Ho, Wo, C] or null; y [B, Ho, Wo, C]. C a multiple of 8, at most 256.
extern "C" int kiri_q8_conv0(const void* x, const void* w, const void* scale,
                             const void* corr, const void* bias, void* y,
                             int dtype, int B, int H, int W, int C, int sh,
                             int sw, void* stream) {
  if (C % 8 != 0 || C > kMaxC0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? launch_conv0<__nv_bfloat16>(x, w, scale, corr, bias, y, B, H,
                                           W, C, sh, sw, s)
             : launch_conv0<float>(x, w, scale, corr, bias, y, B, H, W, C,
                                   sh, sw, s);
}

// x [B, H, W, Cin] in dtype; inv float32 [Cin]; w int8 [N, 9 * Cin] in
// (dy, dx, cin) order; scale, bias float32 [N]; y [B, Ho, Wo, N] in dtype.
// Cin a multiple of 8.
extern "C" int kiri_q8_conv3x3(const void* x, const void* inv, const void* w,
                               const void* scale, const void* bias, void* y,
                               int dtype, int B, int H, int W, int Cin, int N,
                               int sh, int sw, void* stream) {
  if (Cin % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? launch_conv_bn<__nv_bfloat16>(x, inv, w, scale, bias, y, B, H,
                                             W, Cin, N, sh, sw, s)
             : launch_conv_bn<float>(x, inv, w, scale, bias, y, B, H, W, Cin,
                                     N, sh, sw, s);
}
