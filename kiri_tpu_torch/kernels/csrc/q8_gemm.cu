// The encoder's int8 weight matmuls of the recognizer's int8 fast path:
// y [M, N] = dequant(quantize(x) [M, K] x w [N, K]^T), int8 x int8 -> int32
// on the tensor cores, one launch a matmul.
//
// Replaces the XLA int8 dot_general of kiri_tpu/ops/quant8.py::_dense_q8
// (:65-66, preferred_element_type=int32) together with the activation
// quantization _qa (:55-58) that feeds it; there is no Pallas kernel for
// them.
//
//  * Prologue: x in float32 or bfloat16 is quantized as it is staged in
//    shared memory (q8_mma.cuh): x * inv in float32 with inv = 1 / a_scale
//    taken in float32 by the caller, round half to even, clamp +-127.
//  * Main loop: q8_mma.cuh, 128 x 128 tiles, mma.sync.m16n8k32 s8.
//  * Epilogue: acc * scale[n] + bias[n] with scale = w_scale * a_scale
//    formed by the caller (the product first, as :67 takes it), by
//    __fmul_rn / __fadd_rn, then the cast to x's dtype: the outputs are
//    kernels/quant8.py::q8_linear_plain's bit for bit.
//
// Bound on an H100 for the encoder's shapes at M = 20,480 rows: bytes for
// all four (1.3-5.4 G int8 MACs, 1.4-5.4 us at 1979 TOPS, against 21-52 MB
// of bfloat16 activations in and out, 6-16 us at 3.35 TB/s).
#include "q8_mma.cuh"

namespace {

using q8::kBK;
using q8::kBM;
using q8::kRowsPerPass;
using q8::kThreads;
using q8::Raw;

constexpr int kBN = 128;

template <typename T>
struct GemmLoader {
  const T* x;
  float inv;
  int M, K, m0;

  __device__ __forceinline__ void load(int kt, Raw<T> (&r)[4]) const {
    const int k = kt * kBK + (threadIdx.x % q8::kChunksPerRow) * 8;
    const int r0 = threadIdx.x / q8::kChunksPerRow;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + r0 + kRowsPerPass * i;
      if (m < M && k < K)
        q8::load8(x + size_t(m) * K + k, r[i]);
      else
        q8::zero8(r[i]);
    }
  }

  __device__ __forceinline__ uint2 quantize(const Raw<T>& r) const {
    float f[8], iv[8];
    q8::to_float8(r, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) iv[j] = inv;
    return q8::quantize8(f, iv);
  }
};

struct GemmEpilogue {
  const float* scale;
  const float* bias;   // may be null
  __device__ __forceinline__ float operator()(int acc, int, int n) const {
    const float y = __fmul_rn(__int2float_rn(acc), scale[n]);
    return bias != nullptr ? __fadd_rn(y, bias[n]) : y;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    q8_gemm_kernel(const T* __restrict__ x, float inv,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ y, int M,
                   int N, int K) {
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  GemmLoader<T> a{x, inv, M, K, m0};
  int acc[2][kBN / 16][4];
  q8::mainloop<T, kBN>(a, w, N, K, n0, acc);
  q8::epilogue<T, kBN>(acc, m0, n0, M, N, y, GemmEpilogue{scale, bias});
}

template <typename T>
int launch(const void* x, float inv, const void* w, const void* scale,
           const void* bias, void* y, int M, int N, int K, cudaStream_t s) {
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  q8_gemm_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), inv, static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, of x and y. x [M, K]; w int8 [N, K]; scale
// float32 [N]; bias float32 [N] or null; y [M, N]. K a multiple of 8.
extern "C" int kiri_q8_gemm(const void* x, float inv, const void* w,
                            const void* scale, const void* bias, void* y,
                            int dtype, int M, int N, int K, void* stream) {
  if (K % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(x, inv, w, scale, bias, y, M, N,
                                            K, s)
                    : launch<float>(x, inv, w, scale, bias, y, M, N, K, s);
}
