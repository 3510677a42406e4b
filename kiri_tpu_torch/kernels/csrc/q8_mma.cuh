// The int8 tensor-core main loop shared by q8_conv.cu (convs 1-3 of the
// stem as implicit GEMMs) and q8_gemm.cu (the encoder's weight matmuls).
//
// A block computes a kBM x BN tile of C = A x B^T, A [M, K] and B [N, K] both
// int8 and K-major, into int32 accumulators with
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32. A arrives in the activations'
// dtype (float32 or bfloat16) and is quantized on its way into shared
// memory, as kiri_tpu/ops/quant8.py quantizes it (x * inv in float32, round
// half to even, clamp to +-127): each caller supplies a loader that fetches
// 8 consecutive k values of a row and the 8 reciprocals that go with them.
//
//  * 8 warps, 4 along M and 2 along N: a warp owns 32 rows and BN / 2
//    columns, 2 x BN / 16 tiles of m16n8.
//  * K goes in stages of kBK = 64 bytes through two shared-memory buffers:
//    while the warps multiply one stage, each thread holds the next stage's
//    loads in registers (4 chunks of A, BN / 32 of B, 8 k values each) and
//    stores them, quantized, into the other buffer; one __syncthreads() a
//    stage. K past its end and rows past M or N read as zeros, which adds
//    nothing to an integer sum.
//  * Rows of a buffer are kPitch = 80 bytes apart, 20 words: the 8 rows x 4
//    words of a fragment load fall in 32 different banks, so fragments are
//    read with plain 32-bit loads (m16n8k32's A and B fragments are 4
//    consecutive k bytes of one row each).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace q8 {

constexpr int kBM = 128;                 // rows a block
constexpr int kBK = 64;                  // k bytes a stage
constexpr int kPitch = kBK + 16;         // bytes between rows in shared memory
constexpr int kThreads = 256;
constexpr int kChunksPerRow = kBK / 8;   // 8 k values a chunk
constexpr int kRowsPerPass = kThreads / kChunksPerRow;   // 32

// 8 consecutive values of T as loaded: one 16-byte word for bfloat16, two
// for float32.
template <typename T>
struct Raw {
  uint4 v[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ void load8(const T* p, Raw<T>& r) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < int(sizeof(T) / 2); ++i) r.v[i] = __ldg(q + i);
}

template <typename T>
__device__ __forceinline__ void zero8(Raw<T>& r) {
#pragma unroll
  for (int i = 0; i < int(sizeof(T) / 2); ++i) r.v[i] = make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ void to_float8(const Raw<float>& r, float (&f)[8]) {
  const uint32_t w[8] = {r.v[0].x, r.v[0].y, r.v[0].z, r.v[0].w,
                         r.v[1].x, r.v[1].y, r.v[1].z, r.v[1].w};
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = __uint_as_float(w[j]);
}

__device__ __forceinline__ void to_float8(const Raw<__nv_bfloat16>& r,
                                          float (&f)[8]) {
  const uint32_t w[4] = {r.v[0].x, r.v[0].y, r.v[0].z, r.v[0].w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {   // the lower half is the lower element
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// x * inv in float32 (no contraction), rounded half to even, clamped.
__device__ __forceinline__ uint32_t quantize(float x, float inv) {
  const int q = __float2int_rn(__fmul_rn(x, inv));
  return static_cast<uint32_t>(min(max(q, -127), 127)) & 0xffu;
}

__device__ __forceinline__ uint2 quantize8(const float (&f)[8],
                                           const float (&inv)[8]) {
  uint2 out;
  out.x = quantize(f[0], inv[0]) | quantize(f[1], inv[1]) << 8 |
          quantize(f[2], inv[2]) << 16 | quantize(f[3], inv[3]) << 24;
  out.y = quantize(f[4], inv[4]) | quantize(f[5], inv[5]) << 8 |
          quantize(f[6], inv[6]) << 16 | quantize(f[7], inv[7]) << 24;
  return out;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += A[m0 : m0 + kBM] x B[n0 : n0 + BN]^T over all of K. ``a`` is the
// caller's loader: a.load(kt, raw) fills this thread's 4 chunks of stage kt
// (rows r0 + 32 i, k = kt * kBK + kc * 8, zeros where they fall outside)
// and a.quantize(raw) packs one chunk as 8 int8 values.
template <typename T, int BN, class Loader>
__device__ __forceinline__ void mainloop(Loader& a, const int8_t* __restrict__ w,
                                         int N, int K, int n0,
                                         int (&acc)[2][BN / 16][4]) {
  constexpr int NT = BN / 16;            // n8 tiles a warp
  constexpr int NB = BN / kRowsPerPass;  // B chunks a thread a stage
  static_assert(BN % 32 == 0, "BN must be a multiple of 32");
  __shared__ __align__(16) uint8_t sA[2][kBM * kPitch];
  __shared__ __align__(16) uint8_t sB[2][BN * kPitch];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * (BN / 2);
  const int kc = tid % kChunksPerRow, r0 = tid / kChunksPerRow;
  const int KT = (K + kBK - 1) / kBK;

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0;

  Raw<T> ra[4];
  uint2 rb[NB];
  auto load_b = [&](int kt) {
    const int k = kt * kBK + kc * 8;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int n = n0 + r0 + kRowsPerPass * j;
      rb[j] = (n < N && k < K)
                  ? __ldg(reinterpret_cast<const uint2*>(w + size_t(n) * K + k))
                  : make_uint2(0, 0);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint2*>(&sA[buf][(r0 + kRowsPerPass * i) * kPitch +
                                         kc * 8]) = a.quantize(ra[i]);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      *reinterpret_cast<uint2*>(&sB[buf][(r0 + kRowsPerPass * j) * kPitch +
                                         kc * 8]) = rb[j];
  };
  auto multiply = [&](int buf) {
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[2][4], bf[NT][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint8_t* p = &sA[buf][(wm + mt * 16 + g) * kPitch + ks + t * 4];
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kPitch);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kPitch + 16);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint8_t* p = &sB[buf][(wn + nt * 8 + g) * kPitch + ks + t * 4];
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
  };

  a.load(0, ra);
  load_b(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const bool more = kt + 1 < KT;
    if (more) {
      a.load(kt + 1, ra);
      load_b(kt + 1);
    }
    multiply(kt & 1);
    if (more) store((kt + 1) & 1);
    __syncthreads();
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Writes the tile: y[m, n] = op(acc, m, n) for m < M, n < N, y row-major
// [M, N]; two neighbouring columns in one store where N is even.
template <typename T, int BN, class Op>
__device__ __forceinline__ void epilogue(const int (&acc)[2][BN / 16][4],
                                         int m0, int n0, int M, int N, T* y,
                                         const Op& op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * (BN / 2);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < BN / 16; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mt * 16 + g + 8 * h;
        const int n = n0 + wn + nt * 8 + 2 * t;
        if (m >= M || n >= N) continue;
        T* out = y + size_t(m) * N + n;
        const T v0 = from_float<T>(op(acc[mt][nt][2 * h], m, n));
        if (n + 1 >= N) {
          out[0] = v0;
          continue;
        }
        const T v1 = from_float<T>(op(acc[mt][nt][2 * h + 1], m, n + 1));
        if (N % 2 == 0) {
          struct alignas(2 * sizeof(T)) Pair { T a, b; };
          *reinterpret_cast<Pair*>(out) = Pair{v0, v1};
        } else {
          out[0] = v0;
          out[1] = v1;
        }
      }
}

// SiLU as PyTorch's CUDA kernel computes it in float32: x / (1 + exp(-x)).
__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x)));
}

}  // namespace q8
