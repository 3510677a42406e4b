// The encoder's int8 weight matmuls of the recognizer's int8 fast path:
// y [M, N] = dequant(quantize(x) [M, K] x w [N, K]^T), int8 x int8 -> int32
// on the tensor cores, one launch a matmul.
//
// Replaces the XLA int8 dot_general of kiri_tpu/ops/quant8.py::_dense_q8
// (:65-66, preferred_element_type=int32) together with the activation
// quantization _qa (:55-58) that feeds it; there is no Pallas kernel for
// them.
//
// Bound on an H100 for the encoder's shapes at M = 20,480 rows: bytes for
// all four (1.3-5.4 G int8 MACs, 1.4-5.4 us at 1979 TOPS, against 21-52 MB
// of bfloat16 activations in and out, 6-16 us at 3.35 TB/s): the only cost
// that has to be paid is reading x once and writing y once. What the design
// does about it:
//
//  * A block owns BM = 64 rows of x across all of N (q8_tiles.h). It reads
//    and quantizes them once (x * inv in float32, inv = 1 / a_scale taken in
//    float32 by the caller, round half to even, clamp +-127) into shared
//    memory, 16 KB at K = 256 and 64 KB at K = 1024, laid out as the
//    unswizzled K-major core matrices of a wgmma descriptor: [k32 step][k
//    half][8 rows][row][16 k].
//  * It then walks N in chunks of NC = 128 columns on
//    wgmma.m64n128k32.s32.s8.s8 with A and B both read from shared memory
//    through descriptors (q8_wgmma.cuh). The weights come packed once for
//    each weight tensor (kernels/quant8.py::pack_q8_weights, [N / NC] [k32
//    step][k half][8 columns][column][16 k]) and stream through a ring of NST
//    stages of SPS steps by cp.async, one sequence over all chunks, so the
//    next chunk's weights arrive while a chunk's epilogue runs; a stage's
//    products are not waited for before the next stage's are issued. A weight
//    matrix is at most 256 KB and stays in L2.
//  * Epilogue: acc * scale[n] + bias[n] with scale = w_scale * a_scale
//    formed by the caller (the product first, as :67 takes it), by
//    __fmul_rn / __fadd_rn, then the cast to x's dtype, staged through
//    shared memory and stored 16 bytes a thread, whole rows of the chunk:
//    the outputs are kernels/quant8.py::q8_linear_plain's bit for bit.
//  * The waves: M = 20,480 gives 320 blocks of one warpgroup. At K = 256 a
//    block takes at most 65 KB (bfloat16) or 73 KB (float32) of shared
//    memory, so 3 share an SM: 396 places, one wave. At K = 1024 it takes
//    107 KB in bfloat16, 2 an SM: 264 places, 1.2 waves (115 KB in float32,
//    1 an SM). BM = 64 keeps the blocks small, so several share an SM and
//    one block's quantizing overlaps another's products; BM = 128 would
//    make 160 blocks, 1.2 waves at one an SM.
#include <atomic>

#include "q8_tiles.h"
#include "q8_wgmma.cuh"

namespace {

using q8::smem_u32;

template <int BM_, int NC_, int SPS_, int NST_>
struct GemmCfg {
  static constexpr int BM = BM_, NC = NC_, SPS = SPS_, NST = NST_;
  static constexpr int THREADS = 128;          // one warpgroup
  static constexpr int STEP_A = BM * 32;       // bytes of x a k32 step
  static constexpr int A_LBO = BM * 16;
  static constexpr int STEP_B = NC * 32;       // bytes of a chunk's weights
  static constexpr int B_LBO = NC * 16;
  static constexpr int SBO = 128;
  static constexpr int STAGE = SPS * STEP_B;
  static constexpr int KALIGN = 32 * SPS;      // K padded to this
  // Stages in flight ahead of the one multiplied: the products of a stage
  // may still run while the next is issued, so a slot is refilled two
  // stages after it was read.
  static constexpr int AHEAD = NST - 2;
  template <typename T>
  __host__ __device__ static constexpr int opitch() {
    return NC * int(sizeof(T)) + 16;
  }
  // The rows, the ring, the staging of the output, then scale and bias
  // of the np columns of the chunks.
  template <typename T>
  __host__ __device__ static constexpr int smem(int kp, int np) {
    return BM * kp + NST * STAGE + BM / 2 * opitch<T>() + 8 * np;
  }
  static_assert(BM == 64, "a block is one warpgroup of 64 rows");
  static_assert(NST >= 3, "ring");
};
using Gm = GemmCfg<KIRI_Q8_GEMM>;

template <typename T>
__global__ void __launch_bounds__(Gm::THREADS) q8_gemm_kernel(
    const T* __restrict__ x, float inv, const int8_t* __restrict__ wp,
    const float* __restrict__ scale, const float* __restrict__ bias,
    T* __restrict__ y, int M, int N, int K, int KP) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const xs = smem;
  unsigned char* const ring = smem + Gm::BM * KP;
  unsigned char* const staging = ring + Gm::NST * Gm::STAGE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * Gm::BM;
  const int spc = KP / Gm::KALIGN;              // stages a chunk
  const int np = (N + Gm::NC - 1) / Gm::NC * Gm::NC;
  const int total = np / Gm::NC * spc;
  float* const s_scale = reinterpret_cast<float*>(
      staging + Gm::BM / 2 * Gm::opitch<T>());
  float* const s_bias = s_scale + np;
  for (int i = tid; i < np; i += Gm::THREADS) {
    s_scale[i] = i < N ? scale[i] : 0.0f;
    s_bias[i] = i < N && bias != nullptr ? bias[i] : 0.0f;
  }

  auto copy_stage = [&](int g) {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(wp)
        + static_cast<size_t>(g) * Gm::STAGE;
    const uint32_t dst = smem_u32(ring + (g % Gm::NST) * Gm::STAGE);
    for (int i = tid; i < Gm::STAGE / 16; i += Gm::THREADS)
      q8::cp_async16(dst + i * 16, src + i * 16);
  };
  for (int g = 0; g < Gm::AHEAD; ++g) {
    if (g < total) copy_stage(g);
    q8::cp_async_commit();
  }

  // The block's rows, quantized, in wgmma's A layout; loads of U chunks of
  // 8 values issued before any is quantized. Rows past M and k past K are
  // zeros.
  {
    constexpr int U = 32 / int(sizeof(T));      // 32 KB in flight a block
    const int kc = KP / 8;                      // chunks a row
    const int n = Gm::BM * kc;
    float iv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) iv[j] = inv;
    for (int base = tid; base < n; base += U * Gm::THREADS) {
      q8::Raw<T> r[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * Gm::THREADS;
        const int row = i / kc, k = (i - row * kc) * 8;
        if (i < n && m0 + row < M && k < K)
          q8::load8(x + static_cast<size_t>(m0 + row) * K + k, r[u]);
        else
          q8::zero8(r[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * Gm::THREADS;
        if (i >= n) break;
        const int row = i / kc, k = (i - row * kc) * 8;
        float f[8];
        q8::to_float8(r[u], f);
        *reinterpret_cast<uint2*>(
            xs + (k >> 5) * Gm::STEP_A + ((k >> 4) & 1) * Gm::A_LBO
            + (row >> 3) * 128 + (row & 7) * 16 + (k & 15)) =
            q8::quantize8(f, iv);
      }
    }
    q8::fence_async_smem();   // for wgmma, once the barrier below has passed
  }

  const uint32_t xa = smem_u32(xs), rb = smem_u32(ring);
  unsigned char* const stage = staging + warp * 8 * Gm::opitch<T>();
  // A chunk's stages in a loop of their own, the epilogue after it: nothing
  // but wgmma touches the accumulators inside the loop, so ptxas has no
  // reason to wait for each stage's products.
  for (int c = 0; c < np / Gm::NC; ++c) {
    int acc[Gm::NC / 2];
#pragma unroll
    for (int i = 0; i < Gm::NC / 2; ++i) acc[i] = 0;
    for (int kp = 0; kp < spc; ++kp) {
      const int g = c * spc + kp;
      q8::cp_async_wait<Gm::AHEAD - 1>();   // stage g has landed
      q8::fence_async_smem();
      q8::wgmma_wait<1>();                  // stage g-2 has been read
      __syncthreads();                      // g = 0: the rows are whole
      if (g + Gm::AHEAD < total) copy_stage(g + Gm::AHEAD);   // g-2's slot
      q8::cp_async_commit();
      const uint32_t b_stage = rb + (g % Gm::NST) * Gm::STAGE;
      q8::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Gm::SPS; ++kk) {
        const int step = kp * Gm::SPS + kk;
        q8::WgmmaSS<Gm::NC>::mma(
            acc, q8::desc(xa + step * Gm::STEP_A, Gm::A_LBO, Gm::SBO),
            q8::desc(b_stage + kk * Gm::STEP_B, Gm::B_LBO, Gm::SBO));
      }
      q8::wgmma_commit();
    }
    q8::wgmma_wait<0>();   // chunk c is summed: its epilogue
    const int n0 = c * Gm::NC;
    const auto op = [&](int v, int n) {
      const float r = __fmul_rn(__int2float_rn(v), s_scale[n0 + n]);
      return bias != nullptr ? __fadd_rn(r, s_bias[n0 + n]) : r;
    };
    const auto out = [&](int r) -> T* {
      const int m = m0 + warp * 16 + r;
      return m < M ? y + static_cast<size_t>(m) * N + n0 : nullptr;
    };
    q8::store_rows<T, Gm::NC>(acc, op, stage, out, min(Gm::NC, N - n0), lane);
  }
}

constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 232448;   // a block's dynamic shared memory, at most

template <typename T>
int launch(const void* x, float inv, const void* wp, const void* scale,
           const void* bias, void* y, int M, int N, int K, int KP,
           cudaStream_t s) {
  static std::atomic<int> allowed[kMaxDevices];   // bytes allowed so far
  const int smem = Gm::smem<T>(KP, (N + Gm::NC - 1) / Gm::NC * Gm::NC);
  if (M <= 0 || N <= 0 || K <= 0 || KP < K || KP % Gm::KALIGN
      || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev < 0 || dev >= kMaxDevices))
    err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && allowed[dev].load() < smem) {
    err = cudaFuncSetAttribute(q8_gemm_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess) allowed[dev].store(smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  q8_gemm_kernel<T><<<(M + Gm::BM - 1) / Gm::BM, Gm::THREADS, smem, s>>>(
      static_cast<const T*>(x), inv, static_cast<const int8_t*>(wp),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(y), M, N, K, KP);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, of x and y. x [M, K]; wp the int8 [N, K]
// weights packed by pack_q8_weights (N padded to chunks of NC, K to KP, a
// multiple of 32 * SPS); scale float32 [N]; bias float32 [N] or null; y
// [M, N]. K and N multiples of 8.
extern "C" int kiri_q8_gemm(const void* x, float inv, const void* wp,
                            const void* scale, const void* bias, void* y,
                            int dtype, int M, int N, int K, int KP,
                            void* stream) {
  if (K % 8 != 0 || N % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(x, inv, wp, scale, bias, y, M, N,
                                            K, KP, s)
                    : launch<float>(x, inv, wp, scale, bias, y, M, N, K, KP,
                                    s);
}
