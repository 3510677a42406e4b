// One layer of the recognizer's conv stem: 3x3 SAME conv (zero padding at
// the image edge) + folded-BatchNorm bias + SiLU over NHWC activations.
//
// Replaces the TPU kernel kiri_tpu/kernels/stem.py::stem_fused_tpu (body
// _stem_kernel), which ran all four stem layers in one kernel with the
// intermediates in VMEM. Here the wrapper launches this kernel once per
// layer, with the intermediates in device memory; keeping them on chip and
// moving the products to the tensor cores (wgmma) is later work.
//
// Formulation: an implicit GEMM. Rows are output pixels (M = B*Ho*Wo),
// columns output channels (N = Cout), the reduction runs over the 3x3 taps
// and input channels (K = 9*Cin, ordered (dy, dx, cin) like the folded
// [9*Cin, Cout] weights). A 256-thread block computes a 64 x 64 output tile,
// 4 x 4 per thread, staging 16-deep slices of the gathered input (the three
// input rows and the column halo of its pixels) and of the weights in shared
// memory. Products and sums are float32 on the CUDA cores whatever the
// storage type; the bias and SiLU are applied in float32 and the result is
// rounded once to the output type.
//
// Bound on an H100: operations. The whole stem at batch 128 x 48 x 640 is
// ~243 GFLOP against ~71 MB of input and output, far above the card's
// flop-per-byte balance; this kernel runs the products at the float32 rate
// of the CUDA cores, not the bf16 tensor-core rate that bounds the work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // reduction slice
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);   // 256

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename TX, typename TW, int SH, int SW>
__global__ void __launch_bounds__(kThreads) conv3x3_silu_kernel(
    const TX* __restrict__ x, const TW* __restrict__ w,
    const float* __restrict__ bias, TX* __restrict__ y,
    int B, int H, int W, int Cin, int Ho, int Wo, int Cout) {
  __shared__ float As[BK][BM + 4];   // gathered input, k-major
  __shared__ float Bs[BK][BN];       // weights, k-major
  const int tid = threadIdx.x;
  const int M = B * Ho * Wo;
  const int K = 9 * Cin;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tm = tid / (BN / TN);
  const int tn = tid % (BN / TN);

  // The input elements this thread gathers: reduction index kk = tid % BK
  // of pixels (tid + i * kThreads) / BK, i < 4.
  constexpr int kLoads = BM * BK / kThreads;
  const int a_kk = tid % BK;
  int a_base[kLoads], a_iy[kLoads], a_ix[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int m = m0 + (tid + i * kThreads) / BK;
    if (m < M) {
      const int ox = m % Wo;
      const int t = m / Wo;
      const int oy = t % Ho;
      a_base[i] = t / Ho;          // batch index
      a_iy[i] = oy * SH - 1;
      a_ix[i] = ox * SW - 1;
    } else {
      a_base[i] = -1;
      a_iy[i] = 0;
      a_ix[i] = 0;
    }
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int k = k0 + a_kk;
    const int tap = k / Cin;
    const int ci = k - tap * Cin;
    const int dy = tap / 3;
    const int dx = tap - dy * 3;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      float v = 0.0f;
      const int iy = a_iy[i] + dy;
      const int ix = a_ix[i] + dx;
      if (a_base[i] >= 0 && k < K && iy >= 0 && iy < H && ix >= 0 && ix < W)
        v = to_f32(x[((static_cast<size_t>(a_base[i]) * H + iy) * W + ix)
                     * Cin + ci]);
      As[a_kk][(tid + i * kThreads) / BK] = v;
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      const int kk = e / BN;
      const int nn = e % BN;
      const int kb = k0 + kk;
      const int n = n0 + nn;
      Bs[kk][nn] = (kb < K && n < Cout)
          ? to_f32(w[static_cast<size_t>(kb) * Cout + n]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][tm * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tn * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn * TN + j;
      if (n >= Cout) continue;
      const float v = acc[i][j] + bias[n];
      y[static_cast<size_t>(m) * Cout + n] = from_f32<TX>(v / (1.0f + expf(-v)));
    }
  }
}

template <typename TX, typename TW, int SH, int SW>
void launch(const void* x, const void* w, const void* bias, void* y, int B,
            int H, int W, int Cin, int Cout, cudaStream_t stream) {
  const int Ho = (H - 1) / SH + 1;
  const int Wo = (W - 1) / SW + 1;
  const long long M = static_cast<long long>(B) * Ho * Wo;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((Cout + BN - 1) / BN));
  conv3x3_silu_kernel<TX, TW, SH, SW><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<const float*>(bias), static_cast<TX*>(y), B, H, W, Cin, Ho,
      Wo, Cout);
}

template <typename TX, typename TW>
bool dispatch_stride(int sh, int sw, const void* x, const void* w,
                     const void* bias, void* y, int B, int H, int W, int Cin,
                     int Cout, cudaStream_t s) {
  if (sh == 1 && sw == 1) launch<TX, TW, 1, 1>(x, w, bias, y, B, H, W, Cin, Cout, s);
  else if (sh == 2 && sw == 2) launch<TX, TW, 2, 2>(x, w, bias, y, B, H, W, Cin, Cout, s);
  else if (sh == 2 && sw == 1) launch<TX, TW, 2, 1>(x, w, bias, y, B, H, W, Cin, Cout, s);
  else return false;
  return true;
}

}  // namespace

// x: [B, H, W, Cin] NHWC, float32 (bf16 == 0) or bfloat16 (bf16 == 1);
// w: [9*Cin, Cout], float32 when w_f32 else the type of x; bias: [Cout]
// float32; y: [B, Ho, Wo, Cout] in the type of x. Strides (1,1), (2,2) and
// (2,1) are compiled. Returns cudaGetLastError() after the launch.
extern "C" int kiri_stem_conv3x3_silu(const void* x, const void* w,
                                      const void* bias, void* y, int B, int H,
                                      int W, int Cin, int Cout, int sh, int sw,
                                      int bf16, int w_f32, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok;
  if (!bf16)
    ok = dispatch_stride<float, float>(sh, sw, x, w, bias, y, B, H, W, Cin, Cout, s);
  else if (w_f32)
    ok = dispatch_stride<__nv_bfloat16, float>(sh, sw, x, w, bias, y, B, H, W, Cin, Cout, s);
  else
    ok = dispatch_stride<__nv_bfloat16, __nv_bfloat16>(sh, sw, x, w, bias, y, B, H, W, Cin, Cout, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
