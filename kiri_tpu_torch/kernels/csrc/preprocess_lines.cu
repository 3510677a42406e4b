// Line-crop preprocessing for the recognizer, one thread block per line.
//
// Replaces the TPU kernel kiri_tpu/kernels/resize.py::preprocess_lines_tpu
// (body _preprocess_kernel). For each line of a padded u8 [N, Hmax, Wmax]
// buffer with sizes (h, w, linear):
//   1. invert when the mean of the valid h x w region is < 127;
//   2. resize to out_h rows with the aspect kept, to nw = rint(w*out_h/h)
//      columns clipped to [1, out_w]: triangle weights on a downscale, Keys
//      cubic (a = -0.5) on an upscale unless the line's linear flag is set,
//      each output row/column's weights renormalized over its taps;
//   3. clamp to [0, 255], pad columns >= nw with 128, normalize to [-1, 1].
//
// The TPU kernel resampled as two matmuls against dense interpolation
// matrices, a workaround for Mosaic; here the resampling is direct and
// separable. A triangle has at most 2 nonzero taps and the cubic at most 4,
// so every output sample reads a 4 x 4 window through per-row and
// per-column tap tables kept in shared memory; the zero weights of the
// matrix form drop out, so the arithmetic is the same.
//
// Bound on an H100: memory. It reads each valid crop byte (twice: once for
// the mean, once through L1/L2 for the resample) and writes 4 bytes per
// output sample; the tap arithmetic is a few FMAs per byte.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTaps = 4;

__device__ __forceinline__ float resample_weight(float d, bool cubic) {
  if (cubic) {
    const float a = -0.5f;
    if (d <= 1.0f) return ((a + 2.0f) * d - (a + 3.0f)) * d * d + 1.0f;
    if (d < 2.0f) return a * (((d - 5.0f) * d + 8.0f) * d - 4.0f);
    return 0.0f;
  }
  return fmaxf(0.0f, 1.0f - d);
}

// Taps of output sample o when resampling src_len -> out_len source samples
// with the (o + 0.5) * scale - 0.5 convention; only the first `valid`
// source samples exist. Writes the first tap's index and 4 weights.
__device__ void make_taps(int o, float src_len, float out_len, int valid,
                          bool cubic, int* start, float* w) {
  const float scale = src_len / out_len;
  float pos = (static_cast<float>(o) + 0.5f) * scale - 0.5f;
  pos = fminf(fmaxf(pos, 0.0f), src_len - 1.0f);
  const int s0 = static_cast<int>(floorf(pos)) - 1;
  float sum = 0.0f;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const int s = s0 + t;
    const float wt = (s >= 0 && s < valid)
        ? resample_weight(fabsf(static_cast<float>(s) - pos), cubic) : 0.0f;
    w[t] = wt;
    sum += wt;
  }
  const float norm = fabsf(sum) < 1e-6f ? 1.0f : sum;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) w[t] /= norm;
  *start = s0;
}

__device__ __forceinline__ float normalize(float v) {
  return (v / 255.0f - 0.5f) / 0.5f;
}

__global__ void __launch_bounds__(kThreads) preprocess_lines_kernel(
    const uint8_t* __restrict__ crops, const int* __restrict__ sizes,
    float* __restrict__ out, int hmax, int wmax, int out_h, int out_w) {
  extern __shared__ float smem[];
  float* row_w = smem;                                   // [out_h][kTaps]
  float* col_w = row_w + out_h * kTaps;                  // [out_w][kTaps]
  int* row_s = reinterpret_cast<int*>(col_w + out_w * kTaps);  // [out_h]
  int* col_s = row_s + out_h;                            // [out_w]
  __shared__ unsigned long long warp_sums[kThreads / 32];
  __shared__ int invert;

  const int line = blockIdx.x;
  const uint8_t* img = crops + static_cast<size_t>(line) * hmax * wmax;
  const int h = sizes[line * 3 + 0];
  const int w = sizes[line * 3 + 1];
  const bool linear = sizes[line * 3 + 2] != 0;
  const int vh = min(max(h, 0), hmax);
  const int vw = min(max(w, 0), wmax);

  // 1. Sum of the valid region, in integers (exact).
  unsigned long long acc = 0;
  for (int i = threadIdx.x; i < vh * vw; i += blockDim.x) {
    const int y = i / vw;
    acc += img[static_cast<size_t>(y) * wmax + (i - y * vw)];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;

  // 2. Tap tables for rows (h -> out_h) and columns (w -> nw).
  const float hf = static_cast<float>(h);
  const float wf = static_cast<float>(w);
  const float out_hf = static_cast<float>(out_h);
  const float nw = fminf(fmaxf(
      rintf(static_cast<float>(w * out_h) / fmaxf(1.0f, hf)), 1.0f),
      static_cast<float>(out_w));
  const bool cubic_y = !linear && hf < out_hf;
  const bool cubic_x = !linear && wf < nw;
  for (int o = threadIdx.x; o < out_h; o += blockDim.x)
    make_taps(o, hf, out_hf, vh, cubic_y, &row_s[o], &row_w[o * kTaps]);
  for (int o = threadIdx.x; o < out_w; o += blockDim.x)
    make_taps(o, wf, nw, vw, cubic_x, &col_s[o], &col_w[o * kTaps]);
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
    const long long count = max(1LL, static_cast<long long>(h) * w);
    invert = static_cast<float>(total) / static_cast<float>(count) < 127.0f;
  }
  __syncthreads();

  // 3. Separable resample (rows first, then columns), clamp, pad, normalize.
  const int nwi = static_cast<int>(nw);
  const int ymax = max(vh - 1, 0);
  const int xmax = max(vw - 1, 0);
  float* dst = out + static_cast<size_t>(line) * out_h * out_w;
  for (int i = threadIdx.x; i < out_h * out_w; i += blockDim.x) {
    const int y = i / out_w;
    const int x = i - y * out_w;
    float v = 128.0f;
    if (x < nwi) {
      float sum = 0.0f;
#pragma unroll
      for (int tx = 0; tx < kTaps; ++tx) {
        const int sx = min(max(col_s[x] + tx, 0), xmax);
        float col = 0.0f;
#pragma unroll
        for (int ty = 0; ty < kTaps; ++ty) {
          const int sy = min(max(row_s[y] + ty, 0), ymax);
          float p = static_cast<float>(img[static_cast<size_t>(sy) * wmax + sx]);
          if (invert) p = 255.0f - p;
          col += row_w[y * kTaps + ty] * p;
        }
        sum += col_w[x * kTaps + tx] * col;
      }
      v = fminf(fmaxf(sum, 0.0f), 255.0f);
    }
    dst[i] = normalize(v);
  }
}

}  // namespace

extern "C" int kiri_preprocess_lines(const void* crops, const void* sizes,
                                     void* out, int n, int hmax, int wmax,
                                     int out_h, int out_w, void* stream) {
  const size_t smem = static_cast<size_t>(out_h + out_w)
      * (kTaps * sizeof(float) + sizeof(int));
  preprocess_lines_kernel<<<n, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(crops), static_cast<const int*>(sizes),
      static_cast<float*>(out), hmax, wmax, out_h, out_w);
  return static_cast<int>(cudaGetLastError());
}
