// Line-crop preprocessing for the recognizer, several thread blocks a line.
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
// separable. A triangle has at most 2 nonzero taps and the cubic at most 4;
// the zero weights of the matrix form drop out, so the arithmetic is the
// same.
//
// Bound on an H100: memory (each valid crop byte in, 4 bytes per output
// sample out; a few FMAs per byte), so small that latency decides. What the
// design does about it:
//   * a grid of (line, tile of 12 output rows): 4 blocks a line at out_h 48,
//     512 blocks for 128 lines, which the card holds in one wave of 4-5
//     blocks per SM instead of one block on each. The tile height matters
//     little: a chain of dependent phases (sizes, sum, taps, row pass,
//     column pass), not the volume of work, sets the time;
//   * every block of a line sums the valid region itself for the invert
//     decision, with 16-byte loads and dp4a (exact, in integers). The crop
//     is at most a few tens of KB and comes from L2 after the first block;
//     a flag kernel in front would cost a second launch, which is more than
//     the repeated sum;
//   * the row pass (<= 4 taps down the source rows a tile needs, 4 source
//     bytes a load) writes a float strip [12][valid width] to shared memory;
//     the column pass (<= 4 taps along the strip, through a tap table built
//     once a block) writes float4: 8 taps an output sample, not 16;
//   * pad columns (x >= nw) are written without touching the source.
// A line whose valid width exceeds the strip (3072 columns) takes the
// direct 16-tap path inside this kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 4;
constexpr int kTileRows = 12;       // output rows a block
constexpr int kMaxStripCols = 3072; // 12 x 3072 floats = 144 KB

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

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Dynamic shared memory: strip [kTileRows][vcap] float, col_w [out_w][4]
// float, col_s [out_w] int. vcap is a multiple of 4.
__global__ void __launch_bounds__(kThreads) preprocess_lines_kernel(
    const uint8_t* __restrict__ crops, const int* __restrict__ sizes,
    float* __restrict__ out, int hmax, int wmax, int out_h, int out_w,
    int tiles, int vcap) {
  extern __shared__ __align__(16) float smem[];
  float* strip = smem;
  float* col_w = strip + kTileRows * vcap;
  int* col_s = reinterpret_cast<int*>(col_w + out_w * kTaps);
  __shared__ float row_w[kTileRows][kTaps];
  __shared__ int row_s[kTileRows];
  __shared__ unsigned long long warp_sums[kThreads / 32];
  __shared__ int invert_flag;

  const int tid = threadIdx.x;
  const int line = blockIdx.x / tiles;
  const int r0 = (blockIdx.x - line * tiles) * kTileRows;
  const int nrows = min(kTileRows, out_h - r0);
  const uint8_t* img = crops + static_cast<size_t>(line) * hmax * wmax;
  const int h = sizes[line * 3 + 0];
  const int w = sizes[line * 3 + 1];
  const bool linear = sizes[line * 3 + 2] != 0;
  const int vh = min(max(h, 0), hmax);
  const int vw = min(max(w, 0), wmax);
  const bool aligned16 =
      wmax % 16 == 0 && (reinterpret_cast<uintptr_t>(crops) & 15) == 0;
  const bool aligned4 =
      wmax % 4 == 0 && (reinterpret_cast<uintptr_t>(crops) & 3) == 0;

  // 1. Sum of the valid region, in integers (exact).
  unsigned long long acc = 0;
  if (aligned16) {
    const int chunks = (vw + 15) >> 4;
    for (int i = tid; i < vh * chunks; i += kThreads) {
      const int y = i / chunks, c = i - y * chunks;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
          img + static_cast<size_t>(y) * wmax) + c);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
      const int rem = vw - c * 16;   // valid bytes from this chunk on, >= 1
      unsigned s = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int nb = rem - 4 * k;
        uint32_t word = words[k];
        if (nb < 4) word = nb <= 0 ? 0u : word & (0xffffffffu >> (8 * (4 - nb)));
        s = __dp4a(word, 0x01010101u, s);
      }
      acc += s;
    }
  } else {
    for (int i = tid; i < vh * vw; i += kThreads) {
      const int y = i / vw;
      acc += img[static_cast<size_t>(y) * wmax + (i - y * vw)];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = acc;

  // 2. Tap tables: this tile's rows (h -> out_h), all columns (w -> nw).
  const float hf = static_cast<float>(h);
  const float wf = static_cast<float>(w);
  const float out_hf = static_cast<float>(out_h);
  const float nw = fminf(fmaxf(
      rintf(static_cast<float>(w * out_h) / fmaxf(1.0f, hf)), 1.0f),
      static_cast<float>(out_w));
  const int nwi = static_cast<int>(nw);
  const bool cubic_y = !linear && hf < out_hf;
  const bool cubic_x = !linear && wf < nw;
  if (tid < nrows)
    make_taps(r0 + tid, hf, out_hf, vh, cubic_y, &row_s[tid], row_w[tid]);
  for (int o = tid; o < nwi; o += kThreads)
    make_taps(o, wf, nw, vw, cubic_x, &col_s[o], &col_w[o * kTaps]);
  __syncthreads();
  if (tid == 0) {
    unsigned long long total = 0;
    for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
    const long long count = max(1LL, static_cast<long long>(h) * w);
    invert_flag =
        static_cast<float>(total) / static_cast<float>(count) < 127.0f;
  }
  __syncthreads();
  const bool invert = invert_flag != 0;
  const int ymax = max(vh - 1, 0);
  const int xmax = max(vw - 1, 0);
  const bool empty = vh == 0 || vw == 0;   // every weight is 0: samples are 0
  const bool use_strip = !empty && vw <= vcap;

  // 3a. Row pass: strip[r][x] = sum_t row_w[r][t] * pixel(row_s[r] + t, x).
  if (use_strip) {
    const int groups = (vw + 3) >> 2;
    for (int i = tid; i < nrows * groups; i += kThreads) {
      const int r = i / groups, x = (i - r * groups) * 4;
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        const int sy = clampi(row_s[r] + t, 0, ymax);
        const uint8_t* p = img + static_cast<size_t>(sy) * wmax + x;
        uint32_t word;
        if (aligned4) {
          word = __ldg(reinterpret_cast<const uint32_t*>(p));
        } else {
          word = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (x + j < vw) word |= static_cast<uint32_t>(p[j]) << (8 * j);
        }
        if (invert) word = ~word;
        const float wt = row_w[r][t];
        a.x += wt * static_cast<float>(word & 0xffu);
        a.y += wt * static_cast<float>((word >> 8) & 0xffu);
        a.z += wt * static_cast<float>((word >> 16) & 0xffu);
        a.w += wt * static_cast<float>(word >> 24);
      }
      *reinterpret_cast<float4*>(strip + r * vcap + x) = a;
    }
    __syncthreads();
  }

  // 3b. Column pass, clamp, pad, normalize.
  auto sample = [&](int r, int x) -> float {
    if (empty) return 0.0f;
    const int s0 = col_s[x];
    const float4 cw = *reinterpret_cast<const float4*>(col_w + x * kTaps);
    const float wts[kTaps] = {cw.x, cw.y, cw.z, cw.w};
    float sum = 0.0f;
    if (use_strip) {
      const float* row = strip + r * vcap;
#pragma unroll
      for (int t = 0; t < kTaps; ++t)
        sum += wts[t] * row[clampi(s0 + t, 0, xmax)];
    } else {
#pragma unroll
      for (int tx = 0; tx < kTaps; ++tx) {
        const int sx = clampi(s0 + tx, 0, xmax);
        float col = 0.0f;
#pragma unroll
        for (int ty = 0; ty < kTaps; ++ty) {
          const int sy = clampi(row_s[r] + ty, 0, ymax);
          float p = static_cast<float>(img[static_cast<size_t>(sy) * wmax + sx]);
          if (invert) p = 255.0f - p;
          col += row_w[r][ty] * p;
        }
        sum += wts[tx] * col;
      }
    }
    return fminf(fmaxf(sum, 0.0f), 255.0f);
  };
  float* dst = out + (static_cast<size_t>(line) * out_h + r0) * out_w;
  const float pad = normalize(128.0f);
  if (out_w % 4 == 0) {
    const int groups = out_w >> 2;
    for (int i = tid; i < nrows * groups; i += kThreads) {
      const int r = i / groups, x = (i - r * groups) * 4;
      float4 v = make_float4(pad, pad, pad, pad);
      if (x < nwi) {
        v.x = normalize(sample(r, x));
        if (x + 1 < nwi) v.y = normalize(sample(r, x + 1));
        if (x + 2 < nwi) v.z = normalize(sample(r, x + 2));
        if (x + 3 < nwi) v.w = normalize(sample(r, x + 3));
      }
      *reinterpret_cast<float4*>(dst + static_cast<size_t>(r) * out_w + x) = v;
    }
  } else {
    for (int i = tid; i < nrows * out_w; i += kThreads) {
      const int r = i / out_w, x = i - r * out_w;
      dst[i] = x < nwi ? normalize(sample(r, x)) : pad;
    }
  }
}

}  // namespace

extern "C" int kiri_preprocess_lines(const void* crops, const void* sizes,
                                     void* out, int n, int hmax, int wmax,
                                     int out_h, int out_w, void* stream) {
  const int tiles = (out_h + kTileRows - 1) / kTileRows;
  const int vcap = min((max(wmax, 1) + 3) / 4 * 4, kMaxStripCols);
  const size_t smem = static_cast<size_t>(kTileRows) * vcap * sizeof(float)
      + static_cast<size_t>(out_w) * (kTaps * sizeof(float) + sizeof(int));
  const long long blocks = static_cast<long long>(n) * tiles;
  if (blocks <= 0 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // Once per device: the kernel may take all the shared memory a block can
  // have there beside its static arrays (0: not asked yet).
  constexpr int kMaxDevices = 64;
  static std::atomic<int> optin_of[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev < 0 || dev >= kMaxDevices))
    err = cudaErrorInvalidDevice;
  int optin = err == cudaSuccess ? optin_of[dev].load() : 0;
  if (err == cudaSuccess && optin == 0) {
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaFuncAttributes attr;
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&attr, preprocess_lines_kernel);
    if (err == cudaSuccess)
      optin -= static_cast<int>(attr.sharedSizeBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(preprocess_lines_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
    if (err == cudaSuccess) optin_of[dev].store(optin);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  preprocess_lines_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(crops), static_cast<const int*>(sizes),
      static_cast<float*>(out), hmax, wmax, out_h, out_w, tiles, vcap);
  return static_cast<int>(cudaGetLastError());
}
