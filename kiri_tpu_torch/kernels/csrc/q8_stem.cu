// The int8 stem of the recognizer's int8 fast path: four 3x3 convolutions,
// padding (1, 1), NHWC, int8 x int8 -> int32 sums, a float32 dequant
// epilogue, SiLU and the cast to the compute dtype (float32 or bfloat16), in
// three launches: conv0 + conv1, conv2, conv3.
//
// Replaces the XLA int8 convolutions of kiri_tpu/ops/quant8.py
// (Q8Encoder._forward, the conv_general_dilated calls with
// preferred_element_type=int32 at :149-153 and :167-170); there is no Pallas
// kernel for them.
//
// Bound on an H100 at batch 128 x 48 x 640: by the roofline, bytes (conv1's
// and conv2's bf16 outputs, 189 and 79 MB, are written and read back once
// each; the 83.6 G int8 MACs of convs 1-3 take ~0.085 ms at 1979 TOPS). In
// practice the CUDA cores bound it: the epilogues must give PyTorch's bits
// (a dequant, expf and an IEEE division for SiLU, the rounding to the
// compute dtype, for conv0 also conv1's quantization), ~35 instructions for
// each of conv0's 207 M outputs (patch halos included) and ~30 for each of
// convs 1-3's 165 M, ~0.3 ms at the SMs' full issue rate. What the design
// does about it:
//
//  * Each of convs 1-3 is an implicit GEMM (M = output pixels, N = Cout,
//    K = 9 * Cin in the weights' (dy, dx, cin) order) on
//    wgmma.m64nNk32.s32.s8.s8 (q8_wgmma.cuh): a warpgroup owns 64 output
//    pixels and all N = Cout channels.
//  * A block owns a TH x TW rectangle of output pixels of one image
//    (q8_tiles.h). It stages the input patch that rectangle needs (with the
//    1-pixel halo, all Cin channels) in shared memory once, already
//    quantized to int8 (x * inv[c], round half to even, clamp +-127), zeros
//    outside the image: each input value is read from device memory and
//    quantized once a block, not once a tap.
//  * A goes through registers: each warp reads its 16 pixels of a k32 step
//    with one ldmatrix .x4 whose lanes 0-15 point at the step's first 16
//    channels and lanes 16-31 at its second 16, each at its tap's shifted
//    address. A descriptor cannot take A: the stride-2 pixel step makes a
//    tap's rows no dense core-matrix tile. The per-lane addresses also let a
//    step span two taps, which conv1 needs: its 48 channels are 3 chunks of
//    16 a tap, K = 432 = 27 chunks, padded with one chunk of zero weights to
//    14 steps (the padded half reads the last real chunk; x 0 adds nothing).
//    For a column stride of 2 the patch keeps even and odd columns in
//    separate planes, so the 8 rows of an ldmatrix phase are consecutive
//    pixels; a pixel's pitch is an odd number of 16-byte units (48, 112, 176
//    bytes), so those 8 rows fall in 8 different bank groups.
//  * B, the weights, is read by wgmma straight from shared memory through a
//    descriptor, packed once for each weight tensor (kernels/
//    quant8.py::pack_q8_weights) as 8 x 16-byte core matrices, [k32 step] [k
//    half][8 channels][channel][16 k]. conv2's and conv3's weights (138 and
//    369 KB) stream through a ring of NST stages of SPS steps, cp.async of
//    stage s+NST-1 overlapping the products of stage s; within a stage each
//    step's products run while the next step's A is loaded (ABUF).
//  * conv0 + conv1 is one persistent block an SM (q8_stem01_kernel): its 8
//    MMA warps multiply tile i (conv1's 43 KB of weights stay in shared
//    memory) while its other 12 warps compute conv0 of tile i+1 on the CUDA
//    cores (__dp4a, K = 9) straight into the other int8 patch; the MMA warps
//    then compute the patch's last rows (Fused::MMA_ROWS), so both parts
//    carry about the same load. conv0's output (377 MB in bfloat16 at batch
//    128) never exists in device memory.
//    conv0's epilogue is (acc * scale + corr[y, x, c]) + bias, SiLU, the
//    rounding to the compute dtype, then conv1's quantization; corr (the
//    float32 convolution of the +0.5 term, [H, W, 48], 5.9 MB at 48 x 640)
//    is read from L2. Patch positions outside the image are zeros, which is
//    conv1's padding, not conv0 of the padding.
//  * SiLU's IEEE division is written out without CUDA's per-division branch
//    (q8::silu), so the compiler interleaves an epilogue's values; the
//    epilogues go through shared memory (q8::store_rows): a thread holds 2
//    channels of a pixel here, 2 there, and device memory wants whole
//    pixels, 16 bytes a thread.
//
// The outputs are kernels/quant8.py::q8_stem01_plain's and
// q8_conv3x3_plain's bit for bit (exact sums, no FMA in the epilogues,
// PyTorch's SiLU).
#include <atomic>

#include "q8_tiles.h"
#include "q8_wgmma.cuh"

namespace {

using q8::smem_u32;

constexpr int kC0 = 48;   // conv0's output channels

// One layer's tiling. A block of WGS warpgroups owns TH x TW = 64*WGS output
// pixels of one image (warpgroup w the 64 pixels from 64*w on, in row-major
// order of the rectangle) and all COUT channels.
template <int CIN_, int COUT_, int SH_, int SW_, int TH_, int TW_, int NST_,
          int SPS_, int MINB_>
struct Cfg {
  static constexpr int CIN = CIN_, COUT = COUT_, SH = SH_, SW = SW_;
  static constexpr int TH = TH_, TW = TW_, NST = NST_, SPS = SPS_;
  static constexpr int MINB = MINB_;
  static constexpr int M = TH * TW, WGS = M / 64, NT = COUT / 8;
  static constexpr int THREADS = 128 * WGS;
  static constexpr int PH = (TH - 1) * SH + 3;       // patch rows
  static constexpr int PW = (TW - 1) * SW + 3;       // patch columns
  static constexpr int PWP = (PW + SW - 1) / SW;     // columns a parity plane
  static constexpr int CPT = CIN / 16;               // 16-byte chunks a tap
  static constexpr int PITCH = CIN + (CPT % 2 ? 0 : 16);   // bytes a pixel
  static constexpr int PATCH_BYTES = (PH * SW * PWP * PITCH + 127) / 128 * 128;
  static constexpr int STEPS = (9 * CPT + 1) / 2;    // k32 steps
  static constexpr int STEP_BYTES = 32 * COUT;
  static constexpr int LBO = 16 * COUT, SBO = 128;
  static constexpr int STAGE_BYTES = SPS * STEP_BYTES;
  static constexpr int STAGES = SPS > 0 ? STEPS / SPS : 0;
  static constexpr int RING_BYTES = NST * STAGE_BYTES;
  template <typename T>
  __host__ __device__ static constexpr int opitch() {
    return COUT * int(sizeof(T)) + 16;               // bytes a staged pixel
  }
  // Patch and ring, which stage the output (8 rows a warp) once they have
  // been read.
  template <typename T>
  __host__ __device__ static constexpr int smem() {
    return PATCH_BYTES + RING_BYTES > M / 2 * opitch<T>()
        ? PATCH_BYTES + RING_BYTES : M / 2 * opitch<T>();
  }
  static_assert(M % 64 == 0 && TW % 8 == 0, "pixel tile");
  static_assert(CIN % 16 == 0 && COUT % 16 == 0, "channels");
  static_assert((PITCH / 16) % 2 == 1,
                "odd pitch in 16-byte units: ldmatrix rows hit all banks");
  static_assert(SPS == 0 || (STEPS % SPS == 0 && NST >= 2 && STAGES >= NST),
                "ring");

  // Byte offset of patch pixel (py, pc) from the start of the patch.
  __host__ __device__ static constexpr int patch_off(int py, int pc) {
    return ((py * SW + pc % SW) * PWP + pc / SW) * PITCH;
  }
  // Offset of tap (dy, dx) from tap (0, 0) for any output pixel.
  __host__ __device__ static constexpr int tap_off(int dy, int dx) {
    return ((dy * SW + dx % SW) * PWP + dx / SW) * PITCH;
  }
  // Offset from tap (0, 0) of chunk j of the reduction (tap j / CPT,
  // channels 16 * (j % CPT) on); a chunk past the last (conv1's padding,
  // zero weights) reads the last.
  __host__ __device__ static constexpr int chunk_off(int j) {
    return j >= 9 * CPT ? chunk_off(9 * CPT - 1)
        : tap_off(j / CPT / 3, j / CPT % 3) + (j % CPT) * 16;
  }
  // Tap (0, 0) of this lane's ldmatrix row: pixel m0 + lane % 16.
  __device__ static uint32_t a_pixel(uint32_t patch, int m0, int lane) {
    const int m = m0 + (lane & 15);
    const int ty = m / TW, tx = m % TW;
    return patch + (ty * SH * SW * PWP + tx) * PITCH;
  }
};

// A registers of ABUF steps: a step's products run while the next ABUF - 1
// are issued.
constexpr int ABUF = 2;

// One k32 step of a warpgroup: A (the warp's 16 pixels, chunks 2*step and
// 2*step+1 of the reduction) by ldmatrix into `a`, whose previous step's
// products have ended, B from `b` (a step of packed weights in shared
// memory).
template <class C>
__device__ __forceinline__ void conv_step(int (&acc)[C::NT * 4],
                                          uint32_t (&a)[4], uint32_t a_pix,
                                          int step, int lane, uint32_t b) {
  // Two offsets and a select: both fold to constants where step does.
  q8::ldmatrix_x4(a, a_pix + (lane < 16 ? C::chunk_off(2 * step)
                                        : C::chunk_off(2 * step + 1)));
  q8::wgmma_fence();
  q8::WgmmaRS<C::COUT>::mma(acc, a, q8::desc(b, C::LBO, C::SBO));
  q8::wgmma_commit();
  q8::wgmma_wait<ABUF - 1>();   // step-ABUF+1's A registers are free
}

// The epilogue of convs 1-3 for this warp's 16 pixels from m0 on:
// silu(acc * scale + bias) in the compute dtype, through `stage`.
template <class C, typename T>
__device__ __forceinline__ void store_tile(
    const int (&acc)[C::NT * 4], const float* scale, const float* bias,
    unsigned char* stage, T* __restrict__ y, int b, int oy0, int ox0, int Ho,
    int Wo, int m0, int lane) {
  const auto op = [&](int v, int n) {
    return q8::silu(__fadd_rn(__fmul_rn(__int2float_rn(v), scale[n]),
                              bias[n]));
  };
  const auto out = [&](int r) -> T* {
    const int m = m0 + r;
    const int oy = oy0 + m / C::TW, ox = ox0 + m % C::TW;
    return oy < Ho && ox < Wo
        ? y + ((static_cast<size_t>(b) * Ho + oy) * Wo + ox) * C::COUT
        : nullptr;
  };
  q8::store_rows<T, C::COUT>(acc, op, stage, out, C::COUT, lane);
}

// The patch of one block, quantized: thread tid's share of the PH x PW
// pixels x CIN / 8 chunks of 8 channels, loads of U chunks issued before
// any is quantized, so that a block has tens of KB in flight.
template <class C, typename T>
__device__ __forceinline__ void stage_patch(const T* __restrict__ xb, int H,
                                            int W, int iy0, int ix0,
                                            const float* inv,
                                            unsigned char* patch, int tid) {
  constexpr int CH = C::CIN / 8;
  constexpr int N = C::PH * C::PW * CH;
  constexpr int U = 32 / int(sizeof(T));   // 16 bytes x U a thread
  for (int base = tid; base < N; base += U * C::THREADS) {
    q8::Raw<T> r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * C::THREADS;
      const int pix = i / CH, ch = i - pix * CH;
      const int py = pix / C::PW, pc = pix - py * C::PW;
      const int iy = iy0 + py, ix = ix0 + pc;
      if (i < N && iy >= 0 && iy < H && ix >= 0 && ix < W)
        q8::load8(xb + (static_cast<size_t>(iy) * W + ix) * C::CIN + ch * 8,
                  r[u]);
      else
        q8::zero8(r[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * C::THREADS;
      if (i >= N) break;
      const int pix = i / CH, ch = i - pix * CH;
      const int py = pix / C::PW, pc = pix - py * C::PW;
      float f[8];
      q8::to_float8(r[u], f);
      *reinterpret_cast<uint2*>(patch + C::patch_off(py, pc) + ch * 8) =
          q8::quantize8(f, inv + ch * 8);
    }
  }
}

template <class C, typename T>
__global__ void __launch_bounds__(C::THREADS, C::MINB) q8_layer_kernel(
    const T* __restrict__ x, const float* __restrict__ inv,
    const int8_t* __restrict__ wp, const float* __restrict__ scale,
    const float* __restrict__ bias, T* __restrict__ y, int H, int W, int Ho,
    int Wo, int tiles_x, int tiles_y) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_inv[C::CIN], s_scale[C::COUT], s_bias[C::COUT];
  unsigned char* const patch = smem;
  unsigned char* const wring = smem + C::PATCH_BYTES;
  const int tid = threadIdx.x;
  int blk = blockIdx.x;
  const int tile_x = blk % tiles_x;
  blk /= tiles_x;
  const int tile_y = blk % tiles_y;
  const int b = blk / tiles_y;
  const int oy0 = tile_y * C::TH, ox0 = tile_x * C::TW;

  auto copy_stage = [&](int s) {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(wp)
        + static_cast<size_t>(s) * C::STAGE_BYTES;
    const uint32_t dst = smem_u32(wring + (s % C::NST) * C::STAGE_BYTES);
    for (int i = tid; i < C::STAGE_BYTES / 16; i += C::THREADS)
      q8::cp_async16(dst + i * 16, src + i * 16);
  };
#pragma unroll
  for (int s = 0; s < C::NST - 1; ++s) {
    copy_stage(s);
    q8::cp_async_commit();
  }
  for (int i = tid; i < C::CIN; i += C::THREADS) s_inv[i] = inv[i];
  for (int i = tid; i < C::COUT; i += C::THREADS) {
    s_scale[i] = scale[i];
    s_bias[i] = bias[i];
  }
  __syncthreads();
  stage_patch<C, T>(x + static_cast<size_t>(b) * H * W * C::CIN, H, W,
                    oy0 * C::SH - 1, ox0 * C::SW - 1, s_inv, patch, tid);

  const int warp = tid >> 5, lane = tid & 31;
  const int m0 = warp * 16;   // warp w of warpgroup g: pixels 64g + 16w ...
  const uint32_t a_pix = C::a_pixel(smem_u32(patch), m0, lane);
  const uint32_t ring = smem_u32(wring);

  int acc[C::NT * 4];
#pragma unroll
  for (int i = 0; i < C::NT * 4; ++i) acc[i] = 0;

  for (int s = 0; s < C::STAGES; ++s) {
    q8::cp_async_wait<C::NST - 2>();   // stage s has landed
    q8::fence_async_smem();
    q8::wgmma_wait<0>();               // this warpgroup has read stage s-1
    __syncthreads();                   // ... and so has every other; s = 0:
                                       // the patch is whole
    if (s + C::NST - 1 < C::STAGES) copy_stage(s + C::NST - 1);
    q8::cp_async_commit();
    const uint32_t b_stage = ring + (s % C::NST) * C::STAGE_BYTES;
    uint32_t a[ABUF][4];
#pragma unroll
    for (int kk = 0; kk < C::SPS; ++kk)
      conv_step<C>(acc, a[kk % ABUF], a_pix, s * C::SPS + kk, lane,
                   b_stage + kk * C::STEP_BYTES);
  }
  q8::wgmma_wait<0>();
  __syncthreads();   // the patch and the ring are free: they stage the output
  store_tile<C, T>(acc, s_scale, s_bias,
                   smem + m0 / 2 * C::template opitch<T>(),
                   y, b, oy0, ox0, Ho, Wo, m0, lane);
}

// conv0 + conv1 in one persistent block per SM. conv1's packed weights (14
// steps, 43 KB) stay in shared memory beside two int8 patches. Warps 0-7
// (two warpgroups) run conv1's products and epilogue on the patch of tile i
// and then compute the last MMA_ROWS rows of conv0's patch of tile i+1;
// warps 8-19 compute its first rows meanwhile; one block-wide barrier a
// tile. conv0's exact epilogue is most of the block's work, so both parts
// take a share of it: each part's load per tile is then about equal.
struct Fused {
  using G = Cfg<kC0, 96, 2, 2, KIRI_Q8_TILE_1>;   // geometry of a tile
  static constexpr int MMA_THREADS = G::THREADS;   // 256
  static constexpr int C0_THREADS = 384;
  static constexpr int C0_GROUPS = kC0 / 4;        // channel groups of 4
  static constexpr int THREADS = MMA_THREADS + C0_THREADS;
  // Threads of the MMA part that take conv0 rows: whole channel groups.
  static constexpr int MMA_C0_THREADS = MMA_THREADS / C0_GROUPS * C0_GROUPS;
  static constexpr int MMA_ROWS = 2;               // of the patch's PH rows
  static constexpr int SPLIT = G::PH - MMA_ROWS;
  static constexpr int W_BYTES = G::STEPS * G::STEP_BYTES;
  // The tile's u8 strip (conv0's input under the patch, with conv0's own
  // halo) as words: word (sy, k) holds int8(u8 - 128) of strip row sy,
  // columns 2k .. 2k+3, zeros outside the line.
  static constexpr int SROWS = G::PH + 2;
  static constexpr int PAIRS = (G::PW + 1) / 2;    // pixel pairs a patch row
  static constexpr int NW = SROWS * PAIRS;
  static constexpr int STRIP_WORDS = (NW + 31) / 32 * 32;
  template <typename T>
  __host__ __device__ static constexpr int smem() {
    return W_BYTES + 2 * G::PATCH_BYTES + G::M / 2 * G::opitch<T>()
        + 2 * STRIP_WORDS * 4;
  }
  static_assert(C0_THREADS % C0_GROUPS == 0, "conv0 threads");
  static_assert(MMA_ROWS >= 0 && SPLIT > 0, "conv0 rows");
  static_assert(G::PATCH_BYTES % 128 == 0 && W_BYTES % 128 == 0, "align");
};

// conv0's weights as dp4a words (taps 0-3, 4-7, 8) and its scale and bias,
// with conv1's reciprocals, per channel, in shared memory.
struct Conv0Params {
  int w[kC0][3];
  float scale[kC0], bias[kC0], inv[kC0];
};

__device__ __forceinline__ uint32_t strip_word(const uint8_t* __restrict__ xb,
                                               int H, int W, int sy0, int sx0,
                                               int i) {
  const int sy = i / Fused::PAIRS, k = i - sy * Fused::PAIRS;
  const int iy = sy0 + sy, ix = sx0 + 2 * k;
  uint32_t w = 0;
  if (iy >= 0 && iy < H) {
    const uint8_t* row = xb + static_cast<size_t>(iy) * W;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ix + j >= 0 && ix + j < W)   // u8 ^ 0x80 is int8(u8 - 128)
        w |= (static_cast<uint32_t>(__ldg(row + ix + j)) ^ 0x80u) << (8 * j);
  }
  return w;
}

// A conv0 sum as a float, exactly: |acc| <= 9 * 128 * 127 < 2^22, so
// 1.5 * 2^23 + acc is a float whose bits are its own plus acc.
__device__ __forceinline__ float small_int_to_float(int acc) {
  return __fsub_rn(__int_as_float(0x4B400000 + acc), 12582912.0f);
}

// conv0 of patch rows [row0, row1) of one tile by NT threads (t = index
// among them), from the tile's strip words: __dp4a sums, (acc * scale +
// corr) + bias, SiLU, the rounding to T, conv1's quantization. Thread t
// takes 4 channels (group t % 12) of pairs of neighbouring pixels (slot
// t / 12) and writes 4 bytes a pixel; the corr values of its next pair are
// fetched while it computes this one. Patch positions outside the image are
// conv1's padding: zeros.
template <typename T, int NT>
__device__ __forceinline__ void conv0_rows(
    int H, int W, int iy0, int ix0, const uint32_t* words,
    const Conv0Params& prm, const float4* __restrict__ corr,
    unsigned char* patch, int t, int row0, int row1) {
  using G = Fused::G;
  constexpr int SLOTS = NT / Fused::C0_GROUPS;
  const int cg = t % Fused::C0_GROUPS;
  int w[4][3];
  float sc[4], bi[4], iv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = cg * 4 + j;
#pragma unroll
    for (int k = 0; k < 3; ++k) w[j][k] = prm.w[c][k];
    sc[j] = prm.scale[c];
    bi[j] = prm.bias[c];
    iv[j] = prm.inv[c];
  }
  // The corr values of a pixel pair (clamped into the image).
  const auto corr_of = [&](int item, float4& c0, float4& c1) {
    const int py = item / Fused::PAIRS, pc = 2 * (item - py * Fused::PAIRS);
    const size_t row = static_cast<size_t>(min(max(iy0 + py, 0), H - 1)) * W;
    c0 = __ldg(corr + (row + min(max(ix0 + pc, 0), W - 1))
                   * Fused::C0_GROUPS + cg);
    c1 = __ldg(corr + (row + min(max(ix0 + pc + 1, 0), W - 1))
                   * Fused::C0_GROUPS + cg);
  };
  const int end = row1 * Fused::PAIRS;
  int item = row0 * Fused::PAIRS + t / Fused::C0_GROUPS;
  float4 n0 = make_float4(0.f, 0.f, 0.f, 0.f), n1 = n0;
  if (item < end) corr_of(item, n0, n1);
  for (; item < end; item += SLOTS) {
    const float ca[4] = {n0.x, n0.y, n0.z, n0.w};
    const float cb[4] = {n1.x, n1.y, n1.z, n1.w};
    if (item + SLOTS < end) corr_of(item + SLOTS, n0, n1);
    const int py = item / Fused::PAIRS, k = item - py * Fused::PAIRS;
    const int pc = 2 * k;
    const uint32_t r0 = words[py * Fused::PAIRS + k];
    const uint32_t r1 = words[(py + 1) * Fused::PAIRS + k];
    const uint32_t r2 = words[(py + 2) * Fused::PAIRS + k];
    // Taps in the weights' order: (0,0) (0,1) (0,2) (1,0) | (1,1) (1,2)
    // (2,0) (2,1) | (2,2); pixel pc reads strip columns pc.., pc+1 pc+1...
    const int xa[3] = {static_cast<int>(__byte_perm(r0, r1, 0x4210)),
                       static_cast<int>(__byte_perm(r1, r2, 0x5421)),
                       static_cast<int>(r2 >> 16)};
    const int xb[3] = {static_cast<int>(__byte_perm(r0, r1, 0x5321)),
                       static_cast<int>(__byte_perm(r1, r2, 0x6532)),
                       static_cast<int>(r2 >> 24)};
    const int iy = iy0 + py, ix = ix0 + pc;
    const bool has1 = pc + 1 < G::PW;
    const bool row_in = iy >= 0 && iy < H;
    const bool in0 = row_in && ix >= 0 && ix < W;
    const bool in1 = row_in && has1 && ix + 1 >= 0 && ix + 1 < W;
    uint32_t qa[4], qb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int sa = __dp4a(xa[0], w[j][0], 0), sb = __dp4a(xb[0], w[j][0], 0);
      sa = __dp4a(xa[1], w[j][1], sa);
      sb = __dp4a(xb[1], w[j][1], sb);
      sa = __dp4a(xa[2], w[j][2], sa);
      sb = __dp4a(xb[2], w[j][2], sb);
      const float va = q8::silu(__fadd_rn(
          __fadd_rn(__fmul_rn(small_int_to_float(sa), sc[j]), ca[j]), bi[j]));
      const float vb = q8::silu(__fadd_rn(
          __fadd_rn(__fmul_rn(small_int_to_float(sb), sc[j]), cb[j]), bi[j]));
      qa[j] = q8::qbits(q8::round_to<T>(va), iv[j]);
      qb[j] = q8::qbits(q8::round_to<T>(vb), iv[j]);
    }
    *reinterpret_cast<uint32_t*>(patch + G::patch_off(py, pc) + cg * 4) =
        in0 ? q8::pack4(qa[0], qa[1], qa[2], qa[3]) : 0u;
    if (has1)
      *reinterpret_cast<uint32_t*>(patch + G::patch_off(py, pc + 1) + cg * 4) =
          in1 ? q8::pack4(qb[0], qb[1], qb[2], qb[3]) : 0u;
  }
}

template <typename T>
__global__ void __launch_bounds__(Fused::THREADS, 1) q8_stem01_kernel(
    const uint8_t* __restrict__ x, const int8_t* __restrict__ w0,
    const float* __restrict__ scale0, const float4* __restrict__ corr,
    const float* __restrict__ bias0, const float* __restrict__ inv1,
    const int8_t* __restrict__ wp1, const float* __restrict__ scale1,
    const float* __restrict__ bias1, T* __restrict__ y, int H, int W, int Ho,
    int Wo, int tiles_x, int tiles_y, int tiles, int tiles_per_block) {
  using G = Fused::G;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_scale[G::COUT], s_bias[G::COUT];
  __shared__ Conv0Params prm;
  unsigned char* const wsm = smem;
  unsigned char* const patches = smem + Fused::W_BYTES;
  unsigned char* const staging = patches + 2 * G::PATCH_BYTES;
  uint32_t* const words = reinterpret_cast<uint32_t*>(
      staging + G::M / 2 * G::template opitch<T>());
  const int tid = threadIdx.x;
  const int first = blockIdx.x * tiles_per_block;
  const int n = min(tiles_per_block, tiles - first);
  if (n <= 0) return;

  for (int i = tid; i < Fused::W_BYTES / 16; i += Fused::THREADS)
    q8::cp_async16(smem_u32(wsm) + i * 16,
                   reinterpret_cast<const unsigned char*>(wp1) + i * 16);
  q8::cp_async_commit();
  for (int i = tid; i < G::COUT; i += Fused::THREADS) {
    s_scale[i] = scale1[i];
    s_bias[i] = bias1[i];
  }
  for (int c = tid; c < kC0; c += Fused::THREADS) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * k + j < 9)
          v |= static_cast<uint32_t>(static_cast<uint8_t>(
                   w0[c * 9 + 4 * k + j])) << (8 * j);
      prm.w[c][k] = static_cast<int>(v);
    }
    prm.scale[c] = scale0[c];
    prm.bias[c] = bias0[c];
    prm.inv[c] = inv1[c];
  }
  // Tile t of the launch -> image and output origin.
  auto decode = [&](int t, int& b, int& oy0, int& ox0) {
    const int tile_x = t % tiles_x;
    t /= tiles_x;
    b = t / tiles_y;
    oy0 = (t - b * tiles_y) * G::TH;
    ox0 = tile_x * G::TW;
  };
  const auto lines = [&](int b) { return x + static_cast<size_t>(b) * H * W; };
  // Every thread of the block, once a tile: patch it+1 is written and patch
  // it is free. The two parts arrive from their own loops.
  auto tile_barrier = [] {
    asm volatile("bar.sync 2, %0;\n" :: "n"(Fused::THREADS) : "memory");
  };
  {
    int b, oy0, ox0;
    decode(first, b, oy0, ox0);
    for (int i = tid; i < Fused::NW; i += Fused::THREADS)
      words[i] = strip_word(lines(b), H, W, oy0 * 2 - 2, ox0 * 2 - 2, i);
  }
  __syncthreads();   // the strip of the first tile and the parameters

  if (tid >= Fused::MMA_THREADS) {
    // ---- conv0 part: rows [0, SPLIT) of the patch of tile first+k (its
    // strip in words k&1), while fetching the strip of tile first+k+1.
    const int t = tid - Fused::MMA_THREADS;
    constexpr int PRE = (Fused::NW + Fused::C0_THREADS - 1) / Fused::C0_THREADS;
    for (int k = 0; k < n; ++k) {
      int b, oy0, ox0;
      decode(first + k, b, oy0, ox0);
      uint32_t pre[PRE];
      const bool has_next = k + 1 < n;
      if (has_next) {
        int nb, noy0, nox0;
        decode(first + k + 1, nb, noy0, nox0);
#pragma unroll
        for (int p = 0; p < PRE; ++p) {
          const int i = t + p * Fused::C0_THREADS;
          pre[p] = i < Fused::NW ? strip_word(lines(nb), H, W, noy0 * 2 - 2,
                                              nox0 * 2 - 2, i) : 0u;
        }
      }
      conv0_rows<T, Fused::C0_THREADS>(
          H, W, oy0 * 2 - 1, ox0 * 2 - 1,
          words + (k & 1) * Fused::STRIP_WORDS, prm, corr,
          patches + (k & 1) * G::PATCH_BYTES, t, 0, Fused::SPLIT);
      if (has_next) {
#pragma unroll
        for (int p = 0; p < PRE; ++p) {
          const int i = t + p * Fused::C0_THREADS;
          if (i < Fused::NW)
            words[((k + 1) & 1) * Fused::STRIP_WORDS + i] = pre[p];
        }
      }
      asm volatile("bar.sync 1, %0;\n" :: "n"(Fused::C0_THREADS) : "memory");
      if (k == 0) {
        q8::cp_async_wait<0>();   // this thread's share of the weights
        q8::fence_async_smem();
      }
      tile_barrier();             // conv1 of tile k may start
    }
    tile_barrier();               // ... and has ended for tile n-1
  } else {
    // ---- conv1 part: two warpgroups, 64 pixels each; then rows [SPLIT,
    // PH) of the next tile's patch.
    const int warp = tid >> 5, lane = tid & 31;
    const int m0 = warp * 16;   // this warp's 16 pixels of a tile
    const uint32_t a_base = G::a_pixel(smem_u32(patches), m0, lane);
    const uint32_t wbase = smem_u32(wsm);
    unsigned char* const stage = staging + m0 / 2 * G::template opitch<T>();
    const auto conv0_tail = [&](int k) {   // rows [SPLIT, PH) of tile k
      int b, oy0, ox0;
      decode(first + k, b, oy0, ox0);
      if (Fused::MMA_ROWS > 0 && tid < Fused::MMA_C0_THREADS)
        conv0_rows<T, Fused::MMA_C0_THREADS>(
            H, W, oy0 * 2 - 1, ox0 * 2 - 1,
            words + (k & 1) * Fused::STRIP_WORDS, prm, corr,
            patches + (k & 1) * G::PATCH_BYTES, tid, Fused::SPLIT, G::PH);
    };
    conv0_tail(0);
    q8::cp_async_wait<0>();   // this thread's share of the weights
    q8::fence_async_smem();   // ... for wgmma
    tile_barrier();           // patch 0 is written
    for (int it = 0; it < n; ++it) {
      int b, oy0, ox0;
      decode(first + it, b, oy0, ox0);
      const uint32_t a_pix = a_base + (it & 1) * G::PATCH_BYTES;
      int acc[G::NT * 4];
#pragma unroll
      for (int i = 0; i < G::NT * 4; ++i) acc[i] = 0;
      uint32_t a[ABUF][4];
#pragma unroll
      for (int step = 0; step < G::STEPS; ++step)
        conv_step<G>(acc, a[step % ABUF], a_pix, step, lane,
                     wbase + step * G::STEP_BYTES);
      q8::wgmma_wait<0>();
      store_tile<G, T>(acc, s_scale, s_bias, stage, y, b, oy0, ox0, Ho, Wo,
                       m0, lane);
      if (it + 1 < n) conv0_tail(it + 1);
      tile_barrier();      // patch it is free, patch it+1 is written
    }
  }
}

//                Cin Cout  stride  TH, TW, NST, SPS, MINB
using Conv2 = Cfg<96, 160, 2, 2, KIRI_Q8_TILE_2>;
using Conv3 = Cfg<160, 256, 2, 1, KIRI_Q8_TILE_3>;

// What a launch asks the runtime once per device and then remembers: that
// its kernel may take more than 48 KB of dynamic shared memory and, for the
// persistent kernel, the device's SM count.
constexpr int kMaxDevices = 64;

cudaError_t current_device(int* dev) {
  const cudaError_t err = cudaGetDevice(dev);
  if (err == cudaSuccess && (*dev < 0 || *dev >= kMaxDevices))
    return cudaErrorInvalidDevice;
  return err;
}

template <class C, typename T>
int launch_layer(const void* x, const void* inv, const void* wp,
                 const void* scale, const void* bias, void* y, int B, int H,
                 int W, cudaStream_t stream) {
  static std::atomic<bool> allowed[kMaxDevices];
  constexpr int SMEM = C::template smem<T>();
  const int Ho = (H - 1) / C::SH + 1, Wo = (W - 1) / C::SW + 1;
  const int tiles_x = (Wo + C::TW - 1) / C::TW;
  const int tiles_y = (Ho + C::TH - 1) / C::TH;
  const long long blocks = static_cast<long long>(B) * tiles_x * tiles_y;
  if (blocks <= 0 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err == cudaSuccess && !allowed[dev].load()) {
    err = cudaFuncSetAttribute(q8_layer_kernel<C, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err == cudaSuccess) allowed[dev].store(true);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  q8_layer_kernel<C, T><<<static_cast<unsigned>(blocks), C::THREADS, SMEM,
                          stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(inv),
      static_cast<const int8_t*>(wp), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(y), H, W, Ho, Wo,
      tiles_x, tiles_y);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_stem01(const void* x, const void* w0, const void* scale0,
                  const void* corr, const void* bias0, const void* inv1,
                  const void* wp1, const void* scale1, const void* bias1,
                  void* y, int B, int H, int W, cudaStream_t stream) {
  using G = Fused::G;
  static std::atomic<int> sms_of[kMaxDevices];   // 0: not asked yet
  constexpr int SMEM = Fused::smem<T>();
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const int tiles_x = (Wo + G::TW - 1) / G::TW;
  const int tiles_y = (Ho + G::TH - 1) / G::TH;
  const long long tiles = static_cast<long long>(B) * tiles_x * tiles_y;
  if (tiles <= 0 || tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = current_device(&dev);
  int sms = err == cudaSuccess ? sms_of[dev].load() : 0;
  if (err == cudaSuccess && sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(q8_stem01_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM);
    if (err == cudaSuccess) sms_of[dev].store(sms);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // One block per SM, each a run of consecutive tiles.
  const int per_block = static_cast<int>((tiles + sms - 1) / sms);
  const int blocks = static_cast<int>((tiles + per_block - 1) / per_block);
  q8_stem01_kernel<T><<<blocks, Fused::THREADS, SMEM, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const int8_t*>(w0),
      static_cast<const float*>(scale0), static_cast<const float4*>(corr),
      static_cast<const float*>(bias0), static_cast<const float*>(inv1),
      static_cast<const int8_t*>(wp1), static_cast<const float*>(scale1),
      static_cast<const float*>(bias1), static_cast<T*>(y), H, W, Ho, Wo,
      tiles_x, tiles_y, static_cast<int>(tiles), per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// conv0 + conv1. dtype: 0 float32, 1 bfloat16 (the output's). x u8
// [B, H, W], taken as int8(u8 - 128); w0 int8 [48, 9]; scale0, bias0
// float32 [48]; corr float32 [H, W, 48]; inv1 float32 [48], conv1's
// reciprocals; wp1 conv1's int8 [96, 432] packed by pack_q8_weights;
// scale1, bias1 float32 [96]; y [B, Ho, Wo, 96]. Returns cudaGetLastError()
// after the launch.
extern "C" int kiri_q8_stem01(const void* x, const void* w0,
                              const void* scale0, const void* corr,
                              const void* bias0, const void* inv1,
                              const void* wp1, const void* scale1,
                              const void* bias1, void* y, int dtype, int B,
                              int H, int W, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? launch_stem01<__nv_bfloat16>(x, w0, scale0, corr, bias0, inv1, wp1,
                                     scale1, bias1, y, B, H, W, s)
      : launch_stem01<float>(x, w0, scale0, corr, bias0, inv1, wp1, scale1,
                             bias1, y, B, H, W, s);
}

// conv2 (layer 2: 96 -> 160, stride (2, 2)) or conv3 (layer 3: 160 -> 256,
// stride (2, 1)). x [B, H, W, Cin] in dtype; inv float32 [Cin]; wp the int8
// [Cout, 9 * Cin] weights packed by pack_q8_weights; scale, bias float32
// [Cout]; y [B, Ho, Wo, Cout] in dtype.
extern "C" int kiri_q8_conv_layer(int layer, const void* x, const void* inv,
                                  const void* wp, const void* scale,
                                  const void* bias, void* y, int dtype, int B,
                                  int H, int W, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layer == 2)
    return dtype == 1
        ? launch_layer<Conv2, __nv_bfloat16>(x, inv, wp, scale, bias, y, B,
                                             H, W, s)
        : launch_layer<Conv2, float>(x, inv, wp, scale, bias, y, B, H, W, s);
  if (layer == 3)
    return dtype == 1
        ? launch_layer<Conv3, __nv_bfloat16>(x, inv, wp, scale, bias, y, B,
                                             H, W, s)
        : launch_layer<Conv3, float>(x, inv, wp, scale, bias, y, B, H, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
