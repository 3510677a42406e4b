// The recognizer's conv stem in float32 on the tensor cores (3xTF32): three
// launches for the four layers (3x3 SAME conv + folded-BatchNorm bias + SiLU,
// NHWC), conv0 computed inside the conv1 kernel.
//
// Replaces the TPU kernel kiri_tpu/kernels/stem.py::stem_fused_tpu (body
// _stem_kernel) for float32 inputs; csrc/stem_mma.cu is the bfloat16 route.
//
// Float32 accuracy from the TF32 tensor cores: every operand is split once
// into hi = tf32(v) and lo = tf32(v - hi), and each k-step adds three
// products to a float32 sum, the small ones first: a_lo * w_hi,
// a_hi * w_lo, a_hi * w_hi. The dropped a_lo * w_lo is ~2^-22 of a product.
// The tensor cores read only the top 19 bits of a tf32 operand (they
// truncate), so both halves are rounded explicitly, with cvt.rna (nearest,
// ties away from zero): the weights on the host (kernels/stem.py::
// split_tf32), the activations in registers as each thread loads them.
//
// Bound on an H100: operations. At batch 128 x 48 x 640 convs 1-3 are 240.1
// GFLOP, three times over at the tensor cores' 495 TFLOP/s TF32 rate (1.455
// ms), beside conv0's 3.4 GFLOP of float32 FMAs (0.051 ms on the CUDA cores)
// and 189 MB of input and output (0.056 ms). What the design does about it:
//
//  * Each layer is an implicit GEMM (M = output pixels, N = Cout, K = 9*Cin)
//    on wgmma.m64nNk8.f32.tf32.tf32: a warpgroup owns 64 output pixels and
//    NB channels (all of conv1's and conv2's, half of conv3's); bias and
//    SiLU in float32. A block of 2 or 3 warpgroups shares each weight
//    stage, so a tile of 128 or 192 pixels reads its layer's weights once.
//  * Accumulation (where it goes wrong): one accumulator carried over a
//    whole reduction drifted past the 1e-4 tolerance at the stem's output
//    scale on the card, as it would if the tensor cores rounded each
//    wgmma's float32 sum toward zero (the model this design assumes). The
//    products of each stage of the ring (6 k-steps) go into a partial sum
//    that is added to the float32 total with ordinary adds
//    (stage_products), which brings the error to float32's own. It costs
//    NB/2 more registers a thread and a wait for a stage's products before
//    the adds.
//  * Shared memory (where it is tight): values are 4 bytes, not 2, and the
//    weights come twice (hi, lo), so the bf16 kernel's tiles do not fit: its
//    conv2 patch alone would be 224 KB in float32, and conv1's weights (332
//    KB hi + lo) cannot stay resident. K is therefore ordered (chunk of CC
//    input channels, dy, dx, channel in chunk): a block stages the patch of
//    its output rectangle one chunk at a time, in two buffers (chunk c+1 is
//    copied while chunk c is multiplied), and every layer's weights stream.
//    stem_f32x3_tiles.h states each layer's tile and its budget.
//  * A through registers (a stride-2 tap is no dense tile): each warp reads
//    its 16 pixels of a tap with one ldmatrix.x4.b16 at tap-shifted
//    addresses. On 32-bit data an 8 x 8 b16 matrix is an 8 x 4 float32
//    block of which lane l gets row l/4, column l%4: the four matrices
//    (pixels 0-7 / 8-15, k 0-3 / 4-7) are the tf32 A fragment a0..a3
//    (row g, k t; row g+8, k t; row g, k t+4; row g+8, k t+4). The lane
//    splits its 4 values into hi and lo. Pixel pitch CC*4 + 16 bytes, an odd
//    number of 16-byte units, and even and odd columns in separate planes
//    for a column stride of 2, as in stem_mma.cu: the 8 rows of an ldmatrix
//    phase fall in 8 different bank groups.
//  * B, the weights, is read by wgmma straight from a ring of NST stages in
//    shared memory, one stage (a row of 3 taps of one chunk: 3 * CC rows,
//    hi and lo, NB channels) copied with cp.async NST-1 stages ahead. TF32
//    wgmma takes only K-major operands (no transpose flag): kernels/stem.py::
//    pack_tf32_weights lays a tap of a chunk out as [hi, lo][k8 step][k
//    half][8 channels][channel][4 k], 8 x 16-byte core matrices, and the
//    taps of a stage side by side: one contiguous copy.
//  * conv0 + conv1 in one persistent block per SM (stem_f32_conv01_kernel):
//    4 warps compute conv0 of the next chunk of the patch in float32 on the
//    CUDA cores while 2 warpgroups multiply the current one, so conv0's
//    output (755 MB at batch 128) never reaches device memory. Patch
//    positions outside the image are zeros, not conv0 of the padding: they
//    are conv1's SAME padding.
//  * The epilogue goes through shared memory (a buffer that has been read):
//    a thread holds 2 channels of a pixel here, 2 there, and device memory
//    gets whole runs of a pixel's channels, 16 bytes a thread.
//
// Also tight: shared-memory bandwidth, which wgmma's B reads (32 bytes per
// 1,024 TF32 FLOP) fill to half at the tensor cores' pace before the ring's
// writes and A's ldmatrix; and L2: a block reads its layer's weights (hi +
// lo) once a tile, 14-21 bytes a clock an SM at 192-128 pixels a tile.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "stem_f32x3_tiles.h"

namespace {

constexpr int kC0 = 48;   // conv0's output channels

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
// Shared-memory writes of this thread (landed cp.async) become visible to
// wgmma, which reads shared memory through the async proxy.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Descriptor of a K-major, unswizzled B tile of 8 reduction rows: core
// matrices of 128 contiguous bytes (8 channels x 4 k); lbo = bytes from the
// k 0-3 core matrix to the k 4-7 one, sbo = bytes from one group of 8
// channels to the next.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4)
      | (static_cast<uint64_t>(lbo >> 4) << 16)
      | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// D[64 x N] += A[64 x 8] * B[8 x N] in TF32 for one warpgroup: A from
// registers (the warp's 16 rows in the m16n8k8 tf32 fragment layout), B
// through a shared-memory descriptor, D in N/2 registers a thread: d[4j+e] is
// element e of the m16n8 accumulator fragment of channel group j.
template <int N> struct Wgmma;

template <> struct Wgmma<96> {
  static __device__ __forceinline__ void mma(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <> struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

template <> struct Wgmma<160> {
  static __device__ __forceinline__ void mma(float (&d)[80],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
        "{%80, %81, %82, %83}, %84, p, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

// v / (1 + exp(-v)) on the special-function unit's ex2 and rcp (flush to
// zero: 5 operations), ~2^-22 relative: a few float32 ulps.
__device__ __forceinline__ float silu(float v) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(v * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
  return v * r;
}

// v rounded to tf32 (10-bit mantissa, nearest, ties away from zero), as a
// float32 bit pattern with its 13 low bits cleared.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;
}

// This lane's A fragment of one k8 step (ldmatrix row address `addr`),
// split: hi = tf32(v), lo = tf32(v - hi).
__device__ __forceinline__ void load_split(uint32_t addr, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  uint32_t raw[4];
  ldmatrix_x4(raw, addr);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float v = __uint_as_float(raw[i]);
    hi[i] = tf32_rna(v);
    lo[i] = tf32_rna(v - __uint_as_float(hi[i]));
  }
}

// One layer's tiling. A block of WGS warpgroups owns TH x TW = 64*WGS output
// pixels of one image (warpgroup w the 64 pixels from 64*w on, in row-major
// order of the rectangle) and NB of the COUT channels (block nb: channels
// nb*NB ...); the reduction runs over CHUNKS chunks of CC input channels,
// 3 stages of the weight ring a chunk.
template <int CIN_, int COUT_, int SH_, int SW_, int TH_, int TW_, int NB_,
          int CC_, int NST_>
struct Cfg {
  static constexpr int CIN = CIN_, COUT = COUT_, SH = SH_, SW = SW_;
  static constexpr int TH = TH_, TW = TW_, NB = NB_, CC = CC_, NST = NST_;
  // Taps a stage: one row (dy) of the 3x3 kernel. Each stage ends with a
  // wait for its products (stage_products); at one tap a stage conv1 and
  // conv2 ran a fifth slower on an H100.
  static constexpr int TPS = 3;
  static constexpr int M = TH * TW, WGS = M / 64, NT = NB / 8;
  static constexpr int NBLK = COUT / NB;             // blocks a tile
  static constexpr int THREADS = 128 * WGS;
  static constexpr int PH = (TH - 1) * SH + 3;       // patch rows
  static constexpr int PW = (TW - 1) * SW + 3;       // patch columns
  static constexpr int PWP = (PW + SW - 1) / SW;     // columns a parity plane
  static constexpr int CHUNKS = CIN / CC;
  static constexpr int PITCH = CC * 4 + 16;          // bytes a patch pixel
  static constexpr int PATCH_BYTES = PH * SW * PWP * PITCH;   // one chunk
  static constexpr int KSTEPS = CC / 8;              // k8 steps a tap
  static constexpr int STEP_BYTES = 8 * NB * 4;      // a step of hi or of lo
  static constexpr int HALF_BYTES = KSTEPS * STEP_BYTES;
  static constexpr int TAP_BYTES = 2 * HALF_BYTES;   // hi, then lo
  static constexpr int STAGE_BYTES = TPS * TAP_BYTES;
  static constexpr int SPC = 9 / TPS;                // stages a chunk
  static constexpr int STAGES = SPC * CHUNKS;        // a tile's stages
  // Stages copied ahead: the slot refilled at stage s held stage s-1, whose
  // products are done (stage_products waits for them).
  static constexpr int LOOK = NST - 1;
  static constexpr int LBO = NB * 16, SBO = 128;
  static constexpr int SMEM = 2 * PATCH_BYTES + NST * STAGE_BYTES;
  // A staged output row: NB floats + 32 bytes, so that the float2 writes of
  // a half-warp (rows g, channel pairs q) hit 32 different banks.
  static constexpr int OPITCH = NB * 4 + 32;
  static constexpr int OUT_STAGE = 8 * OPITCH;       // a warp's 8 rows
  static_assert(M % 64 == 0 && TW % 8 == 0, "pixel tile");
  static_assert(COUT % NB == 0 && NB % 8 == 0, "channel blocks");
  static_assert(CIN % CC == 0 && CC % 8 == 0, "chunks of whole k8 steps");
  static_assert((PITCH / 16) % 2 == 1,
                "odd pitch in 16-byte units: ldmatrix rows hit all banks");
  static_assert(NST >= 2 && LOOK <= SPC && STAGES >= LOOK,
                "ring; chunk c+1's patch lands within chunk c's stages");
  static_assert(SMEM <= 232448, "shared memory of one block");
  static_assert(WGS * 4 * OUT_STAGE <= SMEM, "the output stages in place");

  // Byte offset of patch pixel (py, pc) from the start of a chunk buffer.
  __host__ __device__ static constexpr int patch_off(int py, int pc) {
    return ((py * SW + pc % SW) * PWP + pc / SW) * PITCH;
  }
  // Offset of tap (dy, dx) from tap (0, 0) for any output pixel.
  __host__ __device__ static constexpr int tap_off(int dy, int dx) {
    return ((dy * SW + dx % SW) * PWP + dx / SW) * PITCH;
  }
  // ldmatrix row address of this lane for the warp's 16 pixels from pixel
  // m0 of the tile on, at tap (0, 0): lane l gives pixel m0 + l%16, k 0-3
  // (l < 16) or k 4-7 of a step.
  __device__ static uint32_t a_lane(uint32_t patch, int m0, int lane) {
    const int m = m0 + (lane & 15);
    const int ty = m / TW, tx = m % TW;
    return patch + (ty * SH * SW * PWP + tx) * PITCH + (lane >> 4) * 16;
  }
};

// One stage's products for this warp's warpgroup, added to acc: taps tap0
// ... tap0+TPS-1 of the chunk whose patch starts at a_chunk (this lane's
// ldmatrix address at tap (0, 0)). Along one accumulator of K/8 * 3 wgmma
// (540 in conv3) the error grew past 1e-4 at the stem's output scale, 30
// times float32's own, as a rounding of each wgmma's sum toward zero would
// make it grow. So the stage's products go into `part`, which its
// first wgmma overwrites (scale-d 0), and part is added to acc with
// round-to-nearest float32 adds once the stage is done: a rounding toward
// zero then acts over 3 * TPS * KSTEPS wgmma only. The wait for the
// products before the adds leaves the tensor cores idle for a moment, so a
// stage holds several k-steps. Per k8 step: the lane's A values from the
// patch (32 bytes a step), split, and three wgmma, the small terms first.
template <class C>
__device__ __forceinline__ void stage_products(float (&acc)[C::NT * 4],
                                               float (&part)[C::NT * 4],
                                               uint32_t a_chunk, int tap0,
                                               uint32_t b_stage) {
  uint32_t hi[2][4], lo[2][4];
#pragma unroll
  for (int t = 0; t < C::TPS; ++t) {
    const int tap = tap0 + t;
    const uint32_t a_tap = a_chunk + C::tap_off(tap / 3, tap % 3);
    const uint32_t b_tap = b_stage + t * C::TAP_BYTES;
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk) {
      const int j = t * C::KSTEPS + kk;   // step of the stage
      load_split(a_tap + kk * 32, hi[j & 1], lo[j & 1]);
      const uint32_t b_hi = b_tap + kk * C::STEP_BYTES;
      wgmma_fence();
      Wgmma<C::NB>::mma(part, lo[j & 1], wgmma_desc(b_hi, C::LBO, C::SBO),
                        j > 0);
      Wgmma<C::NB>::mma(part, hi[j & 1],
                        wgmma_desc(b_hi + C::HALF_BYTES, C::LBO, C::SBO), 1);
      Wgmma<C::NB>::mma(part, hi[j & 1], wgmma_desc(b_hi, C::LBO, C::SBO),
                        1);
      wgmma_commit();
      wgmma_wait<1>();   // the step before is done: its A registers are free
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < C::NT * 4; ++i) acc[i] += part[i];
}

// Bias + SiLU in float32 for the warp's 16 pixels from m0 on, channels nb0
// ... nb0+NB-1. Thread (g, q) of a warp holds rows g and g+8 and channels
// 2q, 2q+1 of every group of 8 channels. Half by half (rows g, then rows
// g+8), the warp writes 8 rows to `stage` (8 rows of OPITCH bytes that
// nobody else touches) and copies them out 16 bytes a thread, whole runs of
// NB*4 contiguous bytes of a pixel at a time.
template <class C>
__device__ __forceinline__ void store_tile(
    const float (&acc)[C::NT * 4], const float* __restrict__ bias,
    unsigned char* stage, float* __restrict__ y, int b, int oy0, int ox0,
    int nb0, int Ho, int Wo, int m0, int lane) {
  const int g = lane >> 2, q = lane & 3;
  constexpr int CPP = C::NB / 4;   // 16-byte pieces a pixel
  static_assert(8 * CPP % 32 == 0, "whole warp rounds");
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    unsigned char* row = stage + g * C::OPITCH + q * 8;
#pragma unroll
    for (int j = 0; j < C::NT; ++j) {
      const int n = nb0 + j * 8 + q * 2;
      *reinterpret_cast<float2*>(row + j * 32) = make_float2(
          silu(acc[j * 4 + half * 2] + __ldg(bias + n)),
          silu(acc[j * 4 + half * 2 + 1] + __ldg(bias + n + 1)));
    }
    __syncwarp();
#pragma unroll
    for (int i = lane; i < 8 * CPP; i += 32) {
      const int r = i / CPP, c = i - r * CPP;
      const int m = m0 + half * 8 + r;
      const int oy = oy0 + m / C::TW, ox = ox0 + m % C::TW;
      if (oy < Ho && ox < Wo)
        *reinterpret_cast<uint4*>(
            y + ((static_cast<size_t>(b) * Ho + oy) * Wo + ox) * C::COUT
            + nb0 + c * 4) =
            *reinterpret_cast<const uint4*>(stage + r * C::OPITCH + c * 16);
    }
    __syncwarp();
  }
}

// Layers 2 and 3: one block a tile and channel block.
template <class C>
__global__ void __launch_bounds__(C::THREADS, 1) stem_f32_layer_kernel(
    const float* __restrict__ x, const float* __restrict__ wp,
    const float* __restrict__ bias, float* __restrict__ y, int H, int W,
    int Ho, int Wo, int tiles_x, int tiles_y) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const patches = smem;
  unsigned char* const wring = smem + 2 * C::PATCH_BYTES;
  const int tid = threadIdx.x;
  int blk = blockIdx.x;
  const int nb = blk % C::NBLK;   // the channel blocks of a tile side by side
  blk /= C::NBLK;
  const int tile_x = blk % tiles_x;
  blk /= tiles_x;
  const int tile_y = blk % tiles_y;
  const int b = blk / tiles_y;
  const int oy0 = tile_y * C::TH, ox0 = tile_x * C::TW;
  const int iy0 = oy0 * C::SH - 1, ix0 = ox0 * C::SW - 1;  // patch (0, 0)
  const float* xb = x + static_cast<size_t>(b) * H * W * C::CIN;
  const unsigned char* wb = reinterpret_cast<const unsigned char*>(wp)
      + static_cast<size_t>(nb) * C::STAGES * C::STAGE_BYTES;

  // Chunk c of the patch, straight from the NHWC input, into buffer c & 1;
  // zeros outside the image.
  auto copy_patch = [&](int c) {
    constexpr int CH = C::CC / 4;   // 16-byte pieces a pixel of a chunk
    unsigned char* buf = patches + (c & 1) * C::PATCH_BYTES;
    for (int i = tid; i < C::PH * C::PW * CH; i += C::THREADS) {
      const int pix = i / CH, ch = i - pix * CH;
      const int py = pix / C::PW, pc = pix - py * C::PW;
      const int iy = iy0 + py, ix = ix0 + pc;
      unsigned char* dst = buf + C::patch_off(py, pc) + ch * 16;
      if (iy >= 0 && iy < H && ix >= 0 && ix < W)
        cp_async16(smem_u32(dst), xb + (static_cast<size_t>(iy) * W + ix)
                                      * C::CIN + c * C::CC + ch * 4);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto copy_stage = [&](int s) {
    const unsigned char* src = wb + static_cast<size_t>(s) * C::STAGE_BYTES;
    const uint32_t dst = smem_u32(wring + (s % C::NST) * C::STAGE_BYTES);
    for (int i = tid; i < C::STAGE_BYTES / 16; i += C::THREADS)
      cp_async16(dst + i * 16, src + i * 16);
  };

  copy_patch(0);          // cp.async group 0
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < C::LOOK; ++s) {
    copy_stage(s);
    cp_async_commit();
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int m0 = warp * 16;   // warp w of warpgroup g: pixels 64g + 16w ...
  const uint32_t a_base = C::a_lane(smem_u32(patches), m0, lane);
  const uint32_t ring = smem_u32(wring);

  float acc[C::NT * 4], part[C::NT * 4];
#pragma unroll
  for (int i = 0; i < C::NT * 4; ++i) acc[i] = 0.0f;

  for (int s = 0; s < C::STAGES; ++s) {
    cp_async_wait<C::LOOK - 1>();   // stage s (and its chunk) have landed
    fence_async_smem();
    // Every warp is done with stage s-1, whose slot the copy below refills,
    // and with chunk c-1's buffer.
    __syncthreads();
    const int c = s / C::SPC, tap0 = (s - c * C::SPC) * C::TPS;
    if (tap0 == 0 && c + 1 < C::CHUNKS) copy_patch(c + 1);
    if (s + C::LOOK < C::STAGES) copy_stage(s + C::LOOK);
    cp_async_commit();
    stage_products<C>(acc, part, a_base + (c & 1) * C::PATCH_BYTES, tap0,
                      ring + (s % C::NST) * C::STAGE_BYTES);
  }
  __syncthreads();   // nobody reads shared memory any more: it stages output
  store_tile<C>(acc, bias, smem + warp * C::OUT_STAGE, y, b, oy0, ox0,
                nb * C::NB, Ho, Wo, m0, lane);
}

// conv0 + conv1 in one persistent block per SM, over "slabs": chunk c of the
// patch of tile i. Warps 0-7 (two warpgroups) run conv1's products on slab k
// while warps 8-11 compute conv0 of slab k+1 into the other chunk buffer
// (float32 FMAs and SiLU on the CUDA cores), one block-wide barrier a slab.
// The weights stream through the ring, copied by the product warps alone,
// across tile ends without a pause. 384 threads leave the product warps
// the registers of acc and part (96) beside A's.
struct Fused {
  using G = Cfg<kC0, 96, 2, 2, KIRI_STEM_F32_TILE_1>;   // geometry of a tile
  static constexpr int MMA_THREADS = G::THREADS;   // 256
  static constexpr int C0_THREADS = 128;
  static constexpr int C0_GROUPS = G::CC / 4;      // channel groups of 4
  static constexpr int C0_SLOTS = C0_THREADS / C0_GROUPS;
  static constexpr int THREADS = MMA_THREADS + C0_THREADS;
  static constexpr int STRIP_H = G::PH + 2, STRIP_W = G::PW + 2;
  static constexpr int STRIP_FLOATS = (STRIP_H * STRIP_W + 3) / 4 * 4;
  static constexpr int SMEM = G::SMEM + 2 * STRIP_FLOATS * 4;
  static_assert(G::NBLK == 1, "one block owns all of conv1's channels");
  static_assert(C0_THREADS % C0_GROUPS == 0, "conv0 threads");
  static_assert(G::WGS * 4 * G::OUT_STAGE <= G::PATCH_BYTES,
                "a chunk buffer stages the output");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// The float32 strip of the line under one tile's patch, with conv0's own
// halo: element i of [STRIP_H][STRIP_W], zero outside the line.
__device__ __forceinline__ float strip_value(const float* __restrict__ xb,
                                             int H, int W, int iy0, int ix0,
                                             int i) {
  const int sy = i / Fused::STRIP_W, sx = i - sy * Fused::STRIP_W;
  const int iy = iy0 - 1 + sy, ix = ix0 - 1 + sx;
  return (iy >= 0 && iy < H && ix >= 0 && ix < W)
      ? __ldg(xb + static_cast<size_t>(iy) * W + ix) : 0.0f;
}

// conv0 of chunk c (channels c*CC ...) of one tile's patch by the C0_THREADS
// threads of the conv0 part (t = index within it), from the tile's strip in
// shared memory: float32 FMAs, bias, SiLU. Thread t takes 4 channels (group
// t % C0_GROUPS) of pairs of neighbouring pixels (slot t / C0_GROUPS), so the
// shared-memory traffic is the strip in and 16 bytes a pixel out. Patch
// positions outside the image are conv1's SAME padding: zeros. Meanwhile the
// strip of the next tile (nxb etc., when has_next) travels from device
// memory through registers into strip_next; the barrier at the end makes it
// whole.
__device__ __forceinline__ void conv0_chunk(
    int H, int W, int iy0, int ix0, const float* strip, int c,
    const float* __restrict__ w0, const float* __restrict__ b0,
    unsigned char* patch, int t, bool has_next,
    const float* __restrict__ nxb, int niy0, int nix0, float* strip_next) {
  using G = Fused::G;
  constexpr int NSTRIP = Fused::STRIP_H * Fused::STRIP_W;
  constexpr int PRE = (NSTRIP + Fused::C0_THREADS - 1) / Fused::C0_THREADS;
  float pre[PRE];
  if (has_next) {
#pragma unroll
    for (int k = 0; k < PRE; ++k) {
      const int i = t + k * Fused::C0_THREADS;
      pre[k] = i < NSTRIP ? strip_value(nxb, H, W, niy0, nix0, i) : 0.0f;
    }
  }
  const int cg = t % Fused::C0_GROUPS;
  const int ch0 = c * G::CC + cg * 4;
  float w[9][4], bias[4];
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) w[k][j] = __ldg(w0 + k * kC0 + ch0 + j);
#pragma unroll
  for (int j = 0; j < 4; ++j) bias[j] = __ldg(b0 + ch0 + j);
  constexpr int PAIRS = (G::PW + 1) / 2;        // pixel pairs a patch row
  for (int item = t / Fused::C0_GROUPS; item < G::PH * PAIRS;
       item += Fused::C0_SLOTS) {
    const int py = item / PAIRS, pc = (item - py * PAIRS) * 2;
    const int iy = iy0 + py, ix = ix0 + pc;
    const bool row_in = iy >= 0 && iy < H;
    const bool in0 = row_in && ix >= 0 && ix < W;
    const bool in1 = row_in && pc + 1 < G::PW && ix + 1 >= 0 && ix + 1 < W;
    // No branch on in0/in1: the strip holds zeros outside the line.
    float a0[4], a1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) a0[j] = a1[j] = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const float* srow = strip + (py + dy) * Fused::STRIP_W + pc;
      const float v[4] = {srow[0], srow[1], srow[2], srow[3]};
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a0[j] = fmaf(v[dx], w[dy * 3 + dx][j], a0[j]);
          a1[j] = fmaf(v[dx + 1], w[dy * 3 + dx][j], a1[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a0[j] = in0 ? silu(a0[j] + bias[j]) : 0.0f;
      a1[j] = in1 ? silu(a1[j] + bias[j]) : 0.0f;
    }
    *reinterpret_cast<float4*>(patch + G::patch_off(py, pc) + cg * 16) =
        make_float4(a0[0], a0[1], a0[2], a0[3]);
    if (pc + 1 < G::PW)
      *reinterpret_cast<float4*>(patch + G::patch_off(py, pc + 1) + cg * 16) =
          make_float4(a1[0], a1[1], a1[2], a1[3]);
  }
  if (has_next) {
#pragma unroll
    for (int k = 0; k < PRE; ++k) {
      const int i = t + k * Fused::C0_THREADS;
      if (i < NSTRIP) strip_next[i] = pre[k];
    }
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(Fused::C0_THREADS) : "memory");
}

__global__ void __launch_bounds__(Fused::THREADS, 1) stem_f32_conv01_kernel(
    const float* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ b0, const float* __restrict__ wp,
    const float* __restrict__ bias, float* __restrict__ y, int H, int W,
    int Ho, int Wo, int tiles_x, int tiles_y, int tiles,
    int tiles_per_block) {
  using G = Fused::G;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const patches = smem;
  unsigned char* const wring = smem + 2 * G::PATCH_BYTES;
  float* const strip =
      reinterpret_cast<float*>(wring + G::NST * G::STAGE_BYTES);
  const int tid = threadIdx.x;
  const int first = blockIdx.x * tiles_per_block;
  const int n = min(tiles_per_block, tiles - first);
  if (n <= 0) return;
  const int slabs = n * G::CHUNKS;

  // Tile t of the launch -> image, output origin.
  auto decode = [&](int t, int& b, int& oy0, int& ox0) {
    const int tile_x = t % tiles_x;
    t /= tiles_x;
    b = t / tiles_y;
    oy0 = (t - b * tiles_y) * G::TH;
    ox0 = tile_x * G::TW;
  };
  // Every thread of the block, once a slab: slab k+1 is written and slab k
  // is free. The two parts arrive from their own loops.
  auto slab_barrier = [] {
    asm volatile("bar.sync 2, %0;\n" :: "n"(Fused::THREADS) : "memory");
  };

  if (tid >= Fused::MMA_THREADS) {
    // ---- conv0 part.
    const int t = tid - Fused::MMA_THREADS;
    {
      int b, oy0, ox0;
      decode(first, b, oy0, ox0);
      for (int i = t; i < Fused::STRIP_H * Fused::STRIP_W;
           i += Fused::C0_THREADS)
        strip[i] = strip_value(x + static_cast<size_t>(b) * H * W, H, W,
                               oy0 * 2 - 1, ox0 * 2 - 1, i);
      asm volatile("bar.sync 1, %0;\n" :: "n"(Fused::C0_THREADS) : "memory");
    }
    // Slab k (tile it, chunk c) from strip it&1; the last chunk of a tile
    // also fetches the strip of the next.
    for (int k = 0; k < slabs; ++k) {
      const int it = k / G::CHUNKS, c = k - it * G::CHUNKS;
      int b, oy0, ox0, nb = 0, noy0 = 0, nox0 = 0;
      decode(first + it, b, oy0, ox0);
      const bool has_next = c == G::CHUNKS - 1 && it + 1 < n;
      if (has_next) decode(first + it + 1, nb, noy0, nox0);
      conv0_chunk(H, W, oy0 * 2 - 1, ox0 * 2 - 1,
                  strip + (it & 1) * Fused::STRIP_FLOATS, c, w0, b0,
                  patches + (k & 1) * G::PATCH_BYTES, t, has_next,
                  x + static_cast<size_t>(nb) * H * W, noy0 * 2 - 1,
                  nox0 * 2 - 1, strip + ((it + 1) & 1) * Fused::STRIP_FLOATS);
      slab_barrier();         // conv1 of slab k may start
    }
    slab_barrier();           // ... and has ended for the last slab
  } else {
    // ---- conv1 part: two warpgroups, 64 pixels each.
    const int warp = tid >> 5, lane = tid & 31;
    const int m0 = warp * 16;   // this warp's 16 pixels of a tile
    const uint32_t a_base = G::a_lane(smem_u32(patches), m0, lane);
    const uint32_t ring = smem_u32(wring);
    const int total = slabs * G::SPC;   // weight stages of the launch
    // Stage g of the launch is stage g % STAGES of the packed weights.
    auto copy_stage = [&](int g) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(wp)
          + static_cast<size_t>(g % G::STAGES) * G::STAGE_BYTES;
      const uint32_t dst = ring + (g % G::NST) * G::STAGE_BYTES;
      for (int i = tid; i < G::STAGE_BYTES / 16; i += Fused::MMA_THREADS)
        cp_async16(dst + i * 16, src + i * 16);
    };
    auto mma_barrier = [] {
      asm volatile("bar.sync 3, %0;\n" :: "n"(Fused::MMA_THREADS) : "memory");
    };
#pragma unroll
    for (int g = 0; g < G::LOOK; ++g) {
      if (g < total) copy_stage(g);
      cp_async_commit();
    }
    float acc[G::NT * 4], part[G::NT * 4];
#pragma unroll
    for (int i = 0; i < G::NT * 4; ++i) acc[i] = 0.0f;
    slab_barrier();             // slab 0 is written
    for (int k = 0; k < slabs; ++k) {
      const int it = k / G::CHUNKS, c = k - it * G::CHUNKS;
      const uint32_t a_slab = a_base + (k & 1) * G::PATCH_BYTES;
      for (int st = 0; st < G::SPC; ++st) {
        const int g = k * G::SPC + st;
        cp_async_wait<G::LOOK - 1>();   // stage g has landed
        fence_async_smem();
        mma_barrier();   // every warp is done with stage g-1: its slot
        if (g + G::LOOK < total) copy_stage(g + G::LOOK);
        cp_async_commit();
        stage_products<G>(acc, part, a_slab, st * G::TPS,
                          ring + (g % G::NST) * G::STAGE_BYTES);
      }
      if (c == G::CHUNKS - 1) {
        // Both warpgroups have read slab k: its buffer stages the output.
        mma_barrier();
        int b, oy0, ox0;
        decode(first + it, b, oy0, ox0);
        store_tile<G>(acc, bias,
                      patches + (k & 1) * G::PATCH_BYTES + warp * G::OUT_STAGE,
                      y, b, oy0, ox0, 0, Ho, Wo, m0, lane);
#pragma unroll
        for (int i = 0; i < G::NT * 4; ++i) acc[i] = 0.0f;
      }
      slab_barrier();           // slab k is free, slab k+1 is written
    }
  }
}

//                Cin Cout  stride  TH, TW, NB, CC, NST
using Conv2 = Cfg<96, 160, 2, 2, KIRI_STEM_F32_TILE_2>;
using Conv3 = Cfg<160, 256, 2, 1, KIRI_STEM_F32_TILE_3>;

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

template <class C>
int launch(const void* x, const void* wp, const void* bias, void* y, int B,
           int H, int W, cudaStream_t stream) {
  static std::atomic<bool> allowed[kMaxDevices];
  const int Ho = (H - 1) / C::SH + 1, Wo = (W - 1) / C::SW + 1;
  const int tiles_x = (Wo + C::TW - 1) / C::TW;
  const int tiles_y = (Ho + C::TH - 1) / C::TH;
  const long long blocks =
      static_cast<long long>(B) * tiles_x * tiles_y * C::NBLK;
  if (blocks <= 0 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err == cudaSuccess && !allowed[dev].load()) {
    err = cudaFuncSetAttribute(stem_f32_layer_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    if (err == cudaSuccess) allowed[dev].store(true);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  stem_f32_layer_kernel<C><<<static_cast<unsigned>(blocks), C::THREADS,
                             C::SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wp),
      static_cast<const float*>(bias), static_cast<float*>(y), H, W, Ho, Wo,
      tiles_x, tiles_y);
  return static_cast<int>(cudaGetLastError());
}

int launch_conv01(const void* x, const void* w0, const void* b0,
                  const void* wp, const void* bias, void* y, int B, int H,
                  int W, cudaStream_t stream) {
  using G = Fused::G;
  static std::atomic<int> sms_of[kMaxDevices];   // 0: not asked yet
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const int tiles_x = (Wo + G::TW - 1) / G::TW;
  const int tiles_y = (Ho + G::TH - 1) / G::TH;
  const long long tiles = static_cast<long long>(B) * tiles_x * tiles_y;
  // A block counts its weight stages, STAGES a tile, in an int.
  if (tiles <= 0 || tiles > 0x7fffffffLL / G::STAGES)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = current_device(&dev);
  int sms = err == cudaSuccess ? sms_of[dev].load() : 0;
  if (err == cudaSuccess && sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(stem_f32_conv01_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 Fused::SMEM);
    if (err == cudaSuccess) sms_of[dev].store(sms);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // One block per SM, each a run of consecutive tiles.
  const int per_block = static_cast<int>((tiles + sms - 1) / sms);
  const int blocks = static_cast<int>((tiles + per_block - 1) / per_block);
  stem_f32_conv01_kernel<<<blocks, Fused::THREADS, Fused::SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w0),
      static_cast<const float*>(b0), static_cast<const float*>(wp),
      static_cast<const float*>(bias), static_cast<float*>(y), H, W, Ho, Wo,
      tiles_x, tiles_y, static_cast<int>(tiles), per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch of the float32 stem. layer 1: x is the normalized line [B, H,
// W] float32, w0 [9, 48] and b0 [48] are conv0's folded weights, and the
// kernel computes conv0 and conv1 (-> [B, H/2, W/2, 96]). layers 2, 3: x is
// the NHWC [B, H, W, Cin] output of the layer before (w0, b0 unused). wp is
// the layer's packed hi/lo weights (kernels/stem.py::pack_tf32_weights),
// bias [Cout], y the NHWC float32 output. Returns cudaGetLastError() after
// the launch.
extern "C" int kiri_stem_f32x3_layer(int layer, const void* x, const void* w0,
                                     const void* b0, const void* wp,
                                     const void* bias, void* y, int B, int H,
                                     int W, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layer) {
    case 1: return launch_conv01(x, w0, b0, wp, bias, y, B, H, W, s);
    case 2: return launch<Conv2>(x, wp, bias, y, B, H, W, s);
    case 3: return launch<Conv3>(x, wp, bias, y, B, H, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
