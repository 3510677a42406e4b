// The recognizer's conv stem in bfloat16 on the tensor cores: three launches
// for the four layers (3x3 SAME conv + folded-BatchNorm bias + SiLU, NHWC),
// conv0 computed inside the conv1 kernel.
//
// Replaces the TPU kernel kiri_tpu/kernels/stem.py::stem_fused_tpu (body
// _stem_kernel) for bfloat16 inputs; csrc/stem_f32x3.cu is the float32
// route.
//
// Bound on an H100: operations. At batch 128 x 48 x 640 the stem is 240
// GFLOP of bf16 products (convs 1-3) and 3.4 GFLOP of float32 (conv0)
// against ~71 MB of input and output, ~0.29 ms at the tensor cores' 989
// TFLOP/s. What the design does about it:
//
//  * Each layer is an implicit GEMM (M = output pixels, N = Cout, K = 9*Cin
//    in the folded weights' (dy, dx, cin) order) on wgmma.m64nNk16 with bf16
//    operands and float32 accumulators: a warpgroup owns 64 output pixels
//    and all N = Cout channels; bias and SiLU in float32, one rounding to
//    bf16.
//  * A block owns a TH x TW rectangle of output pixels of one image. It
//    stages the input patch that rectangle needs (rows and columns with the
//    1-pixel halo, all Cin channels) in shared memory once, with 16-byte
//    cp.async, zeros outside the image. The stride-2 pixel step means a
//    tap's A rows are no dense tile, so A goes through registers: each warp
//    reads its 16 pixels of a tap with one ldmatrix at tap-shifted
//    addresses. For a column stride of 2 the patch keeps even and odd
//    columns in separate planes, so the 8 rows of an ldmatrix phase are
//    consecutive pixels; a pixel's pitch is Cin*2 + 16 bytes, an odd number
//    of 16-byte units, so those 8 rows fall in 8 different bank groups.
//  * B, the weights, is read by wgmma straight from shared memory, once a
//    warpgroup and not once a warp: with mma.sync the ldmatrix traffic of B,
//    not the tensor cores, set the pace. The weights (up to 737 KB a layer)
//    stream through a ring of NST stages of KS reduction rows each, cp.async
//    of stage s+NST-1 overlapping the products of stage s, one
//    __syncthreads() a stage. They come packed (kernels/stem.py::
//    pack_stem_weights) as 8 x 8 core matrices, [16-row step][k half][8
//    channels][channel][k], the unswizzled K-major layout of a wgmma
//    descriptor: a stage is KS/16 steps, one contiguous copy. The tile
//    shapes and stage sizes are in stem_mma_tiles.h.
//  * conv0 + conv1 is one persistent block per SM (stem_conv01_kernel
//    below): 12 of its warps compute conv0 of the next tile on the CUDA
//    cores while the other 8 multiply the current one, so conv0's output
//    (377 MB at batch 128) never exists in device memory. Patch positions
//    outside the image are zeros, not conv0 of the padding: they are
//    conv1's SAME padding.
//  * The epilogue goes through shared memory (the patch, once it has been
//    read): a thread holds 2 channels of a pixel here, 2 there, and device
//    memory wants whole pixels, 16 bytes a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "stem_mma_tiles.h"

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
// Shared-memory writes of this thread (st.shared, landed cp.async) become
// visible to wgmma, which reads shared memory through the async proxy.
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
// Descriptor of a K-major, unswizzled B tile of 16 reduction rows: 8 x 8
// core matrices of 128 contiguous bytes (8 channels x 8 k); lbo = bytes
// from the k 0-7 core matrix to the k 8-15 one, sbo = bytes from one group
// of 8 channels to the next.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4)
      | (static_cast<uint64_t>(lbo >> 4) << 16)
      | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// D[64 x N] += A[64 x 16] * B[16 x N] for one warpgroup: A from registers
// (the warp's 16 rows in the mma.m16n8k16 fragment layout), B through a
// shared-memory descriptor, D in N/2 registers a thread: d[4j+e] is element
// e of the m16n8 accumulator fragment of channel group j.
template <int N> struct Wgmma;

template <> struct Wgmma<96> {
  static __device__ __forceinline__ void mma(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct Wgmma<160> {
  static __device__ __forceinline__ void mma(float (&d)[80],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
        "{%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
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
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// v / (1 + exp(-v)) on the special-function unit's ex2 and rcp (flush to
// zero: 5 operations). Their error, ~2^-22 relative, is far below the
// bf16 rounding that follows.
__device__ __forceinline__ float silu(float v) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(v * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
  return v * r;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One layer's tiling. A block of WGS warpgroups owns TH x TW = 64*WGS output
// pixels of one image (warpgroup w the 64 pixels from 64*w on, in row-major
// order of the rectangle) and all COUT channels.
template <int CIN_, int COUT_, int SH_, int SW_, int TH_, int TW_, int KS_,
          int NST_>
struct Cfg {
  static constexpr int CIN = CIN_, COUT = COUT_, SH = SH_, SW = SW_;
  static constexpr int TH = TH_, TW = TW_, KS = KS_, NST = NST_;
  static constexpr int M = TH * TW, WGS = M / 64, NT = COUT / 8;
  static constexpr int THREADS = 128 * WGS;
  static constexpr int PH = (TH - 1) * SH + 3;       // patch rows
  static constexpr int PW = (TW - 1) * SW + 3;       // patch columns
  static constexpr int PWP = (PW + SW - 1) / SW;     // columns a parity plane
  static constexpr int PITCH = CIN * 2 + 16;         // bytes a patch pixel
  static constexpr int PATCH_BYTES = PH * SW * PWP * PITCH;
  static constexpr int STEP_BYTES = 16 * COUT * 2;   // 16 reduction rows
  static constexpr int LBO = 8 * COUT * 2, SBO = 128;
  static constexpr int STAGE_BYTES = KS * COUT * 2;
  static constexpr int STAGES = 9 * CIN / KS;
  static constexpr int SMEM = PATCH_BYTES + NST * STAGE_BYTES;
  static constexpr int OPITCH = COUT * 2 + 16;       // bytes a staged pixel
  static_assert(M * OPITCH <= PATCH_BYTES, "the output tile fits the patch");
  static_assert(M % 64 == 0 && TW % 8 == 0, "pixel tile");
  static_assert(CIN % KS == 0 && KS % 16 == 0, "a stage lies within one tap");
  static_assert((PITCH / 16) % 2 == 1,
                "odd pitch in 16-byte units: ldmatrix rows hit all banks");
  static_assert(NST >= 2 && STAGES >= NST, "ring");
  static_assert(SMEM <= 232448, "shared memory of one block");

  // Byte offset of patch pixel (py, pc) from the start of the patch.
  __host__ __device__ static constexpr int patch_off(int py, int pc) {
    return ((py * SW + pc % SW) * PWP + pc / SW) * PITCH;
  }
  // Offset of tap (dy, dx) from tap (0, 0) for any output pixel.
  __host__ __device__ static constexpr int tap_off(int dy, int dx) {
    return ((dy * SW + dx % SW) * PWP + dx / SW) * PITCH;
  }
  // ldmatrix row address of this lane for the warp's 16 pixels from pixel
  // m0 of the tile on, at tap (0, 0): lane l gives pixel m0 + l%16, k-half
  // l/16.
  __device__ static uint32_t a_lane(uint32_t patch, int m0, int lane) {
    const int m = m0 + (lane & 15);
    const int ty = m / TW, tx = m % TW;
    return patch + (ty * SH * SW * PWP + tx) * PITCH + (lane >> 4) * 16;
  }
};

// Bias + SiLU in float32, one rounding to bf16, for the warp's 16 pixels
// from m0 on. Thread (g, q) of a warp holds rows g and g+8 and channels 2q,
// 2q+1 of every group of 8 channels: 4 bytes here, 4 bytes there. The warp
// first writes its 16 x COUT tile to `stage` (16 rows of OPITCH bytes of
// shared memory that nobody else touches, a pitch that keeps the 4-byte
// writes free of bank conflicts) and then copies it out 16 bytes a thread,
// whole pixels (COUT*2 contiguous bytes) at a time.
template <class C>
__device__ __forceinline__ void store_tile(
    const float (&acc)[C::NT * 4], const float* __restrict__ bias,
    unsigned char* stage, __nv_bfloat16* __restrict__ y, int b, int oy0,
    int ox0, int Ho, int Wo, int m0, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    unsigned char* row = stage + (half * 8 + g) * C::OPITCH + q * 4;
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
      *reinterpret_cast<uint32_t*>(row + j * 16) = pack_bf16(
          silu(acc[j * 4 + half * 2] + __ldg(bias + j * 8 + q * 2)),
          silu(acc[j * 4 + half * 2 + 1] + __ldg(bias + j * 8 + q * 2 + 1)));
  }
  __syncwarp();
  constexpr int CPP = C::COUT / 8;   // 16-byte pieces a pixel
#pragma unroll
  for (int i = lane; i < 16 * CPP; i += 32) {
    const int r = i / CPP, c = i - r * CPP;
    const int m = m0 + r;
    const int oy = oy0 + m / C::TW, ox = ox0 + m % C::TW;
    if (oy < Ho && ox < Wo)
      *reinterpret_cast<uint4*>(
          y + ((static_cast<size_t>(b) * Ho + oy) * Wo + ox) * C::COUT + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * C::OPITCH + c * 16);
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1) stem_layer_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int H,
    int W, int Ho, int Wo, int tiles_x, int tiles_y) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const patch = smem;
  unsigned char* const wring = smem + C::PATCH_BYTES;
  const int tid = threadIdx.x;
  int blk = blockIdx.x;
  const int tile_x = blk % tiles_x;
  blk /= tiles_x;
  const int tile_y = blk % tiles_y;
  const int b = blk / tiles_y;
  const int oy0 = tile_y * C::TH, ox0 = tile_x * C::TW;
  const int iy0 = oy0 * C::SH - 1, ix0 = ox0 * C::SW - 1;  // patch (0, 0)

  auto copy_stage = [&](int s) {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(wp)
        + static_cast<size_t>(s) * C::STAGE_BYTES;
    const uint32_t dst = smem_u32(wring + (s % C::NST) * C::STAGE_BYTES);
    for (int i = tid; i < C::STAGE_BYTES / 16; i += C::THREADS)
      cp_async16(dst + i * 16, src + i * 16);
  };

  {
    // The patch, straight from the NHWC input: cp.async group 0.
    constexpr int CH = C::CIN / 8;   // 16-byte chunks a pixel
    const __nv_bfloat16* xb = x + static_cast<size_t>(b) * H * W * C::CIN;
    for (int i = tid; i < C::PH * C::PW * CH; i += C::THREADS) {
      const int pix = i / CH, ch = i - pix * CH;
      const int py = pix / C::PW, pc = pix - py * C::PW;
      const int iy = iy0 + py, ix = ix0 + pc;
      unsigned char* dst = patch + C::patch_off(py, pc) + ch * 16;
      if (iy >= 0 && iy < H && ix >= 0 && ix < W)
        cp_async16(smem_u32(dst),
                   xb + (static_cast<size_t>(iy) * W + ix) * C::CIN + ch * 8);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
  }
#pragma unroll
  for (int s = 0; s < C::NST - 1; ++s) {
    copy_stage(s);
    cp_async_commit();
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int m0 = warp * 16;   // warp w of warpgroup g: pixels 64g + 16w ...
  const uint32_t a_base = C::a_lane(smem_u32(patch), m0, lane);
  const uint32_t ring = smem_u32(wring);

  float acc[C::NT * 4];
#pragma unroll
  for (int i = 0; i < C::NT * 4; ++i) acc[i] = 0.0f;

  for (int s = 0; s < C::STAGES; ++s) {
    cp_async_wait<C::NST - 2>();   // stage s (and the patch) have landed
    fence_async_smem();
    wgmma_wait<0>();               // this warpgroup has read stage s-1
    __syncthreads();               // ... and so has every other
    if (s + C::NST - 1 < C::STAGES) copy_stage(s + C::NST - 1);
    cp_async_commit();
    const int k0 = s * C::KS;
    const int tap = k0 / C::CIN, c0 = k0 - tap * C::CIN;
    const int dy = tap / 3, dx = tap - dy * 3;
    const uint32_t a_tap = a_base + C::tap_off(dy, dx) + c0 * 2;
    const uint32_t b_stage = ring + (s % C::NST) * C::STAGE_BYTES;
    uint32_t a[2][4];
#pragma unroll
    for (int kk = 0; kk < C::KS / 16; ++kk) {
      ldmatrix_x4(a[kk & 1], a_tap + kk * 32);
      wgmma_fence();
      Wgmma<C::COUT>::mma(
          acc, a[kk & 1],
          wgmma_desc(b_stage + kk * C::STEP_BYTES, C::LBO, C::SBO));
      wgmma_commit();
      wgmma_wait<1>();   // the step before is done: its A registers are free
    }
  }
  wgmma_wait<0>();
  __syncthreads();   // nobody reads the patch any more: it stages the output
  store_tile<C>(acc, bias, patch + m0 * C::OPITCH, y, b, oy0, ox0, Ho, Wo, m0,
                lane);
}

// conv0 + conv1 in one persistent block per SM. conv1's whole packed weights
// (432 rows, 81 KB) stay in shared memory beside two patches; warps 0-7 (two
// warpgroups) run conv1's products on the patch of tile i while warps 8-19
// compute conv0 of tile i+1 into the other patch (float32 FMAs and SiLU on
// the CUDA cores), one block-wide barrier a tile. The two parts use
// different units of the SM, so the slower of them, not their sum, sets the
// pace.
struct Fused {
  using G = Cfg<kC0, 96, 2, 2, KIRI_STEM_TILE_1>;   // geometry of a tile
  static constexpr int MMA_THREADS = G::THREADS;   // 256
  static constexpr int C0_THREADS = 384;
  static constexpr int C0_GROUPS = kC0 / 4;   // channel groups of 4
  static constexpr int C0_SLOTS = C0_THREADS / C0_GROUPS;
  static constexpr int THREADS = MMA_THREADS + C0_THREADS;
  static constexpr int K = 9 * G::CIN;
  static constexpr int W_BYTES = K * G::COUT * 2;
  static constexpr int STRIP_H = G::PH + 2, STRIP_W = G::PW + 2;
  static constexpr int STRIP_FLOATS = (STRIP_H * STRIP_W + 3) / 4 * 4;
  static constexpr int SMEM =
      W_BYTES + 2 * G::PATCH_BYTES + 2 * STRIP_FLOATS * 4;
  static_assert(C0_THREADS % C0_GROUPS == 0, "conv0 threads");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// The float32 strip of the line under one tile's patch, with conv0's own
// halo: element i of [STRIP_H][STRIP_W], zero outside the line.
__device__ __forceinline__ float strip_value(
    const __nv_bfloat16* __restrict__ xb, int H, int W, int iy0, int ix0,
    int i) {
  const int sy = i / Fused::STRIP_W, sx = i - sy * Fused::STRIP_W;
  const int iy = iy0 - 1 + sy, ix = ix0 - 1 + sx;
  return (iy >= 0 && iy < H && ix >= 0 && ix < W)
      ? __bfloat162float(xb[static_cast<size_t>(iy) * W + ix]) : 0.0f;
}

// conv0 of one tile's patch by the C0_THREADS threads of the conv0 part
// (t = index within it), from the tile's strip in shared memory: float32
// FMAs, bias, SiLU, one rounding to bf16. Thread t keeps conv0's weights of
// 4 channels (group t % 12) in registers for the whole launch and walks over
// pairs of neighbouring pixels (slot t / 12 of C0_SLOTS), so the only
// shared-memory traffic is the strip in and 8 bytes a pixel out. Patch
// positions outside the image are conv1's SAME padding: zeros. Meanwhile the
// strip of the next tile (nxb etc., when has_next) travels from device
// memory through registers into strip_next; the barrier at the end makes it
// whole and frees `strip`.
__device__ __forceinline__ void conv0_tile(
    int H, int W, int iy0, int ix0, const float* strip,
    const float (&w)[9][4], const float (&bias)[4], unsigned char* patch,
    int t, bool has_next, const __nv_bfloat16* __restrict__ nxb, int niy0,
    int nix0, float* strip_next) {
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
  constexpr int PAIRS = (G::PW + 1) / 2;        // pixel pairs a patch row
  const int cg = t % Fused::C0_GROUPS;
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
      a0[j] = silu(a0[j] + bias[j]);
      a1[j] = silu(a1[j] + bias[j]);
    }
    const uint32_t m0 = in0 ? 0xffffffffu : 0u, m1 = in1 ? 0xffffffffu : 0u;
    *reinterpret_cast<uint2*>(patch + G::patch_off(py, pc) + cg * 8) =
        make_uint2(pack_bf16(a0[0], a0[1]) & m0, pack_bf16(a0[2], a0[3]) & m0);
    if (pc + 1 < G::PW)
      *reinterpret_cast<uint2*>(patch + G::patch_off(py, pc + 1) + cg * 8) =
          make_uint2(pack_bf16(a1[0], a1[1]) & m1,
                     pack_bf16(a1[2], a1[3]) & m1);
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

__global__ void __launch_bounds__(Fused::THREADS, 1) stem_conv01_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ w0,
    const float* __restrict__ b0, const __nv_bfloat16* __restrict__ wp,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int H,
    int W, int Ho, int Wo, int tiles_x, int tiles_y, int tiles,
    int tiles_per_block) {
  using G = Fused::G;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const wsm = smem;
  unsigned char* const patches = smem + Fused::W_BYTES;
  float* const strip =
      reinterpret_cast<float*>(patches + 2 * G::PATCH_BYTES);
  const int tid = threadIdx.x;
  const int first = blockIdx.x * tiles_per_block;
  const int n = min(tiles_per_block, tiles - first);
  if (n <= 0) return;

  for (int i = tid; i < Fused::W_BYTES / 16; i += Fused::THREADS)
    cp_async16(smem_u32(wsm) + i * 16,
               reinterpret_cast<const unsigned char*>(wp) + i * 16);
  cp_async_commit();
  // Tile t of the launch -> image, patch origin (conv0 part) or output
  // origin (conv1 part).
  auto decode = [&](int t, int& b, int& oy0, int& ox0) {
    const int tile_x = t % tiles_x;
    t /= tiles_x;
    b = t / tiles_y;
    oy0 = (t - b * tiles_y) * G::TH;
    ox0 = tile_x * G::TW;
  };
  // Every thread of the block, once a tile: patch it+1 is written and patch
  // it is free. The two parts arrive from their own loops.
  auto tile_barrier = [] {
    asm volatile("bar.sync 2, %0;\n" :: "n"(Fused::THREADS) : "memory");
  };

  if (tid >= Fused::MMA_THREADS) {
    // ---- conv0 part. Its weights [9][48] and bias [48]: 4 channels a thread.
    const int t = tid - Fused::MMA_THREADS;
    float w0r[9][4], b0r[4];
    const int cg = t % Fused::C0_GROUPS;
#pragma unroll
    for (int k = 0; k < 9; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) w0r[k][j] = w0[k * kC0 + cg * 4 + j];
#pragma unroll
    for (int j = 0; j < 4; ++j) b0r[j] = b0[cg * 4 + j];
    {
      int b, oy0, ox0;
      decode(first, b, oy0, ox0);
      for (int i = t; i < Fused::STRIP_H * Fused::STRIP_W;
           i += Fused::C0_THREADS)
        strip[i] = strip_value(x + static_cast<size_t>(b) * H * W, H, W,
                               oy0 * 2 - 1, ox0 * 2 - 1, i);
      asm volatile("bar.sync 1, %0;\n" :: "n"(Fused::C0_THREADS) : "memory");
    }
    // Call k computes the patch of tile first+k from strip k&1 and fetches
    // the strip of tile first+k+1.
    for (int k = 0; k < n; ++k) {
      int b, oy0, ox0, nb = 0, noy0 = 0, nox0 = 0;
      decode(first + k, b, oy0, ox0);
      const bool has_next = k + 1 < n;
      if (has_next) decode(first + k + 1, nb, noy0, nox0);
      conv0_tile(H, W, oy0 * 2 - 1, ox0 * 2 - 1,
                 strip + (k & 1) * Fused::STRIP_FLOATS, w0r, b0r,
                 patches + (k & 1) * G::PATCH_BYTES, t, has_next,
                 x + static_cast<size_t>(nb) * H * W, noy0 * 2 - 1,
                 nox0 * 2 - 1, strip + ((k + 1) & 1) * Fused::STRIP_FLOATS);
      if (k == 0) {
        cp_async_wait<0>();   // this thread's share of the weights
        fence_async_smem();
      }
      tile_barrier();         // conv1 of tile k may start
    }
    tile_barrier();           // ... and has ended for tile n-1
  } else {
    // ---- conv1 part: two warpgroups, 64 pixels each.
    const int warp = tid >> 5, lane = tid & 31;
    const int m0 = warp * 16;   // this warp's 16 pixels of a tile
    const uint32_t a_base = G::a_lane(smem_u32(patches), m0, lane);
    const uint32_t wbase = smem_u32(wsm);
    cp_async_wait<0>();   // this thread's share of the weights
    fence_async_smem();   // ... for wgmma
    tile_barrier();       // patch 0 is written
    for (int it = 0; it < n; ++it) {
      int b, oy0, ox0;
      decode(first + it, b, oy0, ox0);
      const uint32_t a_tile = a_base + (it & 1) * G::PATCH_BYTES;
      float acc[G::NT * 4];
#pragma unroll
      for (int i = 0; i < G::NT * 4; ++i) acc[i] = 0.0f;
      uint32_t a[2][4];
#pragma unroll
      for (int step = 0; step < Fused::K / 16; ++step) {
        constexpr int PER_TAP = G::CIN / 16;
        const int tap = step / PER_TAP, kk = step % PER_TAP;
        ldmatrix_x4(a[step & 1],
                    a_tile + G::tap_off(tap / 3, tap % 3) + kk * 32);
        wgmma_fence();
        Wgmma<G::COUT>::mma(
            acc, a[step & 1],
            wgmma_desc(wbase + step * G::STEP_BYTES, G::LBO, G::SBO));
        wgmma_commit();
        wgmma_wait<1>();   // the step before is done: its A registers are free
      }
      wgmma_wait<0>();
      // Both warpgroups have read patch it: it stages the output.
      asm volatile("bar.sync 3, %0;\n" :: "n"(Fused::MMA_THREADS) : "memory");
      store_tile<G>(acc, bias,
                    patches + (it & 1) * G::PATCH_BYTES + m0 * G::OPITCH, y, b,
                    oy0, ox0, Ho, Wo, m0, lane);
      tile_barrier();      // patch it is free, patch it+1 is written
    }
  }
}

//                Cin Cout  stride  TH, TW, KS, NST
using Conv2 = Cfg<96, 160, 2, 2, KIRI_STEM_TILE_2>;
using Conv3 = Cfg<160, 256, 2, 1, KIRI_STEM_TILE_3>;

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
  const long long blocks = static_cast<long long>(B) * tiles_x * tiles_y;
  if (blocks <= 0 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err == cudaSuccess && !allowed[dev].load()) {
    err = cudaFuncSetAttribute(stem_layer_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    if (err == cudaSuccess) allowed[dev].store(true);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  stem_layer_kernel<C><<<static_cast<unsigned>(blocks), C::THREADS, C::SMEM,
                         stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wp), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), H, W, Ho, Wo, tiles_x, tiles_y);
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
  if (tiles <= 0 || tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = current_device(&dev);
  int sms = err == cudaSuccess ? sms_of[dev].load() : 0;
  if (err == cudaSuccess && sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(stem_conv01_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 Fused::SMEM);
    if (err == cudaSuccess) sms_of[dev].store(sms);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // One block per SM, each a run of consecutive tiles.
  const int per_block = static_cast<int>((tiles + sms - 1) / sms);
  const int blocks = static_cast<int>((tiles + per_block - 1) / per_block);
  stem_conv01_kernel<<<blocks, Fused::THREADS, Fused::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w0),
      static_cast<const float*>(b0), static_cast<const __nv_bfloat16*>(wp),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), H, W,
      Ho, Wo, tiles_x, tiles_y, static_cast<int>(tiles), per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch of the bf16 stem. layer 1: x is the normalized line [B, H, W]
// bf16, w0 [9, 48] and b0 [48] float32 are conv0's folded weights, and the
// kernel computes conv0 and conv1 (-> [B, H/2, W/2, 96]). layers 2, 3: x is
// the NHWC [B, H, W, Cin] output of the layer before (w0, b0 unused). wp is
// the layer's packed weights (kernels/stem.py::pack_stem_weights) bf16, bias
// [Cout] float32, y the NHWC bf16 output. Returns cudaGetLastError() after
// the launch.
extern "C" int kiri_stem_mma_layer(int layer, const void* x, const void* w0,
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
