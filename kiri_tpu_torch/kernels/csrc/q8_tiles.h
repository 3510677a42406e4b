// The tiling of the int8 kernels. This file is the one place that states
// these numbers: q8_stem.cu and q8_gemm.cu compile them in, and
// kernels/quant8.py reads them from here (Q8_TILES, Q8_GEMM) for its tile
// plans and weight packing.
//
// q8_stem.cu, one line a layer: TH, TW, NST, SPS, MINB. A block (layer 1: a
// tile of the persistent block) owns a TH x TW rectangle of output pixels
// of one image, 64 pixels a warpgroup; its weights travel through a ring of
// NST stages of SPS k32 steps each (layer 1 keeps all its weights in shared
// memory: NST and SPS unused); MINB blocks share an SM.
#define KIRI_Q8_TILE_1 8, 16, 0, 0, 1
#define KIRI_Q8_TILE_2 4, 32, 3, 3, 2
#define KIRI_Q8_TILE_3 6, 32, 3, 3, 1
// q8_gemm.cu: BM, NC, SPS, NST. A block owns BM rows of x across all of N,
// walked in chunks of NC columns; the weights travel through a ring of NST
// stages of SPS k32 steps each.
#define KIRI_Q8_GEMM 64, 128, 2, 4
