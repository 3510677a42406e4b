// The tiling of stem_f32x3.cu, one line a layer: TH, TW, NB, CC, NST. A
// block owns a TH x TW rectangle of output pixels of one image (64 pixels a
// warpgroup) and NB of the layer's output channels. The reduction runs over
// chunks of CC input channels, K ordered (chunk, dy, dx, channel in chunk):
// the block stages the patch of one chunk at a time (two chunk buffers), and
// the weights travel through a ring of NST stages, a stage being one row of
// 3 taps of one chunk (3 * CC rows, hi and lo halves, NB channels). This
// file is the one place that states these numbers: stem_f32x3.cu compiles
// them in, and kernels/stem.py reads them for tile_plan and the weight
// packing.
//
// Shared memory a block (of 232,448 bytes), float32 values:
//   layer 1 (conv0 + conv1, 48 -> 96): two chunk patches 17 x 33 pixels x 80
//     bytes = 92,480; ring 3 x 36,864 = 110,592; two conv0 strips 5,344;
//     208,416 in all. conv1's whole weights (hi + lo, 331,776 bytes) do not
//     fit: they stream.
//   layer 2 (96 -> 160): patches 2 x 9 x 65 x 80 = 95,040; ring 2 x 61,440;
//     217,920.
//   layer 3 (160 -> 256, two blocks a tile of 128 channels each, 3
//     warpgroups): patches 2 x 13 x 34 x 80 = 70,720; ring 3 x 49,152;
//     218,176.
// Registers: a product thread keeps NB/2 float32 sums and as many partial
// sums of the current stage (stem_f32x3.cu::stage_products); layer 3's 384
// threads have 168 registers each and spill a few bytes.
#define KIRI_STEM_F32_TILE_1 8, 16, 96, 16, 3
#define KIRI_STEM_F32_TILE_2 4, 32, 160, 16, 2
#define KIRI_STEM_F32_TILE_3 6, 32, 128, 16, 3
