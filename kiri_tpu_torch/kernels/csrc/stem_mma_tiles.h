// The tiling of stem_mma.cu, one line a layer: TH, TW, KS, NST. A block owns
// a TH x TW rectangle of output pixels of one image (64 pixels a warpgroup);
// its weights travel in stages of KS reduction rows through a ring of NST
// stages (layer 1 keeps all its weights in shared memory and uses KS only
// for its geometry). This file is the one place that states these numbers:
// stem_mma.cu compiles them in, and kernels/stem.py reads TH and TW from
// here for tile_plan.
#define KIRI_STEM_TILE_1 8, 16, 48, 2
#define KIRI_STEM_TILE_2 4, 32, 96, 3
#define KIRI_STEM_TILE_3 6, 32, 80, 2
