// Shared pieces of the CUDA-core bodies of the head-major flash-attention
// kernels K4 and K5 (flash_attention_bh_fwd.cu, flash_attention_bh_bwd.cu),
// on top of the tile helpers of flash_common.cuh. They serve K4 in fp32
// and bf16 at the widths that are not 64, 128 or 256, and K5 in fp32; K4
// in bf16 at 64, 128 and 256 runs the tensor-core bodies of
// flash_wgmma_fwd.cuh / flash_wgmma_bwd.cuh instead, and K4 in fp32
// there the 3xTF32 bodies of flash_tf32.cuh.
//
// Layout: q/out/dO (BH, S, D) and k/v (BH, T, D), contiguous, so the rows
// row0 .. row0 + n - 1 of one bh are one contiguous run of n * D elements.
// A kernel is instantiated for a padded width DP (32, 64, 96, 128, 192 or
// 256, the smallest that holds D): tiles are DP columns wide in shared
// memory, columns D .. DP - 1 are zeros there, so they add nothing to a
// dot product and are never written back. Tiles are BT x BT with BT = 64,
// or 32 for the widths whose 64-row tiles do not fit a block's 227 KB.
// Work split: a block of 256 threads is a 16 x 16 grid; thread (ty, tx)
// owns rows ty * (BT / 16) + i of a tile and columns tx + 16 * j of a
// score tile or of a DP-wide tile, so a row's max and sum are shuffles
// among 16 lanes of one warp.

#pragma once

#include "flash_common.cuh"

namespace ffflash {

constexpr int kMaxHeadDim = 256;

// rows row0 .. row0 + tile_rows - 1 of a (L, D) slab, widened to fp32 into
// dst (row stride ld); columns D .. DP - 1 and rows at or past L are zeros
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ src, int L,
                                          int D, int row0, int tile_rows) {
  for (int i = threadIdx.x; i < tile_rows * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    const int t = row0 + r;
    float x = 0.f;
    if (t < L && d < D) x = to_f(src[(size_t)t * D + d]);
    dst[r * ld + d] = x;
  }
}

// arguments every K4 entry point validates the same way: the q tiles ride
// grid.x and the bh index grid.y (at most 65535)
inline bool bh_shapes_ok(int BH, int S, int T, int D) {
  return BH > 0 && BH <= 65535 && S > 0 && T > 0 && D > 0 &&
         D <= kMaxHeadDim;
}

}  // namespace ffflash
