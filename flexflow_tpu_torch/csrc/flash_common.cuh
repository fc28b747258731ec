// Shared pieces of the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): tile sizes, dtype conversion, row reductions
// and the staging of (rows, heads, D) slabs into shared memory.
//
// Layout: every tensor stays in the projection layout the model produces,
// q/out/dO (B, S, H, D) and k/v (B, T, Hkv, D), contiguous; element
// (b, t, h, d) of a slab with L rows and `heads` heads sits at
// ((b * L + t) * heads + h) * D + d. A q head h reads kv head h / rep
// (rep = H / Hkv): no head-major copy and no repeated K/V.
//
// Work split: a block of 256 threads is a 16 x 16 grid; tiles are BT x BT
// with BT = 64, or 32 where 64-row tiles of a kernel do not fit a block's
// 227 KB of shared memory (D 256 in the backward). Thread (ty, tx) owns
// rows ty * (BT / 16) + i of a tile and, of a score tile, columns
// tx + 16 * j (j < BT / 16); of a D-wide tile, columns tx + 16 * jd
// (jd < D / 16). The 16 threads of one row are 16 lanes of one warp, so a
// row's max and sum are warp shuffles. Tiles are staged in
// fp32 (bf16 inputs are widened on load, so every product is exact in
// fp32, as on a tensor core) with rows padded by one float, which keeps
// the column-wise reads of the score loops free of bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ffflash {

constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;  // masked score (as the TPU kernel)
constexpr size_t kMaxSmemBytes = 232448;  // 227 KB a block may use

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and widened back: the rounding points of the reference
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// max / sum over the 16 lanes that hold one row (lane bits 0..3)
__device__ __forceinline__ float row_max16(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows row0 .. row0 + tile_rows - 1 of head h of batch entry b, widened
// to fp32 into dst (row stride ld); rows at or past L are zeros
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const T* __restrict__ src, int b,
                                          int L, int heads, int h, int row0,
                                          int tile_rows) {
  for (int i = threadIdx.x; i < tile_rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = row0 + r;
    float x = 0.f;
    if (t < L) x = to_f(src[(((size_t)b * L + t) * heads + h) * D + d]);
    dst[r * ld + d] = x;
  }
}

template <int D>
__device__ __forceinline__ size_t elem(int b, int L, int heads, int h,
                                       int t, int d) {
  return (((size_t)b * L + t) * heads + h) * D + d;
}

// arguments every entry point validates the same way: the head dims the
// kernels are instantiated for, and B * H on grid.y
inline bool shapes_ok(int B, int S, int T, int H, int Hkv, int D) {
  return B > 0 && S > 0 && T > 0 && Hkv > 0 && H % Hkv == 0 &&
         (D == 64 || D == 128 || D == 256) && (long long)B * H <= 65535;
}

}  // namespace ffflash
