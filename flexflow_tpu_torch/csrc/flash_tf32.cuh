// 3xTF32 flash-attention bodies for fp32 on Hopper's tensor cores
// (mma.sync), shared by K4's sources (flash_attention_bh_fwd.cu: the
// forward; flash_attention_bh_bwd.cu: dq and dk/dv on the head-major
// layout) and K2's (flash_attention_bwd.cu: dq and dk/dv on the flat
// projection layout, GQA). Each source wraps a body in a __global__ of
// its own name, so a profile and the SASS tell them apart.
//
// Every product is 3xTF32 on mma.sync m16n8k8 (tf32 in, fp32 accumulate):
// an fp32 x is hi = tf32(x) and lo = tf32(x - hi), rounded to nearest
// with ties away from zero (cvt.rna's rounding), and a.b is a_lo.b_hi +
// a_hi.b_lo + a_hi.b_hi, the small terms first. That is about fp32's own
// accuracy (a dropped lo.lo and lo's rounding, ~2^-22 of each product),
// where one tf32 product would keep ~2^-11. The CPU emulation is
// ops.flash_attention.einsum_3xtf32. The tensor cores' fp32 sums are not
// IEEE sums: each mma truncates toward zero, so a long chain of mma into
// one accumulator drifts (a non-causal forward over 2048 keys, 768 mma a
// chain, was off by ~1.5e-5 of its output's norm on an H100, three times
// the bound phase 2 holds it to). Chains are kept short where an output
// sums over many rows: the forward sums each 64 columns of its scores
// and each K/V tile's p . v in a fresh accumulator, and K2's flat dk/dv
// adds each GQA head's sums to the outputs, all in fp32 (the backward's
// products over one head's rows stay one chain, as K4's backward was
// tuned: it holds its bounds at the sequences phase 2 runs).
//
// A block holds BR rows of the RESIDENT operands, 16 a warp, and streams
// BS-row tiles of the others (forward: q resident, k and v streamed;
// dq: q and dO resident, k and v streamed; dk/dv: k and v resident, q
// and dO streamed). Per streamed tile a warp computes its 16 x BS scores
// in registers, turns them into p (and ds) there, and adds the products
// over the tile's rows to its output tiles (out += p . v; dq += ds . k;
// dv += p . dO, dk += ds . q), so dk/dv's tiles are S^T-shaped (keys by
// queries) and no operand is ever transposed in memory.
//
// Each operand is split into hi / lo once and kept split in shared
// memory: the resident rows when the block starts, each streamed tile as
// it arrives (its 16-byte cp.async copies land in a raw stage, which the
// next tile's copies reuse while this one is multiplied). Only p and ds,
// which are born in registers, are split there.
//
// Shared memory holds fp32 rows of D columns, swizzled: element (r, c) at
// r * D + (c ^ swz(r)), swz(r) = ((r >> 1) & 3) << 3 | (r & 1) << 2, so
// both fragment reads are free of bank conflicts: rows r0 + 0..7 at four
// columns (ldmatrix: a row's 16 bytes are one fp32 quad) and rows
// r0 + 2t + e (t = 0..3) at eight columns (the operand whose k runs over
// the streamed rows, read 32 bits a lane). The products over the streamed
// rows take p (or ds) straight from the score accumulators: a C fragment
// holds columns 2t, 2t + 1 where an A fragment wants k = t, t + 4, so
// k = t is read as row 2t and k = t + 4 as row 2t + 1 of the B operand.
//
// What bounds it: no single part; the products' mma, the fragment reads,
// the hi / lo split and the softmax each take a share, overlapping little
// at 4-8 warps an SM (variants timed at GPT-2 XL's shape, D 64). Every
// warp reads each streamed tile's hi and lo fragments for its own 16
// rows (wgmma, which would share them across a warpgroup, takes tf32
// only K-major, so the products over the streamed rows would need
// transposed copies of every tile).

#pragma once

#include "flash_common.cuh"

namespace fftf32 {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// tf32 bits of x, rounded to nearest with ties away from zero (as
// cvt.rna.tf32.f32) for every finite x: half the weight of the 13 dropped
// bits added, then those bits cleared
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
__device__ __forceinline__ float exp2_approx(float x) {  // 2^x, 0 at -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// d += a (16 x 8, row-major) . b (8 x 8, column-major), tf32 in, fp32
// sums (volatile: kept in the order written, which timed faster at
// GPT-2 XL's shape than the order the compiler chose)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
}
// four 8 x 4 fp32 matrices (each an 8 x 8 b16 one); lanes 8 m .. 8 m + 7
// give matrix m's row addresses; lane l receives (row l / 4, col l % 4)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p)));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ int swz(int r) {
  return ((r >> 1) & 3) << 3 | (r & 1) << 2;
}

// rows row0 .. row0 + rows - 1 of an fp32 slab of L rows, `ld` floats
// apart (D head-major; heads * D on the flat layout), into a swizzled
// tile: 16-byte cp.async copies, or with `vec` false (a base not 16-byte
// aligned) four scalar loads a quad; rows at or past L are left as they
// are (the split passes zero them)
template <int D>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int L, int row0, int rows, int ld,
                                          bool vec, int tid, int nthreads) {
  for (int i = tid; i < rows * (D / 4); i += nthreads) {
    const int r = i / (D / 4), c = (i - r * (D / 4)) * 4;
    float* d = dst + r * D + (c ^ swz(r));
    const float* sp = src + (size_t)(row0 + r) * ld + c;
    if (row0 + r >= L) continue;
    if (vec)
      cp_async16(d, sp);
    else
      *reinterpret_cast<float4*>(d) = make_float4(sp[0], sp[1], sp[2], sp[3]);
  }
}

// a raw (rows, D) tile into hi and lo arrays of the same layout; rows at
// or past `live` become zeros
template <int D>
__device__ __forceinline__ void split_tile(const float* src, float* hi,
                                           float* lo, int rows, int live,
                                           int tid, int nthreads) {
  for (int i = tid * 4; i < rows * D; i += nthreads * 4) {
    const float4 w = i / D < live ? *reinterpret_cast<const float4*>(src + i)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    uint4 h, l;
    split(w.x, h.x, l.x);
    split(w.y, h.y, l.y);
    split(w.z, h.z, l.z);
    split(w.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + i) = h;
    *reinterpret_cast<uint4*>(lo + i) = l;
  }
}

// the scores of one warp's 16 resident rows (m0 ..) against a streamed
// BS-row tile, c[n] the 16 x 8 block of streamed rows n * 8 ..: R . X^T,
// R split into rh / rl, X into xh / xl (A: matrices {rows 0..7, k 0..3},
// {8..15, 0..3}, {0..7, 4..7}, {8..15, 4..7}; B: {hi, k 0..3}, {hi,
// 4..7}, {lo, 0..3}, {lo, 4..7}). The tensor cores' fp32 sums truncate,
// so a chain of products into one accumulator drifts toward zero as it
// grows: each 64 columns (24 mma) are summed in a fresh accumulator and
// added in fp32.
template <int D, int NT>
__device__ __forceinline__ void scores(float (&c)[NT][4], const float* rh,
                                       const float* rl, const float* xh,
                                       const float* xl, int m0, int lane) {
  const int lr = lane & 7, lj = lane >> 3, ls = swz(lr);
  const int aoff = (m0 + lr + 8 * (lj & 1)) * D;
  auto chunk = [&](float (&d)[NT][4], int kk0) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[n][e] = 0.f;
#pragma unroll 2
    for (int kk = kk0; kk < kk0 + 8; ++kk) {
      const int acol = aoff + ((kk * 8 + 4 * (lj >> 1)) ^ ls);
      uint32_t ah[4], al[4];
      ldsm_x4(ah, rh + acol);
      ldsm_x4(al, rl + acol);
      const int bcol = lr * D + ((kk * 8 + 4 * (lj & 1)) ^ ls);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b[4];
        ldsm_x4(b, (lj < 2 ? xh : xl) + n * 8 * D + bcol);
        const uint32_t bh[2] = {b[0], b[1]}, bl[2] = {b[2], b[3]};
        mma3(d[n], ah, al, bh, bl);
      }
    }
  };
  static_assert(D % 64 == 0, "64-column chunks");
  chunk(c, 0);
#pragma unroll 1
  for (int kk0 = 8; kk0 < D / 8; kk0 += 8) {
    float part[NT][4];
    chunk(part, kk0);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[n][e] += part[n][e];
  }
}

// d += a . X[j * 8 .., col ..] (k-step j of the streamed rows, output
// columns col .. col + 7): a is a score fragment (k = t as streamed row
// 2t, k = t + 4 as 2t + 1), already split (ah / al), X's hi / lo tiles
// read at rows j * 8 + 2t and + 1, columns col + g (gc0 = g ^ swz(2t),
// gc1 = g ^ swz(2t + 1))
template <int D>
__device__ __forceinline__ void product_tile(float (&d)[4],
                                             const uint32_t (&ah)[4],
                                             const uint32_t (&al)[4],
                                             const float* xh, const float* xl,
                                             int j, int t, int col, int gc0,
                                             int gc1) {
  const int i0 = (j * 8 + 2 * t) * D + (col ^ gc0);
  const int i1 = (j * 8 + 2 * t + 1) * D + (col ^ gc1);
  const uint32_t bh[2] = {__float_as_uint(xh[i0]), __float_as_uint(xh[i1])};
  const uint32_t bl[2] = {__float_as_uint(xl[i0]), __float_as_uint(xl[i1])};
  mma3(d, ah, al, bh, bl);
}

// a score fragment's four values as an A operand (a0..a3 = c0, c2, c1,
// c3), split into hi / lo
__device__ __forceinline__ void split_fragment(const float (&c)[4],
                                               uint32_t (&h)[4],
                                               uint32_t (&l)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(c[(e & 1) * 2 + (e >> 1)], h[e], l[e]);
}

// output columns a block: D up to 128; D 256 in two column blocks (each
// recomputes the scores), so a warp's output tiles fit its registers
template <int D>
constexpr int kCols = D < 128 ? D : 128;

// ---- the forward (K4's fp32 body) -----------------------------------------
//
// One block per (BR query rows, bh, column block), the heavy (late)
// query tiles first; a loop over BS-row K/V tiles that stops at the
// causal diagonal. The online softmax keeps (m, l) in fp32 registers, m
// in log2 units (scores times scale * log2 e, p = 2^(x - m)); a lane
// holds a partial l of its row (its 2 of each 8 columns), summed over
// the row's 4 lanes at the end. Masked scores are -1e30 (times log2 e),
// keys past T are -inf. out = acc / max(l, 1e-30), lse = m ln 2 +
// log(max(l, 1e-30)).

// query rows a block (16 a warp), K/V rows a tile (at D 64 the fastest of
// the tiles timed at GPT-2 XL's shape: 64-row blocks were slower, and
// 32-row K/V tiles too once each tile's p . v takes a fresh accumulator;
// at 128 and 256 the largest that fit shared memory); BR <= 4 BS, so the
// raw q rows fit the K / V hi / lo arrays, where they wait to be split
template <int D>
struct FwdTiles;
template <>
struct FwdTiles<64> {
  static constexpr int BR = 128, BS = 64;
};
template <>
struct FwdTiles<128> {
  static constexpr int BR = 128, BS = 32;
};
template <>
struct FwdTiles<256> {
  static constexpr int BR = 64, BS = 16;
};

template <int D>
constexpr size_t fwd_smem_bytes() {
  // q's hi and lo, one raw K / V stage, K's and V's hi and lo
  return ((size_t)2 * FwdTiles<D>::BR * D + (size_t)6 * FwdTiles<D>::BS * D) *
         sizeof(float);
}

template <int D>
__device__ __forceinline__ void fwd_body(const float* __restrict__ q,
                                         const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         float* __restrict__ out,
                                         float* __restrict__ lse, int S,
                                         int Tk, int causal, float scale,
                                         int vec) {
  constexpr int BR = FwdTiles<D>::BR, BS = FwdTiles<D>::BS, DC = kCols<D>;
  constexpr int NT = BS / 8;  // score column tiles
  constexpr int NO = DC / 8;  // output column tiles
  constexpr int NTHREADS = BR * 2;
  static_assert(BR <= 4 * BS, "raw q rows fit the K / V hi / lo");
  extern __shared__ __align__(16) float tf32_smem[];
  float* sQh = tf32_smem;            // (BR, D) q, hi
  float* sQl = sQh + BR * D;         //            lo
  float* sStage = sQl + BR * D;      // {K, V} x (BS, D) raw
  float* sKh = sStage + 2 * BS * D;  // (BS, D) k, hi
  float* sKl = sKh + BS * D;         //            lo
  float* sVh = sKl + BS * D;         // (BS, D) v, hi
  float* sVl = sVh + BS * D;         //            lo

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t bh = blockIdx.y;
  const int cb = D > DC ? blockIdx.z * DC : 0;  // the block's out columns
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const float* qb = q + bh * S * D;
  const float* kb = k + bh * Tk * D;
  const float* vb = v + bh * Tk * D;
  // the K / V tiles that hold a visible key (up to the block's last
  // query, causal); at least one
  int it1 = (Tk + BS - 1) / BS;
  if (causal) it1 = min(it1, (min(Tk, r0 + BR) + BS - 1) / BS);
  auto stream = [&](int it) {
    load_rows<D>(sStage, kb, Tk, it * BS, BS, D, vec, tid, NTHREADS);
    load_rows<D>(sStage + BS * D, vb, Tk, it * BS, BS, D, vec, tid,
                 NTHREADS);
    cp_async_commit();
  };
  // q raw into the K / V hi / lo arrays, then split into its own
  load_rows<D>(sKh, qb, S, r0, BR, D, vec, tid, NTHREADS);
  cp_async_commit();
  stream(0);
  cp_async_wait<1>();
  __syncthreads();
  split_tile<D>(sKh, sQh, sQl, BR, S - r0, tid, NTHREADS);

  constexpr float kMasked = ffflash::kNegInf * kLog2e;
  const float scale2 = scale * kLog2e;
  const int m0 = warp * 16;
  const int rmin = r0 + m0;  // this warp's first query row
  float acc[NO][4], m2[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int o = 0; o < NO; ++o)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[o][e] = 0.f;
  const int gc0 = g ^ swz(2 * t), gc1 = g ^ swz(2 * t + 1);

  for (int it = 0; it < it1; ++it) {
    const int s0 = it * BS;
    // the tile has arrived, and every warp is done with the last one
    cp_async_wait<0>();
    __syncthreads();
    split_tile<D>(sStage, sKh, sKl, BS, Tk - s0, tid, NTHREADS);
    split_tile<D>(sStage + BS * D, sVh, sVl, BS, Tk - s0, tid, NTHREADS);
    __syncthreads();
    if (it + 1 < it1) stream(it + 1);  // into the stage just split

    float c[NT][4];
    scores<D, NT>(c, sQh, sQl, sKh, sKl, m0, lane);

    // fold the tile into (m, l, acc): x = s * scale * log2 e, masked or
    // past T as above; only a tile across the diagonal or past T tests
    // each element (warp-uniform choice)
    float corr[2];
    auto softmax = [&](bool edge) {
      float mx[2] = {m2[0], m2[1]};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = s0 + n * 8 + 2 * t + (e & 1);
          float x = c[n][e] * scale2;
          if (edge && kpos >= Tk)
            x = -INFINITY;
          else if (edge && causal && kpos > rmin + g + 8 * (e >> 1))
            x = kMasked;
          c[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = exp2_approx(m2[h] - mx[h]);
        m2[h] = mx[h];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(c[n][e] - m2[e >> 1]);
          c[n][e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = fmaf(l[h], corr[h], sum[h]);
    };
    const bool edge = s0 + BS > Tk || (causal && s0 + BS - 1 > rmin);
    if (edge)
      softmax(true);
    else
      softmax(false);

    // acc = acc * corr + p . v over the tile's rows, p split in
    // registers: each output tile's products summed in a fresh
    // accumulator (as in `scores`: a chain over every key would drift),
    // then folded into acc by an fp32 FMA
    uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) split_fragment(c[j], ph[j], pl[j]);
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j)
        product_tile<D>(d, ph[j], pl[j], sVh, sVl, j, t, cb + o * 8, gc0,
                        gc1);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[o][e] = fmaf(acc[o][e], corr[e >> 1], d[e]);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int o = 0; o < NO; ++o)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = rmin + g + 8 * (e >> 1);
      if (row >= S) continue;
      out[(bh * S + row) * D + cb + o * 8 + 2 * t + (e & 1)] =
          acc[o][e] / l[e >> 1];
    }
  if (t == 0 && cb == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rmin + g + 8 * h;
      if (row < S) lse[bh * S + row] = fmaf(m2[h], kLn2, logf(l[h]));
    }
}

template <int D, typename Kernel>
int launch_fwd(Kernel kernel, const void* q, const void* k, const void* v,
               void* out, void* lse, int BH, int S, int Tk, int causal,
               float scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  static_assert(smem <= ffflash::kMaxSmemBytes,
                "tiles do not fit shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec =
      ((((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) == 0);
  const dim3 grid((S + FwdTiles<D>::BR - 1) / FwdTiles<D>::BR, BH,
                  D / kCols<D>);
  kernel<<<grid, FwdTiles<D>::BR * 2, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out,
      (float*)lse, S, Tk, causal, scale, vec);
  return (int)cudaGetLastError();
}

// ---- the backward (K4's and K2's fp32 bodies) -----------------------------
//
// dq: the resident pair is (q, dO), the streamed one (k, v); dk/dv:
// resident (k, v), streamed (q, dO). Per streamed tile a warp computes
// C1 = R1 . X1^T and C2 = R2 . X2^T (s, or s^T, and dp, or dp^T), turns
// them into p = exp(s scale - lse) (exp2 of log2-scaled terms) and
// ds = p (dp - delta) scale, and adds dq += ds . k, or dk += ds^T . q
// and dv += p^T . dO.
//
// Layouts (template kFlat):
//   head-major: q/dO (BH, S, D), k/v (BH, T, D), lse/delta (BH, S); the
//     block's bh is blockIdx.y (H = Hkv = 1 at B = BH);
//   flat: q/dO (B, S, H, D), k/v (B, T, Hkv, D), rows H * D and Hkv * D
//     floats apart, lse/delta (B, H, S), query head h reading kv head
//     h / rep (rep = H / Hkv). dq: blockIdx.y = b * H + h. dk/dv:
//     blockIdx.y = b * Hkv + g, and the block streams the (rep query
//     heads of g) x (live query tiles), summing in registers: no atomics,
//     the same result from run to run.

// resident rows a block (16 a warp), streamed rows a tile (each the
// fastest of the widths timed at GPT-2 XL's shape, D 64; at 128 and 256
// the largest that fit shared memory); at every width 2 BR = 4 BS, so the
// resident pair's raw copies fit the streamed hi / lo arrays, where they
// wait to be split
template <int D>
struct Tiles;
template <>
struct Tiles<64> {
  static constexpr int BR = 128, BS = 64;
};
template <>
struct Tiles<128> {
  static constexpr int BR = 64, BS = 32;
};
template <>
struct Tiles<256> {
  static constexpr int BR = 32, BS = 16;
};

template <int D>
constexpr size_t smem_bytes() {
  // the resident pair's hi and lo, one raw stage of the streamed pair,
  // its hi and lo, the streamed rows' lse and delta (dk/dv)
  return ((size_t)4 * Tiles<D>::BR * D + (size_t)6 * Tiles<D>::BS * D +
          (size_t)2 * Tiles<D>::BS) * sizeof(float);
}

// kDkv false: dq (out1). kDkv true: dk (out1) and dv (out2).
template <bool kDkv, int D, bool kFlat>
__device__ __forceinline__ void bwd_body(const float* __restrict__ q,
                                         const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         const float* __restrict__ dout,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta,
                                         float* __restrict__ out1,
                                         float* __restrict__ out2, int S,
                                         int Tk, int H, int Hkv, int causal,
                                         float scale, int vec) {
  constexpr int BR = Tiles<D>::BR, BS = Tiles<D>::BS, DC = kCols<D>;
  constexpr int NT = BS / 8;   // score column tiles
  constexpr int NO = DC / 8;   // output column tiles
  constexpr int NTHREADS = BR * 2;
  static_assert(2 * BR == 4 * BS, "resident raw rows fill the hi / lo");
  extern __shared__ __align__(16) float tf32_smem[];
  float* sR1h = tf32_smem;           // (BR, D) q (dq) or k (dk/dv), hi
  float* sR1l = sR1h + BR * D;       //                               lo
  float* sR2h = sR1l + BR * D;       // (BR, D) dO or v, hi
  float* sR2l = sR2h + BR * D;       //                  lo
  float* sStage = sR2l + BR * D;     // {X1, X2} x (BS, D) raw
  float* sX1h = sStage + 2 * BS * D; // (BS, D) k (dq) or q (dk/dv), hi
  float* sX1l = sX1h + BS * D;       //                              lo
  float* sX2h = sX1l + BS * D;       // (BS, D) v or dO, hi
  float* sX2l = sX2h + BS * D;       //                  lo
  float* sL = sX2l + BS * D;         // (BS) lse x log2 e of the queries
  float* sD = sL + BS;               // (BS) delta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // heads of q and of k/v (1 and 1 head-major), the resident rows' head
  // count, and the block's batch entry and resident head
  const int hq = kFlat ? H : 1, hk = kFlat ? Hkv : 1;
  const int rep = hq / hk;
  const int hr_n = kDkv ? hk : hq;
  const int b = blockIdx.y / hr_n, hr = blockIdx.y - b * hr_n;
  const int cb = D > DC ? blockIdx.z * DC : 0;  // the block's output columns
  // dq: the heavy (late) query tiles first; dk/dv: the heavy key tiles
  // come first in order
  const int r0 =
      (kDkv ? blockIdx.x : gridDim.x - 1 - blockIdx.x) * BR;
  const int LR = kDkv ? Tk : S;  // resident rows
  const int LS = kDkv ? S : Tk;  // streamed rows
  const int ldR = hr_n * D, ldX = (kDkv ? hq : hk) * D;
  const size_t rbase = ((size_t)b * LR * hr_n + hr) * D;
  const float* R1 = (kDkv ? k : q) + rbase;
  const float* R2 = (kDkv ? v : dout) + rbase;
  // the streamed head of pass hl: dq, the kv head of h (one pass); dk/dv,
  // query head hl of group g (rep passes)
  auto xhead = [&](int hl) { return kDkv ? hr * rep + hl : hr / rep; };
  auto xbase = [&](int hl) {
    return ((size_t)b * LS * (kDkv ? hq : hk) + xhead(hl)) * D;
  };
  // lse / delta of the query rows: the resident head's (dq), the pass's
  // head's (dk/dv)
  auto qrows = [&](int hl) {
    return ((size_t)b * hq + (kDkv ? xhead(hl) : hr)) * S;
  };
  const int passes = kDkv ? rep : 1;

  // the streamed tiles that hold a visible pair: dq, the keys up to the
  // block's last query (causal); dk/dv, the queries from the block's
  // first key on
  int it0 = 0, it1 = (LS + BS - 1) / BS;
  if (causal) {
    if (kDkv)
      it0 = r0 / BS;
    else
      it1 = min(it1, (min(LS, r0 + BR) + BS - 1) / BS);
  }
  auto stream = [&](int hl, int it) {
    const size_t xb = xbase(hl);
    load_rows<D>(sStage, (kDkv ? q : k) + xb, LS, it * BS, BS, ldX, vec, tid,
                 NTHREADS);
    load_rows<D>(sStage + BS * D, (kDkv ? dout : v) + xb, LS, it * BS, BS,
                 ldX, vec, tid, NTHREADS);
    cp_async_commit();
  };
  float acc1[NO][4], acc2[NO][4];
#pragma unroll
  for (int o = 0; o < NO; ++o)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[o][e] = acc2[o][e] = 0.f;

  if (it0 < it1) {
    // the resident pair, raw, into the streamed hi / lo arrays, then
    // split into its own
    load_rows<D>(sX1h, R1, LR, r0, BR, ldR, vec, tid, NTHREADS);
    load_rows<D>(sX1h + BR * D, R2, LR, r0, BR, ldR, vec, tid, NTHREADS);
    cp_async_commit();
    stream(0, it0);
    cp_async_wait<1>();
    __syncthreads();
    split_tile<D>(sX1h, sR1h, sR1l, BR, LR - r0, tid, NTHREADS);
    split_tile<D>(sX1h + BR * D, sR2h, sR2l, BR, LR - r0, tid, NTHREADS);
  }

  // dq: this lane's query rows' lse (times log2 e) and delta (rows g
  // and g + 8)
  const float scale2 = scale * kLog2e;
  const int m0 = warp * 16;
  float rl[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
  if (!kDkv) {
    const size_t qr = qrows(0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = r0 + m0 + g + 8 * h;
      rl[h] = qpos < S ? lse[qr + qpos] * kLog2e : 0.f;
      rd[h] = qpos < S ? delta[qr + qpos] : 0.f;
    }
  }

  // the lane's ldmatrix row (r & 7 = lane & 7) and its swizzle; the lane's
  // columns g ^ swz of the streamed rows 2t and 2t + 1 (o * 8 + g ^ swz =
  // o * 8 ^ (g ^ swz): g < 8)
  const int lr = lane & 7, lj = lane >> 3, ls = swz(lr);
  const int gc0 = g ^ swz(2 * t), gc1 = g ^ swz(2 * t + 1);

  // this warp's rows of the outputs at the block's columns; with `add`,
  // added in fp32 to what this thread stored there before (every load
  // first: a load after a store to the same array waits for it)
  auto out_at = [&](int o, int e) {
    return rbase + (size_t)(r0 + m0 + g + 8 * (e >> 1)) * ldR + cb + o * 8 +
           2 * t + (e & 1);
  };
  auto store = [&](bool add) {
    const int row0 = r0 + m0 + g;
    if (add) {
#pragma unroll
      for (int o = 0; o < NO; ++o)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (row0 + 8 * (e >> 1) >= LR) continue;
          acc1[o][e] += out1[out_at(o, e)];
          if (kDkv) acc2[o][e] += out2[out_at(o, e)];
        }
    }
#pragma unroll
    for (int o = 0; o < NO; ++o)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (row0 + 8 * (e >> 1) >= LR) continue;
        out1[out_at(o, e)] = acc1[o][e];
        if (kDkv) out2[out_at(o, e)] = acc2[o][e];
      }
  };

  // dk/dv on the flat layout: each GQA head's pass is summed in the
  // registers and added to the outputs in fp32 (the tensor cores' sums
  // truncate, so one chain over every head's queries would drift)
  for (int hl = 0; hl < passes; ++hl) {
    const size_t qr = qrows(hl);
    for (int it = it0; it < it1; ++it) {
      const int s0 = it * BS;
      // the tile has arrived, and every warp is done with the last one
      cp_async_wait<0>();
      __syncthreads();
      split_tile<D>(sStage, sX1h, sX1l, BS, LS - s0, tid, NTHREADS);
      split_tile<D>(sStage + BS * D, sX2h, sX2l, BS, LS - s0, tid,
                    NTHREADS);
      if (kDkv)  // the streamed queries' lse (times log2 e) and delta
        for (int i = tid; i < BS; i += NTHREADS) {
          const int qpos = s0 + i;
          sL[i] = qpos < S ? lse[qr + qpos] * kLog2e : 0.f;
          sD[i] = qpos < S ? delta[qr + qpos] : 0.f;
        }
      __syncthreads();
      // the next tile, into the stage just split
      if (it + 1 < it1)
        stream(hl, it + 1);
      else if (hl + 1 < passes)
        stream(hl + 1, it0);

      // C1 = R1 . X1^T and C2 = R2 . X2^T, this warp's 16 rows x BS (the
      // two products interleaved; operands as in `scores`)
      float c1[NT][4], c2[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c1[n][e] = c2[n][e] = 0.f;
      const int aoff = (m0 + lr + 8 * (lj & 1)) * D;
#pragma unroll 2
      for (int kk = 0; kk < D / 8; ++kk) {
        const int acol = aoff + ((kk * 8 + 4 * (lj >> 1)) ^ ls);
        uint32_t a1h[4], a1l[4], a2h[4], a2l[4];
        ldsm_x4(a1h, sR1h + acol);
        ldsm_x4(a1l, sR1l + acol);
        ldsm_x4(a2h, sR2h + acol);
        ldsm_x4(a2l, sR2l + acol);
        const int bcol = lr * D + ((kk * 8 + 4 * (lj & 1)) ^ ls);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int boff = n * 8 * D + bcol;
          uint32_t b[4];
          ldsm_x4(b, (lj < 2 ? sX1h : sX1l) + boff);
          const uint32_t b1h[2] = {b[0], b[1]}, b1l[2] = {b[2], b[3]};
          mma3(c1[n], a1h, a1l, b1h, b1l);
          ldsm_x4(b, (lj < 2 ? sX2h : sX2l) + boff);
          const uint32_t b2h[2] = {b[0], b[1]}, b2l[2] = {b[2], b[3]};
          mma3(c2[n], a2h, a2l, b2h, b2l);
        }
      }

      // p = exp(s * scale - lse), as exp2 of log2-scaled terms (0 where
      // masked or past the streamed rows), ds = p * (dp - delta) * scale:
      // c1 becomes p, c2 ds. Only a tile across the causal diagonal or
      // past the streamed rows' end tests each element (warp-uniform
      // choice)
      auto softmax = [&](bool edge) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rrow = r0 + m0 + g + 8 * (e >> 1);  // resident row
            const int scol = n * 8 + 2 * t + (e & 1);     // streamed row
            const int qpos = kDkv ? s0 + scol : rrow;
            const int kpos = kDkv ? rrow : s0 + scol;
            const float l2 = kDkv ? sL[scol] : rl[e >> 1];
            const float d_ = kDkv ? sD[scol] : rd[e >> 1];
            float x = fmaf(c1[n][e], scale2, -l2);
            if (edge && ((causal && kpos > qpos) || s0 + scol >= LS))
              x = -INFINITY;
            const float pv = exp2_approx(x);
            c1[n][e] = pv;
            c2[n][e] = pv * (c2[n][e] - d_) * scale;
          }
      };
      const int rmin = r0 + m0;  // this warp's first resident row
      const bool edge =
          s0 + BS > LS ||
          (causal && (kDkv ? rmin + 15 > s0 : s0 + BS - 1 > rmin));
      if (edge)
        softmax(true);
      else
        softmax(false);

      // the products over the streamed rows (as in `product_tile`, the
      // two interleaved)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t ph[4], pl[4], dh[4], dl[4];
        split_fragment(c2[j], dh, dl);
        if (kDkv) split_fragment(c1[j], ph, pl);
        const int row0 = (j * 8 + 2 * t) * D, row1 = row0 + D;
#pragma unroll
        for (int o = 0; o < NO; ++o) {
          const int col = cb + o * 8;
          const int i0 = row0 + (col ^ gc0), i1 = row1 + (col ^ gc1);
          // dq += ds . k; dk += ds . q
          const uint32_t xh[2] = {__float_as_uint(sX1h[i0]),
                                  __float_as_uint(sX1h[i1])};
          const uint32_t xl[2] = {__float_as_uint(sX1l[i0]),
                                  __float_as_uint(sX1l[i1])};
          mma3(acc1[o], dh, dl, xh, xl);
          if (kDkv) {  // dv += p . dO
            const uint32_t vh[2] = {__float_as_uint(sX2h[i0]),
                                    __float_as_uint(sX2h[i1])};
            const uint32_t vl[2] = {__float_as_uint(sX2l[i0]),
                                    __float_as_uint(sX2l[i1])};
            mma3(acc2[o], ph, pl, vh, vl);
          }
        }
      }
    }
    if (hl + 1 < passes) {  // flat dk/dv: flush this head's sums
      store(hl > 0);
#pragma unroll
      for (int o = 0; o < NO; ++o)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc1[o][e] = acc2[o][e] = 0.f;
    }
  }
  store(passes > 1);
}

// B batch entries of H query and Hkv kv heads (head-major: B = BH, H =
// Hkv = 1)
template <bool kDkv, int D, typename Kernel>
int launch_bwd(Kernel kernel, const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               void* out1, void* out2, int B, int S, int Tk, int H, int Hkv,
               int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static_assert(smem <= ffflash::kMaxSmemBytes,
                "tiles do not fit shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = ((((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                     (uintptr_t)dout) & 15) == 0);
  const dim3 grid(((kDkv ? Tk : S) + Tiles<D>::BR - 1) / Tiles<D>::BR,
                  B * (kDkv ? Hkv : H), D / kCols<D>);
  kernel<<<grid, Tiles<D>::BR * 2, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)out1, (float*)out2, S,
      Tk, H, Hkv, causal, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace fftf32
