// Head-major flash-attention backward (kernel K4's backward, also the
// per-block backward of the reference's ring attention) for Hopper
// (sm_90a), written by hand: one kernel for dq and one for dk/dv.
//
// Replaces flexflow_tpu/ops/pallas/flash_attention.py::_bwd (bodies
// _dq_kernel and _dkv_kernel, tile math _dq_block and _dkv_block) on
// head-major (BH, S, D) q/dO and (BH, T, D) k/v, kv heads already repeated
// by the caller. Both recompute the scores tile by tile from an lse the
// CALLER gives (the forward's own, or the ring's final one), so no S x T
// matrix reaches device memory:
//   p  = exp(s - lse)            s = fp32 q.k * scale, masked -1e30
//   dp = dO . v                  fp32
//   ds = p * (dp - delta) * scale, delta = sum_d dO * O (also given by
//                                the caller, fp32, as the reference
//                                computes it outside its kernels)
//   dq = sum over keys of  ds (rounded to k's dtype)  * k
//   dk = sum over queries of ds (rounded to q's dtype) * q
//   dv = sum over queries of p (rounded to dO's dtype) * dO
// with every sum in fp32 and each result written once in its input's
// dtype. lse and delta are fp32 (BH, S). Layout, padded widths and tiles
// as the forward (flash_bh_common.cuh).
//
// Three designs.
//   * bf16 at head dims 64, 128 and 256 (training at D 64; the ring's
//     backward at D 128) runs on the tensor cores: K2's bodies of
//     flash_wgmma_bwd.cuh (wgmma fed by TMA), instantiated here under the
//     HeadMajor tag as flash_dq_wgmma_kernel<HeadMajor, ...> and
//     flash_dkv_wgmma_kernel<HeadMajor, ...> on (B = BH, L, heads = 1, D)
//     tensor maps, lse and delta (BH, S) as K2's (B, H = 1, S).
//   * fp32 at 64, 128 and 256 (GPT-2 trains its attention in fp32, as the
//     reference computes it) runs on the tensor cores too, in 3xTF32 on
//     mma.sync (flash_bh_bwd_tf32_kernel below): each fp32 product as
//     three tf32 products of hi / lo halves, about fp32's accuracy. One
//     tf32 product would round the reference's fp32 numerics, so none is
//     used alone.
//   * fp32 and bf16 at the other widths run the CUDA-core bodies below.
//
// CUDA-core bodies. dq: one block per (query tile, bh), looping over the
// live key tiles (up to the causal diagonal). dk/dv: one block per (key
// tile, bh), looping over the live query tiles (from the diagonal on).
// Nothing carries between blocks and nothing is accumulated with atomics
// (in any design).
//
// What bounds it on the card: operations, 6 * D per visible pair for dq
// and 8 * D for dk/dv; at GPT-2 XL training (B 8, S = T 1024, H 25, D 64,
// causal) about 0.041 and 0.054 ms at the bf16 tensor-core peak, and in
// fp32 3 x those operations at the tf32 peak (0.244 and 0.326 ms) for the
// 3xTF32 body, whose byte bound (fp32 in and out) is 0.0787 / 0.0944 ms.

#include "flash_bh_common.cuh"
#include "flash_wgmma_bwd.cuh"

namespace {

using namespace ffflash;

template <typename T, int DP, int BT>
__global__ void __launch_bounds__(kThreads)
flash_bh_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int S, int Tk, int D, int causal, float scale) {
  constexpr int LD = DP + 1;
  constexpr int LP = BT + 1;
  constexpr int RI = BT / 16;
  constexpr int CJ = BT / 16;
  constexpr int JD = DP / 16;
  extern __shared__ float smem[];
  float* sQ = smem;             // (BT, LD)
  float* sO = sQ + BT * LD;     // (BT, LD) dO
  float* sK = sO + BT * LD;     // (BT, LD)
  float* sV = sK + BT * LD;     // (BT, LD)
  float* sS = sV + BT * LD;     // (BT, LP) ds

  const int q0 = blockIdx.x * BT;
  const size_t bh = blockIdx.y;
  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<T, DP>(sQ, LD, q + bh * S * D, S, D, q0, BT);
  load_tile<T, DP>(sO, LD, dout + bh * S * D, S, D, q0, BT);
  float rl[RI], rd[RI], acc[RI][JD];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qpos = q0 + ty * RI + i;
    rl[i] = qpos < S ? lse[bh * S + qpos] : 0.f;
    rd[i] = qpos < S ? delta[bh * S + qpos] : 0.f;
#pragma unroll
    for (int jd = 0; jd < JD; ++jd) acc[i][jd] = 0.f;
  }

  const int kend = causal ? min(Tk, q0 + BT) : Tk;
  for (int k0 = 0; k0 < kend; k0 += BT) {
    __syncthreads();
    load_tile<T, DP>(sK, LD, kb, Tk, D, k0, BT);
    load_tile<T, DP>(sV, LD, vb, Tk, D, k0, BT);
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float a[RI], o[RI], kk[CJ], vv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        a[i] = sQ[(ty * RI + i) * LD + d];
        o[i] = sO[(ty * RI + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        kk[j] = sK[(tx + 16 * j) * LD + d];
        vv[j] = sV[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(o[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q0 + ty * RI + i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (causal && kpos > qpos) x = kNegInf;
        const float p = kpos < Tk ? expf(x - rl[i]) : 0.f;
        const float ds = p * (dp[i][j] - rd[i]) * scale;
        sS[(ty * RI + i) * LP + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
      float kk[JD];
#pragma unroll
      for (int jd = 0; jd < JD; ++jd) kk[jd] = sK[c * LD + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float ds = sS[(ty * RI + i) * LP + c];
#pragma unroll
        for (int jd = 0; jd < JD; ++jd)
          acc[i][jd] = fmaf(ds, kk[jd], acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qpos = q0 + ty * RI + i;
    if (qpos >= S) continue;
#pragma unroll
    for (int jd = 0; jd < JD; ++jd) {
      const int col = tx + 16 * jd;
      if (col < D) dq[(bh * S + qpos) * D + col] = from_f<T>(acc[i][jd]);
    }
  }
}

template <typename T, int DP, int BT>
__global__ void __launch_bounds__(kThreads)
flash_bh_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int S, int Tk, int D, int causal,
                    float scale) {
  constexpr int LD = DP + 1;
  constexpr int LQ = BT + 1;
  constexpr int RK = BT / 16;  // keys per thread
  constexpr int CQ = BT / 16;  // queries per thread
  constexpr int JD = DP / 16;
  extern __shared__ float smem[];
  float* sK = smem;             // (BT, LD)
  float* sV = sK + BT * LD;     // (BT, LD)
  float* sQ = sV + BT * LD;     // (BT, LD)
  float* sO = sQ + BT * LD;     // (BT, LD) dO
  float* sP = sO + BT * LD;     // (BT, LQ) p, transposed
  float* sS = sP + BT * LQ;     // (BT, LQ) ds, transposed
  float* sL = sS + BT * LQ;     // (BT) lse of the query tile
  float* sD = sL + BT;          // (BT) delta of the query tile

  const int k0 = blockIdx.x * BT;
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * S * D;
  const T* ob = dout + bh * S * D;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int nq = (S + BT - 1) / BT;
  // the first query tile with a row at or past this tile's first key
  const int iq0 = causal ? k0 / BT : 0;

  load_tile<T, DP>(sK, LD, k + bh * Tk * D, Tk, D, k0, BT);
  load_tile<T, DP>(sV, LD, v + bh * Tk * D, Tk, D, k0, BT);
  float dka[RK][JD], dva[RK][JD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int jd = 0; jd < JD; ++jd) dka[i][jd] = dva[i][jd] = 0.f;

  for (int iq = iq0; iq < nq; ++iq) {
    const int q0 = iq * BT;
    __syncthreads();  // the previous tile's sums are done with sQ..sD
    load_tile<T, DP>(sQ, LD, qb, S, D, q0, BT);
    load_tile<T, DP>(sO, LD, ob, S, D, q0, BT);
    for (int r = threadIdx.x; r < BT; r += kThreads) {
      const int qpos = q0 + r;
      sL[r] = qpos < S ? lse[bh * S + qpos] : 0.f;
      sD[r] = qpos < S ? delta[bh * S + qpos] : 0.f;
    }
    __syncthreads();

    // transposed tiles: thread rows are keys, thread columns queries
    float s[RK][CQ], dp[RK][CQ];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < CQ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float kk[RK], vv[RK], a[CQ], o[CQ];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        kk[i] = sK[(ty * RK + i) * LD + d];
        vv[i] = sV[(ty * RK + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CQ; ++j) {
        a[j] = sQ[(tx + 16 * j) * LD + d];
        o[j] = sO[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          s[i][j] = fmaf(kk[i], a[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], o[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const int kpos = k0 + ty * RK + i;
#pragma unroll
      for (int j = 0; j < CQ; ++j) {
        const int r = tx + 16 * j;
        const int qpos = q0 + r;
        float x = s[i][j] * scale;
        if (causal && kpos > qpos) x = kNegInf;
        const float p = qpos < S ? expf(x - sL[r]) : 0.f;
        const float ds = p * (dp[i][j] - sD[r]) * scale;
        sP[(ty * RK + i) * LQ + r] = round_to<T>(p);
        sS[(ty * RK + i) * LQ + r] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < BT; ++r) {
      float o[JD], a[JD];
#pragma unroll
      for (int jd = 0; jd < JD; ++jd) {
        o[jd] = sO[r * LD + tx + 16 * jd];
        a[jd] = sQ[r * LD + tx + 16 * jd];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const float p = sP[(ty * RK + i) * LQ + r];
        const float ds = sS[(ty * RK + i) * LQ + r];
#pragma unroll
        for (int jd = 0; jd < JD; ++jd) {
          dva[i][jd] = fmaf(p, o[jd], dva[i][jd]);
          dka[i][jd] = fmaf(ds, a[jd], dka[i][jd]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kpos = k0 + ty * RK + i;
    if (kpos >= Tk) continue;
#pragma unroll
    for (int jd = 0; jd < JD; ++jd) {
      const int col = tx + 16 * jd;
      if (col >= D) continue;
      const size_t off = (bh * Tk + kpos) * D + col;
      dk[off] = from_f<T>(dka[i][jd]);
      dv[off] = from_f<T>(dva[i][jd]);
    }
  }
}

// ---- fp32 at D 64, 128 and 256: 3xTF32 on the tensor cores ---------------
//
// One body for both kernels. A block holds BR rows of the RESIDENT pair
// (dq: q and dO; dk/dv: k and v), 16 a warp, and streams BS-row tiles of
// the other pair (dq: k and v; dk/dv: q and dO). Per streamed tile a warp
// computes its 16 x BS scores C1 = R1 . X1^T and C2 = R2 . X2^T, turns
// them into p and ds in registers, and adds the products over the tile's
// rows to its output tiles (dq += ds . k; dv += p . dO, dk += ds . q), so
// dk/dv's tiles are S^T-shaped (keys by queries) and no operand is ever
// transposed in memory.
//
// Every product is 3xTF32 on mma.sync m16n8k8 (tf32 in, fp32 accumulate):
// an fp32 x is hi = tf32(x) and lo = tf32(x - hi), rounded to nearest
// with ties away from zero (cvt.rna's rounding), and a.b is a_lo.b_hi +
// a_hi.b_lo + a_hi.b_hi, the small terms first. That is about fp32's own
// accuracy (a dropped lo.lo and lo's rounding, ~2^-22 of each product),
// where one tf32 product would keep ~2^-11.
//
// What bounds it (variants timed at GPT-2 XL's shape, D 64): no single
// part; the products' mma, the fragment reads, the hi / lo split and the
// softmax each take a share, overlapping little at 8 warps an SM. Every
// warp reads each streamed tile's hi and lo fragments for its own 16
// rows (wgmma, which would share them across a warpgroup, takes tf32
// only K-major, so dq, dk and dv would need transposed copies of every
// tile). Each operand is
// split into hi / lo once and kept split in shared memory: the resident
// rows when the block starts, each streamed tile as it arrives (its
// 16-byte cp.async copies land in a raw stage, which the next tile's
// copies reuse while this one is multiplied). Only ds and p, which are
// born in registers, are split there.
//
// Shared memory holds fp32 rows of D columns, swizzled: element (r, c) at
// r * D + (c ^ swz(r)), swz(r) = ((r >> 1) & 3) << 3 | (r & 1) << 2, so
// both fragment reads are free of bank conflicts: rows r0 + 0..7 at four
// columns (ldmatrix: a row's 16 bytes are one fp32 quad) and rows
// r0 + 2t + e (t = 0..3) at eight columns (the operand whose k runs over
// the streamed rows, read 32 bits a lane). The products over the streamed
// rows take ds (or p) straight from the score accumulators: a C fragment
// holds columns 2t, 2t + 1 where an A fragment wants k = t, t + 4, so
// k = t is read as row 2t and k = t + 4 as row 2t + 1 of the B operand.
namespace tf32 {

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
__device__ __forceinline__ int swz(int r) {
  return ((r >> 1) & 3) << 3 | (r & 1) << 2;
}

// resident rows a block (16 a warp), streamed rows a tile (each the
// fastest of the widths timed at GPT-2 XL's shape, D 64); at every width
// 2 BR = 4 BS, so the resident pair's raw copies fit the streamed hi / lo
// arrays, where they wait to be split
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
// output columns a block: D up to 128; D 256 in two column blocks (each
// recomputes the scores), so a warp's output tiles fit its registers
template <int D>
constexpr int kCols = D < 128 ? D : 128;

template <int D>
constexpr size_t smem_bytes() {
  // the resident pair's hi and lo, one raw stage of the streamed pair,
  // its hi and lo, the streamed rows' lse and delta (dk/dv)
  return ((size_t)4 * Tiles<D>::BR * D + (size_t)6 * Tiles<D>::BS * D +
          (size_t)2 * Tiles<D>::BS) * sizeof(float);
}

// rows row0 .. row0 + rows - 1 of a (L, D) fp32 slab into a swizzled tile:
// 16-byte cp.async copies, or with `vec` false (a base not 16-byte
// aligned) four scalar loads a quad; rows at or past L are left as they
// are (the split passes zero them)
template <int D>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int L, int row0, int rows, bool vec,
                                          int tid, int nthreads) {
  for (int i = tid; i < rows * (D / 4); i += nthreads) {
    const int r = i / (D / 4), c = (i - r * (D / 4)) * 4;
    float* d = dst + r * D + (c ^ swz(r));
    const float* sp = src + (size_t)(row0 + r) * D + c;
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

// kDkv false: dq (out1). kDkv true: dk (out1) and dv (out2).
template <bool kDkv, int D>
__global__ void __launch_bounds__(Tiles<D>::BR * 2, 1)
flash_bh_bwd_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ out1, float* __restrict__ out2,
                         int S, int Tk, int causal, float scale, int vec) {
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
  const size_t bh = blockIdx.y;
  const int cb = D > DC ? blockIdx.z * DC : 0;  // the block's output columns
  // dq: the heavy (late) query tiles first; dk/dv: the heavy key tiles
  // come first in order
  const int r0 =
      (kDkv ? blockIdx.x : gridDim.x - 1 - blockIdx.x) * BR;
  const int LR = kDkv ? Tk : S;  // resident rows
  const int LS = kDkv ? S : Tk;  // streamed rows
  const float* R1 = (kDkv ? k : q) + bh * LR * D;
  const float* R2 = (kDkv ? v : dout) + bh * LR * D;
  const float* X1 = (kDkv ? q : k) + bh * LS * D;
  const float* X2 = (kDkv ? dout : v) + bh * LS * D;
  const float* lse_b = lse + bh * S;
  const float* delta_b = delta + bh * S;

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
  auto stream = [&](int it) {
    load_rows<D>(sStage, X1, LS, it * BS, BS, vec, tid, NTHREADS);
    load_rows<D>(sStage + BS * D, X2, LS, it * BS, BS, vec, tid, NTHREADS);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  float acc1[NO][4], acc2[NO][4];
#pragma unroll
  for (int o = 0; o < NO; ++o)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[o][e] = acc2[o][e] = 0.f;

  if (it0 < it1) {
    // the resident pair, raw, into the streamed hi / lo arrays, then
    // split into its own
    load_rows<D>(sX1h, R1, LR, r0, BR, vec, tid, NTHREADS);
    load_rows<D>(sX1h + BR * D, R2, LR, r0, BR, vec, tid, NTHREADS);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    stream(it0);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    split_tile<D>(sX1h, sR1h, sR1l, BR, LR - r0, tid, NTHREADS);
    split_tile<D>(sX1h + BR * D, sR2h, sR2l, BR, LR - r0, tid, NTHREADS);
  }

  // dq: this lane's query rows' lse (times log2 e) and delta (rows g
  // and g + 8)
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale2 = scale * kLog2e;
  const int m0 = warp * 16;
  float rl[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
  if (!kDkv) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = r0 + m0 + g + 8 * h;
      rl[h] = qpos < S ? lse_b[qpos] * kLog2e : 0.f;
      rd[h] = qpos < S ? delta_b[qpos] : 0.f;
    }
  }

  // the lane's ldmatrix row (r & 7 = lane & 7) and its swizzle; the lane's
  // columns g ^ swz of the streamed rows 2t and 2t + 1 (o * 8 + g ^ swz =
  // o * 8 ^ (g ^ swz): g < 8)
  const int lr = lane & 7, lj = lane >> 3, ls = swz(lr);
  const int gc0 = g ^ swz(2 * t), gc1 = g ^ swz(2 * t + 1);

  for (int it = it0; it < it1; ++it) {
    const int s0 = it * BS;
    // the tile has arrived, and every warp is done with the last one
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    split_tile<D>(sStage, sX1h, sX1l, BS, LS - s0, tid, NTHREADS);
    split_tile<D>(sStage + BS * D, sX2h, sX2l, BS, LS - s0, tid, NTHREADS);
    if (kDkv)  // the streamed queries' lse (times log2 e) and delta
      for (int i = tid; i < BS; i += NTHREADS) {
        const int qpos = s0 + i;
        sL[i] = qpos < S ? lse_b[qpos] * kLog2e : 0.f;
        sD[i] = qpos < S ? delta_b[qpos] : 0.f;
      }
    __syncthreads();
    if (it + 1 < it1) stream(it + 1);  // into the stage just split

    // C1 = R1 . X1^T and C2 = R2 . X2^T, this warp's 16 rows x BS
    float c1[NT][4], c2[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c1[n][e] = c2[n][e] = 0.f;
    // A: matrices {rows 0..7, k 0..3}, {8..15, 0..3}, {0..7, 4..7},
    // {8..15, 4..7}; B: {hi, k 0..3}, {hi, 4..7}, {lo, 0..3}, {lo, 4..7}
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
    // c1 becomes p, c2 ds. Only a tile across the causal diagonal or past
    // the streamed rows' end tests each element (warp-uniform choice)
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

    // the products over the streamed rows: k-step j of 8 rows, A from the
    // score accumulators (k = t is row 2t, k = t + 4 row 2t + 1), B rows
    // 2t and 2t + 1 of the streamed tile at this block's output columns
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ph[4], pl[4], dh[4], dl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = (e & 1) * 2 + (e >> 1);  // a0..a3 = c0, c2, c1, c3
        split(c2[j][c], dh[e], dl[e]);
        if (kDkv) split(c1[j][c], ph[e], pl[e]);
      }
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

  // this warp's rows of the outputs at the block's columns
#pragma unroll
  for (int o = 0; o < NO; ++o)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + m0 + g + 8 * (e >> 1);
      if (row >= LR) continue;
      const size_t off = (bh * LR + row) * D + cb + o * 8 + 2 * t + (e & 1);
      out1[off] = acc1[o][e];
      if (kDkv) out2[off] = acc2[o][e];
    }
}

template <bool kDkv, int D>
int launch_tf32(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* out1, void* out2, int BH, int S, int Tk, int causal,
                float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static_assert(smem <= kMaxSmemBytes, "tiles do not fit shared memory");
  auto kernel = flash_bh_bwd_tf32_kernel<kDkv, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = ((((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                     (uintptr_t)dout) & 15) == 0);
  const dim3 grid(((kDkv ? Tk : S) + Tiles<D>::BR - 1) / Tiles<D>::BR, BH,
                  D / kCols<D>);
  kernel<<<grid, Tiles<D>::BR * 2, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)out1, (float*)out2, S,
      Tk, causal, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace tf32

template <int DP>
constexpr size_t dq_smem(int bt) {
  return ((size_t)4 * bt * (DP + 1) + (size_t)bt * (bt + 1)) * sizeof(float);
}

template <int DP>
constexpr size_t dkv_smem(int bt) {
  return ((size_t)4 * bt * (DP + 1) + (size_t)2 * bt * (bt + 1) +
          (size_t)2 * bt) * sizeof(float);
}

template <typename T, int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int BH, int S,
              int Tk, int D, int causal, float scale, cudaStream_t stream) {
  constexpr int BT = dq_smem<DP>(64) <= kMaxSmemBytes ? 64 : 32;
  constexpr size_t smem = dq_smem<DP>(BT);
  static_assert(smem <= kMaxSmemBytes, "tile does not fit shared memory");
  auto kernel = flash_bh_dq_kernel<T, DP, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BT - 1) / BT, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, S, Tk, D, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               void* dk, void* dv, int BH, int S, int Tk, int D, int causal,
               float scale, cudaStream_t stream) {
  constexpr int BT = dkv_smem<DP>(64) <= kMaxSmemBytes ? 64 : 32;
  constexpr size_t smem = dkv_smem<DP>(BT);
  static_assert(smem <= kMaxSmemBytes, "tile does not fit shared memory");
  auto kernel = flash_bh_dkv_kernel<T, DP, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tk + BT - 1) / BT, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, S, Tk, D,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dq, int BH, int S, int Tk, int D, int causal,
                float scale, cudaStream_t st) {
#define FF_DQ(DP)                                                        \
  return launch_dq<T, DP>(q, k, v, dout, lse, delta, dq, BH, S, Tk, D,  \
                          causal, scale, st)
  if (D <= 32) FF_DQ(32);
  if (D <= 64) FF_DQ(64);
  if (D <= 96) FF_DQ(96);
  if (D <= 128) FF_DQ(128);
  if (D <= 192) FF_DQ(192);
  FF_DQ(256);
#undef FF_DQ
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int BH, int S, int Tk, int D,
                 int causal, float scale, cudaStream_t st) {
#define FF_DKV(DP)                                                          \
  return launch_dkv<T, DP>(q, k, v, dout, lse, delta, dk, dv, BH, S, Tk, D, \
                           causal, scale, st)
  if (D <= 32) FF_DKV(32);
  if (D <= 64) FF_DKV(64);
  if (D <= 96) FF_DKV(96);
  if (D <= 128) FF_DKV(128);
  if (D <= 192) FF_DKV(192);
  FF_DKV(256);
#undef FF_DKV
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO, dq, dk, dv share it);
// lse and delta fp32 (BH, S). D 64, 128 and 256 run the tensor-core
// bodies (bf16: wgmma; fp32: 3xTF32 mma.sync), every other case the
// CUDA-core ones. Each returns a
// cudaError_t: cudaErrorInvalidValue for shapes the kernels do not take
// (bh_shapes_ok) or tensors TMA cannot map, otherwise the launch's
// cudaGetLastError().
int ff_flash_attention_bh_dq(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, int BH, int S,
                             int T, int D, int causal, float scale,
                             int dtype, void* stream) {
  if (!bh_shapes_ok(BH, S, T, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FF_DQ_WG(DIM)                                                      \
  return ffwg::launch_dq_wgmma<ffwg::HeadMajor, DIM>(                      \
      q, k, v, dout, lse, delta, dq, BH, S, T, 1, 1, causal, scale, st)
  if (dtype == 1 && D == 64) FF_DQ_WG(64);
  if (dtype == 1 && D == 128) FF_DQ_WG(128);
  if (dtype == 1 && D == 256) FF_DQ_WG(256);
#undef FF_DQ_WG
#define FF_DQ_TF32(DIM)                                                 \
  return tf32::launch_tf32<false, DIM>(q, k, v, dout, lse, delta, dq,   \
                                       nullptr, BH, S, T, causal, scale, \
                                       st)
  if (dtype == 0 && D == 64) FF_DQ_TF32(64);
  if (dtype == 0 && D == 128) FF_DQ_TF32(128);
  if (dtype == 0 && D == 256) FF_DQ_TF32(256);
#undef FF_DQ_TF32
  if (dtype == 0)
    return dispatch_dq<float>(q, k, v, dout, lse, delta, dq, BH, S, T, D,
                              causal, scale, st);
  if (dtype == 1)
    return dispatch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, BH, S,
                                      T, D, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

int ff_flash_attention_bh_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int BH,
                              int S, int T, int D, int causal, float scale,
                              int dtype, void* stream) {
  if (!bh_shapes_ok(BH, S, T, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FF_DKV_WG(DIM)                                                     \
  return ffwg::launch_dkv_wgmma<ffwg::HeadMajor, DIM>(                     \
      q, k, v, dout, lse, delta, dk, dv, BH, S, T, 1, 1, causal, scale, st)
  if (dtype == 1 && D == 64) FF_DKV_WG(64);
  if (dtype == 1 && D == 128) FF_DKV_WG(128);
  if (dtype == 1 && D == 256) FF_DKV_WG(256);
#undef FF_DKV_WG
#define FF_DKV_TF32(DIM)                                                 \
  return tf32::launch_tf32<true, DIM>(q, k, v, dout, lse, delta, dk, dv, \
                                      BH, S, T, causal, scale, st)
  if (dtype == 0 && D == 64) FF_DKV_TF32(64);
  if (dtype == 0 && D == 128) FF_DKV_TF32(128);
  if (dtype == 0 && D == 256) FF_DKV_TF32(256);
#undef FF_DKV_TF32
  if (dtype == 0)
    return dispatch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, BH, S, T,
                               D, causal, scale, st);
  if (dtype == 1)
    return dispatch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv,
                                       BH, S, T, D, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* ff_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
