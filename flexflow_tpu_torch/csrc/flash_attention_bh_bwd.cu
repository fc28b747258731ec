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
//   * bf16 at head dims 48, 64, 80, 96, 100, 128 and 256 (training at D
//     64, Phi-3-mini's 96 and OpenLLaMA-3B's 100; the ring's backward at
//     D 128) runs on the tensor cores: K2's bodies of flash_wgmma_bwd.cuh
//     (wgmma fed by TMA), instantiated here under the HeadMajor tag as
//     flash_dq_wgmma_kernel<HeadMajor, ...> and
//     flash_dkv_wgmma_kernel<HeadMajor, ...> on (B = BH, L, heads = 1, D)
//     tensor maps, lse and delta (BH, S) as K2's (B, H = 1, S); at D 48,
//     80 and 96 on tiles zero-padded to 64 / 128 columns by TMA, as the
//     forward (flash_attention_bh_fwd.cu). D 100 (rows of 200 bytes: no
//     TMA stride) fills the same 128-column tiles by the producer
//     warpgroup's cp.async copies, its value products at N 104.
//   * fp32 at 64, 128 and 256 (GPT-2 trains its attention in fp32, as the
//     reference computes it) runs on the tensor cores too, in 3xTF32 on
//     mma.sync (flash_bh_bwd_tf32_kernel below, over the body of
//     flash_tf32.cuh): each fp32 product as three tf32 products of hi /
//     lo halves, about fp32's accuracy. One tf32 product would round the
//     reference's fp32 numerics, so none is used alone.
//   * fp32 and bf16 at the widths not named run the CUDA-core bodies
//     below.
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
#include "flash_tf32.cuh"
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
// The body of flash_tf32.cuh on the head-major layout (K2's flat fp32
// backward runs the same body under its own __global__).
namespace tf32 {

// kDkv false: dq (out1). kDkv true: dk (out1) and dv (out2).
template <bool kDkv, int D>
__global__ void __launch_bounds__(fftf32::Tiles<D>::BR * 2, 1)
flash_bh_bwd_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ out1, float* __restrict__ out2,
                         int S, int Tk, int H, int Hkv, int causal,
                         float scale, int vec) {
  fftf32::bwd_body<kDkv, D, false>(q, k, v, dout, lse, delta, out1, out2, S,
                                   Tk, H, Hkv, causal, scale, vec);
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
// lse and delta fp32 (BH, S). bf16 at D 48, 64, 80, 96, 100, 128 and 256
// runs the wgmma bodies (D 100's tiles filled by cp.async), fp32 at D 64,
// 128 and 256 the 3xTF32 ones (mma.sync), every other case (fp32 at D 100
// too) the CUDA-core ones. Each returns a cudaError_t:
// cudaErrorInvalidValue for shapes the kernels do not take
// (bh_shapes_ok) or tensors the wgmma bodies cannot load (TMA: a base that
// is not 16-byte aligned; cp.async at D 100: not 8-byte aligned),
// otherwise the launch's cudaGetLastError().
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
  if (dtype == 1 && D == 48) FF_DQ_WG(48);
  if (dtype == 1 && D == 64) FF_DQ_WG(64);
  if (dtype == 1 && D == 80) FF_DQ_WG(80);
  if (dtype == 1 && D == 96) FF_DQ_WG(96);
  if (dtype == 1 && D == 100) FF_DQ_WG(100);
  if (dtype == 1 && D == 128) FF_DQ_WG(128);
  if (dtype == 1 && D == 256) FF_DQ_WG(256);
#undef FF_DQ_WG
#define FF_DQ_TF32(DIM)                                                    \
  return fftf32::launch_bwd<false, DIM>(                                   \
      tf32::flash_bh_bwd_tf32_kernel<false, DIM>, q, k, v, dout, lse, delta, \
      dq, nullptr, BH, S, T, 1, 1, causal, scale, st)
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
  if (dtype == 1 && D == 48) FF_DKV_WG(48);
  if (dtype == 1 && D == 64) FF_DKV_WG(64);
  if (dtype == 1 && D == 80) FF_DKV_WG(80);
  if (dtype == 1 && D == 96) FF_DKV_WG(96);
  if (dtype == 1 && D == 100) FF_DKV_WG(100);
  if (dtype == 1 && D == 128) FF_DKV_WG(128);
  if (dtype == 1 && D == 256) FF_DKV_WG(256);
#undef FF_DKV_WG
#define FF_DKV_TF32(DIM)                                                   \
  return fftf32::launch_bwd<true, DIM>(                                    \
      tf32::flash_bh_bwd_tf32_kernel<true, DIM>, q, k, v, dout, lse, delta, \
      dk, dv, BH, S, T, 1, 1, causal, scale, st)
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
