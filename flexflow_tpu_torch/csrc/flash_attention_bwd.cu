// Flash-attention backward for Hopper (sm_90a), written by hand: two
// kernels, one for dq and one for dk/dv.
//
// Replaces flexflow_tpu/ops/pallas/flash_attention.py::_bwd_bshd (bodies
// _dq_kernel_bshd and _dkv_kernel_bshd, tile math _dq_block and
// _dkv_block). Both recompute the scores tile by tile from the forward's
// saved fp32 logsumexp, so no S x T matrix reaches device memory:
//   p  = exp(s - lse)            s = fp32 q.k * scale, masked -1e30
//   dp = dO . v                  fp32
//   ds = p * (dp - delta) * scale, delta = sum_d dO * O (computed by the
//                                wrapper, fp32, as the reference does
//                                outside its kernels)
//   dq = sum over keys of  ds (rounded to k's dtype)  * k
//   dk = sum over queries of ds (rounded to q's dtype) * q
//   dv = sum over queries of p (rounded to dO's dtype) * dO
// with every sum in fp32 and each result written once in its input's
// dtype. Layouts as the forward (flash_common.cuh); lse and delta are
// fp32 (B, H, S).
//
// Three bodies. bf16 at head dims 64, 128 and 256 runs on the tensor
// cores: wgmma fed by TMA, the bodies of flash_wgmma_bwd.cuh, which K4's
// backward instantiates too (flash_dq_wgmma_kernel<FlatLayout, ...> and
// flash_dkv_wgmma_kernel<FlatLayout, ...> here). Every product runs on
// wgmma; ds and p go from the accumulator registers, rounded to bf16,
// straight into the A operand of the next product. fp32 at 128 and 256
// runs on the tensor cores too, in 3xTF32 on mma.sync: the body of
// flash_tf32.cuh that K4's fp32 backward runs, here on the flat layout
// (flash_bwd_tf32_kernel<kDkv, D>; each fp32 product as three tf32
// products of hi / lo halves, about fp32's accuracy; dk/dv sums each
// query head of the GQA group in registers and adds it to the outputs in
// fp32, no atomics). fp32 at 64 (reached by no lowering:
// the route sends D 64 to K4), 384 and 512, and bf16 at 384 and 512, run
// the CUDA-core bodies (flash_dq_kernel, flash_dkv_kernel), exact fp32
// products.
//
// CUDA-core bodies: tiles are BT x BT, the largest of 64, 32 and 16 whose
// four fp32 D-wide tiles fit a block's 227 KB (static_assert'ed): 64 at
// head dim 64, 32 at 384, 16 at 512.
// dq: one block per (BT-row query tile, b * H + h), looping over the live
// K/V tiles (up to the causal diagonal).
// dk/dv: one block per (BT-row key tile, b * Hkv + g), looping over every
// (query head of the GQA group) x (live query tile), the counterpart of
// the TPU grid (B * Hkv, nk, rep * nq). The group's rep query heads are
// summed inside the block, so dk and dv come out at Hkv heads with no
// atomics: the result is the same from run to run.
//
// What bounds it on the card: operations (6 * D per visible pair for dq,
// 8 * D for dk/dv at the training shape, ~52 us and ~70 us at the bf16
// tensor-core peak; in fp32 3 x those operations at the tf32 peak, 0.313
// and 0.417 ms, for the 3xTF32 body). The CUDA-core bodies run the dots
// from fp32 shared-memory tiles; the tensor-core bodies are built for
// that bound.

#include "flash_common.cuh"
#include "flash_tf32.cuh"
#include "flash_wgmma_bwd.cuh"

namespace {

using namespace ffflash;

template <typename T, int D, int BT>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int S,
                int Tk, int H, int Hkv, int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int LP = BT + 1;
  constexpr int RI = BT / 16;  // query rows per thread
  constexpr int CJ = BT / 16;  // score columns per thread
  constexpr int JD = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;             // (BT, LD)
  float* sO = sQ + BT * LD;     // (BT, LD) dO
  float* sK = sO + BT * LD;     // (BT, LD)
  float* sV = sK + BT * LD;     // (BT, LD)
  float* sS = sV + BT * LD;     // (BT, LP) ds

  const int q0 = blockIdx.x * BT;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, g = h / (H / Hkv);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_rows<T, D>(sQ, LD, q, b, S, H, h, q0, BT);
  load_rows<T, D>(sO, LD, dout, b, S, H, h, q0, BT);
  float rl[RI], rd[RI], acc[RI][JD];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qpos = q0 + ty * RI + i;
    rl[i] = qpos < S ? lse[(size_t)bh * S + qpos] : 0.f;
    rd[i] = qpos < S ? delta[(size_t)bh * S + qpos] : 0.f;
#pragma unroll
    for (int jd = 0; jd < JD; ++jd) acc[i][jd] = 0.f;
  }

  const int kend = causal ? min(Tk, q0 + BT) : Tk;
  for (int k0 = 0; k0 < kend; k0 += BT) {
    __syncthreads();
    load_rows<T, D>(sK, LD, k, b, Tk, Hkv, g, k0, BT);
    load_rows<T, D>(sV, LD, v, b, Tk, Hkv, g, k0, BT);
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
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
    for (int jd = 0; jd < JD; ++jd)
      dq[elem<D>(b, S, H, h, qpos, tx + 16 * jd)] = from_f<T>(acc[i][jd]);
  }
}

template <typename T, int D, int BT>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int S, int Tk, int H, int Hkv,
                 int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int LQ = BT + 1;
  constexpr int RK = BT / 16;  // keys per thread
  constexpr int CQ = BT / 16;  // queries per thread
  constexpr int JD = D / 16;
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
  const int bg = blockIdx.y;
  const int b = bg / Hkv, g = bg % Hkv;
  const int rep = H / Hkv;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int nq = (S + BT - 1) / BT;
  // the first query tile with a row at or past this tile's first key
  const int iq0 = causal ? k0 / BT : 0;

  load_rows<T, D>(sK, LD, k, b, Tk, Hkv, g, k0, BT);
  load_rows<T, D>(sV, LD, v, b, Tk, Hkv, g, k0, BT);
  float dka[RK][JD], dva[RK][JD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int jd = 0; jd < JD; ++jd) dka[i][jd] = dva[i][jd] = 0.f;

  for (int hl = 0; hl < rep; ++hl) {
    const int h = g * rep + hl;
    const size_t row_base = ((size_t)b * H + h) * S;
    for (int iq = iq0; iq < nq; ++iq) {
      const int q0 = iq * BT;
      __syncthreads();  // the previous tile's sums are done with sQ..sS
      load_rows<T, D>(sQ, LD, q, b, S, H, h, q0, BT);
      load_rows<T, D>(sO, LD, dout, b, S, H, h, q0, BT);
      for (int r = threadIdx.x; r < BT; r += kThreads) {
        const int qpos = q0 + r;
        sL[r] = qpos < S ? lse[row_base + qpos] : 0.f;
        sD[r] = qpos < S ? delta[row_base + qpos] : 0.f;
      }
      __syncthreads();

      // transposed tiles: thread rows are keys, thread columns queries
      float s[RK][CQ], dp[RK][CQ];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CQ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
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
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kpos = k0 + ty * RK + i;
    if (kpos >= Tk) continue;
#pragma unroll
    for (int jd = 0; jd < JD; ++jd) {
      const size_t off = elem<D>(b, Tk, Hkv, g, kpos, tx + 16 * jd);
      dk[off] = from_f<T>(dka[i][jd]);
      dv[off] = from_f<T>(dva[i][jd]);
    }
  }
}

template <int D>
constexpr size_t dq_smem(int bt) {
  return ((size_t)4 * bt * (D + 1) + (size_t)bt * (bt + 1)) * sizeof(float);
}

template <int D>
constexpr size_t dkv_smem(int bt) {
  return ((size_t)4 * bt * (D + 1) + (size_t)2 * bt * (bt + 1) +
          (size_t)2 * bt) * sizeof(float);
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int S,
              int Tk, int H, int Hkv, int causal, float scale,
              cudaStream_t stream) {
  constexpr int BT = dq_smem<D>(64) <= kMaxSmemBytes   ? 64
                     : dq_smem<D>(32) <= kMaxSmemBytes ? 32
                                                        : 16;
  constexpr size_t smem = dq_smem<D>(BT);
  static_assert(smem <= kMaxSmemBytes, "tile does not fit shared memory");
  auto kernel = flash_dq_kernel<T, D, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BT - 1) / BT, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, S, Tk, H, Hkv, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               void* dk, void* dv, int B, int S, int Tk, int H, int Hkv,
               int causal, float scale, cudaStream_t stream) {
  constexpr int BT = dkv_smem<D>(64) <= kMaxSmemBytes   ? 64
                     : dkv_smem<D>(32) <= kMaxSmemBytes ? 32
                                                        : 16;
  constexpr size_t smem = dkv_smem<D>(BT);
  static_assert(smem <= kMaxSmemBytes, "tile does not fit shared memory");
  auto kernel = flash_dkv_kernel<T, D, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tk + BT - 1) / BT, B * Hkv);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, S, Tk, H, Hkv,
      causal, scale);
  return (int)cudaGetLastError();
}

// ---- fp32 at D 128 and 256: 3xTF32 on the tensor cores -------------------
namespace tf32 {

// kDkv false: dq (out1). kDkv true: dk (out1) and dv (out2), at Hkv heads.
template <bool kDkv, int D>
__global__ void __launch_bounds__(fftf32::Tiles<D>::BR * 2, 1)
flash_bwd_tf32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ out1, float* __restrict__ out2,
                      int S, int Tk, int H, int Hkv, int causal, float scale,
                      int vec) {
  fftf32::bwd_body<kDkv, D, true>(q, k, v, dout, lse, delta, out1, out2, S,
                                  Tk, H, Hkv, causal, scale, vec);
}

}  // namespace tf32

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO, dq, dk, dv share it);
// lse and delta fp32 (B, H, S). bf16 at D 64, 128 and 256 runs the wgmma
// bodies, fp32 at 128 and 256 the 3xTF32 ones, every other case the
// CUDA-core ones. Each returns
// a cudaError_t: cudaErrorInvalidValue for shapes the kernels do not take
// or tensors TMA cannot map, otherwise the launch's cudaGetLastError().
int ff_flash_attention_dq(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, int B, int S, int T,
                          int H, int Hkv, int D, int causal, float scale,
                          int dtype, void* stream) {
  if (!shapes_ok(B, S, T, H, Hkv, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FF_DQ(TYPE, DIM)                                                   \
  return launch_dq<TYPE, DIM>(q, k, v, dout, lse, delta, dq, B, S, T, H,  \
                              Hkv, causal, scale, st)
  if (dtype == 0 && D == 64) FF_DQ(float, 64);
  if (dtype == 0 && D == 384) FF_DQ(float, 384);
  if (dtype == 0 && D == 512) FF_DQ(float, 512);
  if (dtype == 1 && D == 384) FF_DQ(__nv_bfloat16, 384);
  if (dtype == 1 && D == 512) FF_DQ(__nv_bfloat16, 512);
#undef FF_DQ
#define FF_DQ_WG(DIM)                                                      \
  return ffwg::launch_dq_wgmma<ffwg::FlatLayout, DIM>(                     \
      q, k, v, dout, lse, delta, dq, B, S, T, H, Hkv, causal, scale, st)
  if (dtype == 1 && D == 64) FF_DQ_WG(64);
  if (dtype == 1 && D == 128) FF_DQ_WG(128);
  if (dtype == 1 && D == 256) FF_DQ_WG(256);
#undef FF_DQ_WG
#define FF_DQ_TF32(DIM)                                                  \
  return fftf32::launch_bwd<false, DIM>(                                 \
      tf32::flash_bwd_tf32_kernel<false, DIM>, q, k, v, dout, lse, delta, \
      dq, nullptr, B, S, T, H, Hkv, causal, scale, st)
  if (dtype == 0 && D == 128) FF_DQ_TF32(128);
  if (dtype == 0 && D == 256) FF_DQ_TF32(256);
#undef FF_DQ_TF32
  return (int)cudaErrorInvalidValue;
}

int ff_flash_attention_dkv(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int B,
                           int S, int T, int H, int Hkv, int D, int causal,
                           float scale, int dtype, void* stream) {
  if (!shapes_ok(B, S, T, H, Hkv, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FF_DKV(TYPE, DIM)                                                  \
  return launch_dkv<TYPE, DIM>(q, k, v, dout, lse, delta, dk, dv, B, S, T, \
                               H, Hkv, causal, scale, st)
  if (dtype == 0 && D == 64) FF_DKV(float, 64);
  if (dtype == 0 && D == 384) FF_DKV(float, 384);
  if (dtype == 0 && D == 512) FF_DKV(float, 512);
  if (dtype == 1 && D == 384) FF_DKV(__nv_bfloat16, 384);
  if (dtype == 1 && D == 512) FF_DKV(__nv_bfloat16, 512);
#undef FF_DKV
#define FF_DKV_WG(DIM)                                                     \
  return ffwg::launch_dkv_wgmma<ffwg::FlatLayout, DIM>(                    \
      q, k, v, dout, lse, delta, dk, dv, B, S, T, H, Hkv, causal, scale,   \
      st)
  if (dtype == 1 && D == 64) FF_DKV_WG(64);
  if (dtype == 1 && D == 128) FF_DKV_WG(128);
  if (dtype == 1 && D == 256) FF_DKV_WG(256);
#undef FF_DKV_WG
#define FF_DKV_TF32(DIM)                                                 \
  return fftf32::launch_bwd<true, DIM>(                                  \
      tf32::flash_bwd_tf32_kernel<true, DIM>, q, k, v, dout, lse, delta, \
      dk, dv, B, S, T, H, Hkv, causal, scale, st)
  if (dtype == 0 && D == 128) FF_DKV_TF32(128);
  if (dtype == 0 && D == 256) FF_DKV_TF32(256);
#undef FF_DKV_TF32
  return (int)cudaErrorInvalidValue;
}

const char* ff_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
