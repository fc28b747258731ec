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
// dq: one block per (64-row query tile, b * H + h), looping over the live
// K/V tiles (up to the causal diagonal).
// dk/dv: one block per (64-row key tile, b * Hkv + g), looping over every
// (query head of the GQA group) x (live query tile), the counterpart of
// the TPU grid (B * Hkv, nk, rep * nq). The group's rep query heads are
// summed inside the block, so dk and dv come out at Hkv heads with no
// atomics: the result is the same from run to run.
//
// What bounds it on the card: operations (6 * D per visible pair for dq,
// 8 * D for dk/dv at the training shape, ~52 us and ~70 us at the bf16
// tensor-core peak). This first version runs the dots on CUDA cores from
// fp32 shared-memory tiles; wgmma and TMA are a later change.

#include "flash_common.cuh"

namespace {

using namespace ffflash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int S,
                int Tk, int H, int Hkv, int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int LP = kBK + 1;
  constexpr int JD = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;              // (kBQ, LD)
  float* sO = sQ + kBQ * LD;     // (kBQ, LD) dO
  float* sK = sO + kBQ * LD;     // (kBK, LD)
  float* sV = sK + kBK * LD;     // (kBK, LD)
  float* sS = sV + kBK * LD;     // (kBQ, LP) ds

  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, g = h / (H / Hkv);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_rows<T, D>(sQ, LD, q, b, S, H, h, q0, kBQ);
  load_rows<T, D>(sO, LD, dout, b, S, H, h, q0, kBQ);
  float rl[4], rd[4], acc[4][JD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    rl[i] = qpos < S ? lse[(size_t)bh * S + qpos] : 0.f;
    rd[i] = qpos < S ? delta[(size_t)bh * S + qpos] : 0.f;
#pragma unroll
    for (int jd = 0; jd < JD; ++jd) acc[i][jd] = 0.f;
  }

  const int kend = causal ? min(Tk, q0 + kBQ) : Tk;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();
    load_rows<T, D>(sK, LD, k, b, Tk, Hkv, g, k0, kBK);
    load_rows<T, D>(sV, LD, v, b, Tk, Hkv, g, k0, kBK);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], o[4], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sQ[(ty * 4 + i) * LD + d];
        o[i] = sO[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = sK[(tx + 16 * j) * LD + d];
        vv[j] = sV[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(o[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (causal && kpos > qpos) x = kNegInf;
        const float p = kpos < Tk ? expf(x - rl[i]) : 0.f;
        const float ds = p * (dp[i][j] - rd[i]) * scale;
        sS[(ty * 4 + i) * LP + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float kk[JD];
#pragma unroll
      for (int jd = 0; jd < JD; ++jd) kk[jd] = sK[c * LD + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = sS[(ty * 4 + i) * LP + c];
#pragma unroll
        for (int jd = 0; jd < JD; ++jd)
          acc[i][jd] = fmaf(ds, kk[jd], acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) continue;
#pragma unroll
    for (int jd = 0; jd < JD; ++jd)
      dq[elem<D>(b, S, H, h, qpos, tx + 16 * jd)] = from_f<T>(acc[i][jd]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int S, int Tk, int H, int Hkv,
                 int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int LQ = kBQ + 1;
  constexpr int JD = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;              // (kBK, LD)
  float* sV = sK + kBK * LD;     // (kBK, LD)
  float* sQ = sV + kBK * LD;     // (kBQ, LD)
  float* sO = sQ + kBQ * LD;     // (kBQ, LD) dO
  float* sP = sO + kBQ * LD;     // (kBK, LQ) p, transposed
  float* sS = sP + kBK * LQ;     // (kBK, LQ) ds, transposed
  float* sL = sS + kBK * LQ;     // (kBQ) lse of the query tile
  float* sD = sL + kBQ;          // (kBQ) delta of the query tile

  const int k0 = blockIdx.x * kBK;
  const int bg = blockIdx.y;
  const int b = bg / Hkv, g = bg % Hkv;
  const int rep = H / Hkv;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int nq = (S + kBQ - 1) / kBQ;
  // the first query tile with a row at or past this tile's first key
  const int iq0 = causal ? k0 / kBQ : 0;

  load_rows<T, D>(sK, LD, k, b, Tk, Hkv, g, k0, kBK);
  load_rows<T, D>(sV, LD, v, b, Tk, Hkv, g, k0, kBK);
  float dka[4][JD], dva[4][JD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jd = 0; jd < JD; ++jd) dka[i][jd] = dva[i][jd] = 0.f;

  for (int hl = 0; hl < rep; ++hl) {
    const int h = g * rep + hl;
    const size_t row_base = ((size_t)b * H + h) * S;
    for (int iq = iq0; iq < nq; ++iq) {
      const int q0 = iq * kBQ;
      __syncthreads();  // the previous tile's sums are done with sQ..sS
      load_rows<T, D>(sQ, LD, q, b, S, H, h, q0, kBQ);
      load_rows<T, D>(sO, LD, dout, b, S, H, h, q0, kBQ);
      for (int r = threadIdx.x; r < kBQ; r += kThreads) {
        const int qpos = q0 + r;
        sL[r] = qpos < S ? lse[row_base + qpos] : 0.f;
        sD[r] = qpos < S ? delta[row_base + qpos] : 0.f;
      }
      __syncthreads();

      // transposed tiles: thread rows are keys, thread columns queries
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kk[4], vv[4], a[4], o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kk[i] = sK[(ty * 4 + i) * LD + d];
          vv[i] = sV[(ty * 4 + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[j] = sQ[(tx + 16 * j) * LD + d];
          o[j] = sO[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kk[i], a[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], o[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const int qpos = q0 + r;
          float x = s[i][j] * scale;
          if (causal && kpos > qpos) x = kNegInf;
          const float p = qpos < S ? expf(x - sL[r]) : 0.f;
          const float ds = p * (dp[i][j] - sD[r]) * scale;
          sP[(ty * 4 + i) * LQ + r] = round_to<T>(p);
          sS[(ty * 4 + i) * LQ + r] = round_to<T>(ds);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < kBQ; ++r) {
        float o[JD], a[JD];
#pragma unroll
        for (int jd = 0; jd < JD; ++jd) {
          o[jd] = sO[r * LD + tx + 16 * jd];
          a[jd] = sQ[r * LD + tx + 16 * jd];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = sP[(ty * 4 + i) * LQ + r];
          const float ds = sS[(ty * 4 + i) * LQ + r];
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
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    if (kpos >= Tk) continue;
#pragma unroll
    for (int jd = 0; jd < JD; ++jd) {
      const size_t off = elem<D>(b, Tk, Hkv, g, kpos, tx + 16 * jd);
      dk[off] = from_f<T>(dka[i][jd]);
      dv[off] = from_f<T>(dva[i][jd]);
    }
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int S,
              int Tk, int H, int Hkv, int causal, float scale,
              cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem = (2 * (size_t)kBQ * LD + 2 * (size_t)kBK * LD +
                       (size_t)kBQ * (kBK + 1)) * sizeof(float);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  auto kernel = flash_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
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
  constexpr int LD = D + 1;
  const size_t smem = (2 * (size_t)kBK * LD + 2 * (size_t)kBQ * LD +
                       2 * (size_t)kBK * (kBQ + 1) + 2 * (size_t)kBQ) *
                      sizeof(float);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  auto kernel = flash_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tk + kBK - 1) / kBK, B * Hkv);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, S, Tk, H, Hkv,
      causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO, dq, dk, dv share it);
// lse and delta fp32 (B, H, S). Each returns a cudaError_t:
// cudaErrorInvalidValue for shapes the kernels do not take, otherwise
// the launch's cudaGetLastError().
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
  if (dtype == 0 && D == 128) FF_DQ(float, 128);
  if (dtype == 1 && D == 64) FF_DQ(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) FF_DQ(__nv_bfloat16, 128);
#undef FF_DQ
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
  if (dtype == 0 && D == 128) FF_DKV(float, 128);
  if (dtype == 1 && D == 64) FF_DKV(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) FF_DKV(__nv_bfloat16, 128);
#undef FF_DKV
  return (int)cudaErrorInvalidValue;
}

const char* ff_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
