// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces flexflow_tpu/ops/pallas/flash_attention.py::_fwd_bshd (body
// _fwd_kernel_bshd, tile math _online_block): blockwise attention with an
// online softmax, so the S x T score matrix never reaches device memory.
//
// Contract (the TPU kernel's): q (B, S, H, D), k/v (B, T, Hkv, D), q head
// h reads kv head h / (H / Hkv). Scores are fp32 dots times `scale`; under
// `causal` key kpos is visible to query qpos when qpos >= kpos (top-left
// alignment) and a masked score is -1e30. (m, l, acc) stay in fp32;
// probabilities are rounded to v's dtype before the P.V product;
// out = acc / max(l, 1e-30) in q's dtype, and the compact logsumexp
// lse = m + log(max(l, 1e-30)), fp32 (B, H, S), is saved for the backward
// pass. (The TPU broadcasts lse over 128 lanes; that is its layout, not
// part of the contract.)
//
// Design: one block per (BT-row query tile, b * H + h). A loop over BT-row
// K/V tiles takes the place of the TPU's sequential grid axis and stops at
// the causal diagonal (the counterpart of _live). Rows and columns past S
// or T are masked here, so S and T need not be multiples of the tile.
// Head dims 64, 128 and 256 (the reference's flat route takes every
// multiple of 128); BT is 64 at each, the largest tile whose fp32 Q, K, V
// and score tiles fit a block's 227 KB (static_assert'ed).
//
// What bounds it on the card: operations. At the training shape (B 8,
// S = T 1024, H 16, D 128, causal) it does 4 * D ops per visible (query,
// key) pair against ~100 MB of q, k, v, out and lse: ~35 us at the bf16
// tensor-core peak against ~30 us of bytes. This first version runs the
// dots on CUDA cores from fp32 tiles in shared memory (4 x 4 register
// tiles per thread); wgmma and TMA are a later change.

#include "flash_common.cuh"

namespace {

using namespace ffflash;

template <typename T, int D, int BT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int Tk, int H, int Hkv,
                 int causal, float scale) {
  constexpr int LD = D + 1;    // padded row stride of D-wide tiles
  constexpr int LP = BT + 1;   // padded row stride of the score tile
  constexpr int RI = BT / 16;  // query rows per thread
  constexpr int CJ = BT / 16;  // score columns per thread
  constexpr int JD = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;            // (BT, LD)
  float* sK = sQ + BT * LD;    // (BT, LD)
  float* sV = sK + BT * LD;    // (BT, LD)
  float* sP = sV + BT * LD;    // (BT, LP) probabilities

  const int q0 = blockIdx.x * BT;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, g = h / (H / Hkv);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_rows<T, D>(sQ, LD, q, b, S, H, h, q0, BT);
  float m[RI], l[RI], acc[RI][JD];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < JD; ++jd) acc[i][jd] = 0.f;
  }

  // tiles wholly past the diagonal are never visited
  const int kend = causal ? min(Tk, q0 + BT) : Tk;
  for (int k0 = 0; k0 < kend; k0 += BT) {
    __syncthreads();  // the previous tile's P.V is done with sV and sP
    load_rows<T, D>(sK, LD, k, b, Tk, Hkv, g, k0, BT);
    load_rows<T, D>(sV, LD, v, b, Tk, Hkv, g, k0, BT);
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[RI], c[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = sQ[(ty * RI + i) * LD + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) c[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

    // online softmax: fold this tile into (m, l, acc), row by row
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q0 + ty * RI + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (causal && kpos > qpos) x = kNegInf;
        s[i][j] = x;
        if (kpos < Tk) mx = fmaxf(mx, x);
      }
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float p = kpos < Tk ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        // rounded to v's dtype before P.V, as the TPU kernel
        sP[(ty * RI + i) * LP + tx + 16 * j] = round_to<T>(p);
      }
      sum = row_sum16(sum);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < JD; ++jd) acc[i][jd] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
      float vv[JD];
#pragma unroll
      for (int jd = 0; jd < JD; ++jd) vv[jd] = sV[c * LD + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = sP[(ty * RI + i) * LP + c];
#pragma unroll
        for (int jd = 0; jd < JD; ++jd)
          acc[i][jd] = fmaf(p, vv[jd], acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qpos = q0 + ty * RI + i;
    if (qpos >= S) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jd = 0; jd < JD; ++jd)
      out[elem<D>(b, S, H, h, qpos, tx + 16 * jd)] =
          from_f<T>(acc[i][jd] / l_safe);
    if (tx == 0) lse[(size_t)bh * S + qpos] = m[i] + logf(l_safe);
  }
}

template <int D>
constexpr size_t fwd_smem(int bt) {
  return ((size_t)3 * bt * (D + 1) + (size_t)bt * (bt + 1)) * sizeof(float);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           void* lse, int B, int S, int Tk, int H, int Hkv, int causal,
           float scale, cudaStream_t stream) {
  constexpr int BT = fwd_smem<D>(64) <= kMaxSmemBytes ? 64 : 32;
  constexpr size_t smem = fwd_smem<D>(BT);
  static_assert(smem <= kMaxSmemBytes, "tile does not fit shared memory");
  auto kernel = flash_fwd_kernel<T, D, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BT - 1) / BT, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, S, Tk, H,
      Hkv, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it); lse is
// fp32 (B, H, S). Returns a cudaError_t: cudaErrorInvalidValue for shapes
// the kernel does not take (D other than 64, 128 or 256), otherwise the
// launch's cudaGetLastError().
int ff_flash_attention_fwd(const void* q, const void* k, const void* v,
                           void* out, void* lse, int B, int S, int T, int H,
                           int Hkv, int D, int causal, float scale,
                           int dtype, void* stream) {
  if (!shapes_ok(B, S, T, H, Hkv, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FF_FWD(TYPE, DIM)                                                  \
  return launch<TYPE, DIM>(q, k, v, out, lse, B, S, T, H, Hkv, causal,    \
                           scale, st)
  if (dtype == 0 && D == 64) FF_FWD(float, 64);
  if (dtype == 0 && D == 128) FF_FWD(float, 128);
  if (dtype == 0 && D == 256) FF_FWD(float, 256);
  if (dtype == 1 && D == 64) FF_FWD(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) FF_FWD(__nv_bfloat16, 128);
  if (dtype == 1 && D == 256) FF_FWD(__nv_bfloat16, 256);
#undef FF_FWD
  return (int)cudaErrorInvalidValue;
}

const char* ff_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
