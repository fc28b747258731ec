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
// Design: one block per (64-row query tile, b * H + h). A loop over 64-row
// K/V tiles takes the place of the TPU's sequential grid axis and stops at
// the causal diagonal (the counterpart of _live). Rows and columns past S
// or T are masked here, so S and T need not be multiples of the tile.
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int Tk, int H, int Hkv,
                 int causal, float scale) {
  constexpr int LD = D + 1;    // padded row stride of D-wide tiles
  constexpr int LP = kBK + 1;  // padded row stride of the score tile
  constexpr int JD = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;             // (kBQ, LD)
  float* sK = sQ + kBQ * LD;    // (kBK, LD)
  float* sV = sK + kBK * LD;    // (kBK, LD)
  float* sP = sV + kBK * LD;    // (kBQ, LP) probabilities

  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, g = h / (H / Hkv);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_rows<T, D>(sQ, LD, q, b, S, H, h, q0, kBQ);
  float m[4], l[4], acc[4][JD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < JD; ++jd) acc[i][jd] = 0.f;
  }

  // tiles wholly past the diagonal are never visited
  const int kend = causal ? min(Tk, q0 + kBQ) : Tk;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile's P.V is done with sV and sP
    load_rows<T, D>(sK, LD, k, b, Tk, Hkv, g, k0, kBK);
    load_rows<T, D>(sV, LD, v, b, Tk, Hkv, g, k0, kBK);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

    // online softmax: fold this tile into (m, l, acc), row by row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
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
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float p = kpos < Tk ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        // rounded to v's dtype before P.V, as the TPU kernel
        sP[(ty * 4 + i) * LP + tx + 16 * j] = round_to<T>(p);
      }
      sum = row_sum16(sum);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < JD; ++jd) acc[i][jd] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float vv[JD];
#pragma unroll
      for (int jd = 0; jd < JD; ++jd) vv[jd] = sV[c * LD + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(ty * 4 + i) * LP + c];
#pragma unroll
        for (int jd = 0; jd < JD; ++jd)
          acc[i][jd] = fmaf(p, vv[jd], acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jd = 0; jd < JD; ++jd)
      out[elem<D>(b, S, H, h, qpos, tx + 16 * jd)] =
          from_f<T>(acc[i][jd] / l_safe);
    if (tx == 0) lse[(size_t)bh * S + qpos] = m[i] + logf(l_safe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           void* lse, int B, int S, int Tk, int H, int Hkv, int causal,
           float scale, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem =
      ((size_t)kBQ * LD + 2 * (size_t)kBK * LD + (size_t)kBQ * (kBK + 1)) *
      sizeof(float);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, S, Tk, H,
      Hkv, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it); lse is
// fp32 (B, H, S). Returns a cudaError_t: cudaErrorInvalidValue for shapes
// the kernel does not take (D other than 64 or 128), otherwise the
// launch's cudaGetLastError().
int ff_flash_attention_fwd(const void* q, const void* k, const void* v,
                           void* out, void* lse, int B, int S, int T, int H,
                           int Hkv, int D, int causal, float scale,
                           int dtype, void* stream) {
  if (!shapes_ok(B, S, T, H, Hkv, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, out, lse, B, S, T, H, Hkv, causal,
                             scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, out, lse, B, S, T, H, Hkv, causal,
                              scale, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, lse, B, S, T, H, Hkv,
                                     causal, scale, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, lse, B, S, T, H, Hkv,
                                      causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* ff_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
