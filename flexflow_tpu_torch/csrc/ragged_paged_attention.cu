// Ragged paged attention for Hopper (sm_90a), written by hand.
//
// Replaces flexflow_tpu/paged/attention.py::_ragged_kernel (the Pallas
// body launched by ragged_flash_attention): one call attends every batch
// entry's live query rows over its committed prefix plus the visible part
// of its in-flight window, reading K/V straight out of the page pool
// through the entry's page table. Decode rows, chunked-prefill pieces and
// padded entries share the one launch.
//
// Contract (the same as the TPU kernel's):
//   q (B, S, H, D); kc/vc (N, P, Hkv, D); pt (B, maxp) int32;
//   pos, qlens (B,) int32; anc (B, S, S) bool; out (B, S, H, D).
//   Cache row kpos is visible to window row t of entry b when
//   kpos < pos[b], or 0 <= kpos - pos[b] < qlens[b] and
//   anc[b, t, kpos - pos[b]]. Scores are fp32 dots times `scale`; the
//   online softmax keeps (m, l, acc) in fp32; probabilities are rounded to
//   the value dtype before the P.V product; out = acc / max(l, 1e-30) in
//   q's dtype, and rows t >= qlens[b] are exact zeros.
//
// What bounds it on the card: the bytes of K/V pages it reads. A decode
// row does 4 flops per K/V element pair it loads (two dots of D), far
// below the ~295 flops/byte at which an H100 turns compute-bound, so the
// design is about reading each needed page once and no other page:
//   * one thread block per (batch entry, kv head): the block reads each
//     of its pages once and serves all rep = H / Hkv query heads of the
//     GQA group from it (no repeated K/V, no gathered copy of the
//     sequence, no (B, S, L) mask in device memory);
//   * the block walks its page table in order and stops at the horizon
//     pos + q_len - 1, so pages past it are never read, and a padded
//     entry (q_len == 0) reads nothing and writes zeros;
//   * K/V are staged through shared memory in sub-tiles of up to 64 rows,
//     so any page size fits; the K tile is padded by one column so the
//     score loop's column reads are free of bank conflicts.
// Known limit for a later change: B x Hkv blocks (32 at Llama-3-8B decode
// with 4 slots) fill a quarter of the 132 SMs, and the inner products run
// on CUDA cores (no wgmma, TMA or split-K yet).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTileRows = 64;
constexpr size_t kMaxSmemBytes = 232448;  // 227 KB a block may use
constexpr float kNegInf = -1e30f;         // running-max floor (as the TPU kernel)

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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_floats(int rmax, int D, int kt) {
  // q rows + acc rows, K tile (padded) + V tile, scores, (m, l, corr)
  return 2 * (size_t)rmax * D + (size_t)kt * (2 * D + 1) +
         (size_t)rmax * kt + 3 * (size_t)rmax;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ kc,
                              const T* __restrict__ vc,
                              const int32_t* __restrict__ pt,
                              const int32_t* __restrict__ pos,
                              const int32_t* __restrict__ qlens,
                              const uint8_t* __restrict__ anc,
                              T* __restrict__ out, int S, int H, int Hkv,
                              int D, int P, int maxp, int kt, float scale) {
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int rep = H / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const int qlen = qlens[b];
  const int p0 = pos[b];
  const int rmax = rep * S;
  // live rows of this group: r = hl * qlen + t for q head g * rep + hl
  // and window row t < qlen; rows t >= qlen are never computed
  const int R = rep * qlen;

  extern __shared__ float smem[];
  float* sq = smem;                  // (rmax, D) query rows, fp32
  float* sacc = sq + rmax * D;       // (rmax, D) running P.V sums
  float* sk = sacc + rmax * D;       // (kt, D + 1) K tile, padded
  float* sv = sk + kt * (D + 1);     // (kt, D) V tile
  float* sp = sv + kt * D;           // (rmax, kt) scores -> probabilities
  float* sm = sp + rmax * kt;        // (rmax) running max
  float* sl = sm + rmax;             // (rmax) running denominator
  float* scorr = sl + rmax;          // (rmax) this tile's rescale factor

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int hl = r / qlen, t = r - hl * qlen;
    sq[i] = to_f(q[((size_t)(b * S + t) * H + g * rep + hl) * D + d]);
    sacc[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    sm[r] = kNegInf;
    sl[r] = 0.f;
  }
  __syncthreads();

  // cache rows at or past the horizon are visible to no row
  const int horizon = p0 + qlen;
  const int npages = qlen > 0 ? min(maxp, (horizon - 1) / P + 1) : 0;
  for (int j = 0; j < npages; ++j) {
    const int page = pt[b * maxp + j];
    for (int c0 = 0; c0 < P; c0 += kt) {
      const int base = j * P + c0;  // cache row of tile column 0
      if (base >= horizon) break;
      const int n = min(kt, min(P - c0, horizon - base));
      for (int i = tid; i < n * D; i += kThreads) {
        const int c = i / D, d = i - c * D;
        const size_t off = ((size_t)(page * P + c0 + c) * Hkv + g) * D + d;
        sk[c * (D + 1) + d] = to_f(kc[off]);
        sv[c * D + d] = to_f(vc[off]);
      }
      __syncthreads();

      // scores; an invisible column scores -inf and adds nothing below
      for (int i = tid; i < R * n; i += kThreads) {
        const int r = i / n, c = i - r * n;
        const int t = r % qlen;
        const int kpos = base + c;
        const int rel = kpos - p0;
        const bool vis =
            kpos < p0 ||
            (rel >= 0 && rel < qlen && anc[((size_t)b * S + t) * S + rel]);
        float s = -INFINITY;
        if (vis) {
          const float* qr = sq + r * D;
          const float* kr = sk + c * (D + 1);
          float acc = 0.f;
          for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
          s = acc * scale;
        }
        sp[r * kt + c] = s;
      }
      __syncthreads();

      // online softmax update, one warp per row
      for (int r = warp; r < R; r += nwarps) {
        float* pr = sp + r * kt;
        float mx = kNegInf;
        for (int c = lane; c < n; c += 32) mx = fmaxf(mx, pr[c]);
        mx = warp_max(mx);
        const float m_prev = sm[r];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int c = lane; c < n; c += 32) {
          const float s = pr[c];
          const float p = s == -INFINITY ? 0.f : expf(s - m_new);
          sum += p;
          // rounded to the value dtype before P.V, as the TPU kernel
          pr[c] = to_f(from_f<T>(p));
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          scorr[r] = corr;
          sl[r] = sl[r] * corr + sum;
          sm[r] = m_new;
        }
      }
      __syncthreads();

      for (int i = tid; i < R * D; i += kThreads) {
        const int r = i / D, d = i - r * D;
        const float* pr = sp + r * kt;
        float a = sacc[i] * scorr[r];
        for (int c = 0; c < n; ++c) a = fmaf(pr[c], sv[c * D + d], a);
        sacc[i] = a;
      }
      __syncthreads();
    }
  }

  // every row of the group is written: live rows normalized, rows past
  // q_len (and every row of a padded entry) exact zeros
  for (int i = tid; i < rmax * D; i += kThreads) {
    const int d = i % D;
    const int rest = i / D;
    const int hl = rest % rep;
    const int t = rest / rep;
    float val = 0.f;
    if (t < qlen) {
      const int r = hl * qlen + t;
      val = sacc[r * D + d] / fmaxf(sl[r], 1e-30f);
    }
    out[((size_t)(b * S + t) * H + g * rep + hl) * D + d] = from_f<T>(val);
  }
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const void* pt,
           const void* pos, const void* qlens, const void* anc, void* out,
           int B, int S, int H, int Hkv, int D, int P, int maxp, int kt,
           size_t smem, float scale, cudaStream_t stream) {
  auto kernel = ragged_paged_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(B, Hkv), kThreads, smem, stream>>>(
      (const T*)q, (const T*)kc, (const T*)vc, (const int32_t*)pt,
      (const int32_t*)pos, (const int32_t*)qlens, (const uint8_t*)anc,
      (T*)out, S, H, Hkv, D, P, maxp, kt, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it). Returns a
// cudaError_t: cudaErrorInvalidValue for shapes the kernel does not take,
// otherwise the launch's cudaGetLastError().
int ff_ragged_paged_attention(const void* q, const void* kc, const void* vc,
                              const void* pt, const void* pos,
                              const void* qlens, const void* anc, void* out,
                              int B, int S, int H, int Hkv, int D, int P,
                              int maxp, float scale, int dtype,
                              void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || P <= 0 ||
      maxp <= 0)
    return (int)cudaErrorInvalidValue;
  const int rmax = (H / Hkv) * S;
  int kt = P < kMaxTileRows ? P : kMaxTileRows;
  while (kt > 8 && smem_floats(rmax, D, kt) * sizeof(float) > kMaxSmemBytes)
    kt = (kt + 1) / 2;
  const size_t smem = smem_floats(rmax, D, kt) * sizeof(float);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, kc, vc, pt, pos, qlens, anc, out, B, S, H, Hkv,
                         D, P, maxp, kt, smem, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kc, vc, pt, pos, qlens, anc, out, B, S,
                                 H, Hkv, D, P, maxp, kt, smem, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* ff_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
