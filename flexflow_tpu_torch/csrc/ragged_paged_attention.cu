// Ragged paged attention for Hopper (sm_90a), written by hand.
//
// Replaces flexflow_tpu/paged/attention.py::_ragged_kernel (the Pallas
// body launched by ragged_flash_attention, fp pools) and its int8 body
// _ragged_kernel_quant (:293, the ks_ref/vs_ref branch of :235-243): one
// call attends every batch entry's live query rows over its committed
// prefix plus the visible part of its in-flight window, reading K/V
// straight out of the page pool through the entry's page table. Decode
// rows, chunked-prefill pieces and padded entries share the one launch.
//
// Contract (the same as the TPU kernel's):
//   q (B, S, H, D); kc/vc (N, P, Hkv, D); pt (B, maxp) int32;
//   pos, qlens (B,) int32; anc (B, S, S) bool; out (B, S, H, D);
//   for an int8 pool also ks/vs (N, Hkv) fp32, one scale per (page, kv
//   head). Cache row kpos is visible to window row t of entry b when
//   kpos < pos[b], or 0 <= kpos - pos[b] < qlens[b] and
//   anc[b, t, kpos - pos[b]]. Scores are fp32 dots times `scale`; the
//   online softmax keeps (m, l, acc) in fp32; out = acc / max(l, 1e-30)
//   in q's dtype, and rows t >= qlens[b] are exact zeros.
//   * fp pool: K/V are converted to q's dtype on load (a pool of another
//     float dtype than q, e.g. kv_dtype="bf16" under an fp32 model, as
//     the TPU kernel's k.astype(q.dtype)), then to fp32; probabilities
//     are rounded to q's dtype before the P.V product.
//   * int8 pool: K/V are staged as int8 x scale[pt[b, j], g] in fp32 (q
//     upcast to fp32), and p is NOT rounded before P.V (v is fp32 after
//     dequant), as the TPU kernel's quantized branch.
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
//   * K/V are staged through shared memory in sub-tiles of up to 64 rows
//     (a sub-tile never crosses a page, so it has one scale per kv head),
//     so any page size fits; the K tile is padded by one column so the
//     score loop's column reads are free of bank conflicts;
//   * an int8 pool is read as 16-byte vectors (16 elements a thread):
//     half the bytes of a bf16 pool for the same rows.
// Known limit for a later change: B x Hkv blocks (32 at Llama-3-8B decode
// with 4 slots) fill a quarter of the 132 SMs, and the inner products run
// on CUDA cores (no wgmma, TMA or split-K yet).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

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

// One K/V element staged for the fp-pool kernel: converted to q's type,
// then to fp32 (the identity when the pool is of q's type, or fp32 from
// bf16/fp16).
template <typename TQ, typename TKV>
__device__ __forceinline__ float stage(TKV x) {
  return to_f(from_f<TQ>(to_f(x)));
}

// TQ: q and out; TKV: the pool's element (float, bf16, half, or int8
// with kQuant and the ks/vs scale arrays).
template <typename TQ, typename TKV, bool kQuant>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(const TQ* __restrict__ q,
                              const TKV* __restrict__ kc,
                              const TKV* __restrict__ vc,
                              const float* __restrict__ ks,
                              const float* __restrict__ vs,
                              const int32_t* __restrict__ pt,
                              const int32_t* __restrict__ pos,
                              const int32_t* __restrict__ qlens,
                              const uint8_t* __restrict__ anc,
                              TQ* __restrict__ out, int S, int H, int Hkv,
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
      const size_t row0 = ((size_t)(page * P + c0) * Hkv + g) * D;
      const size_t stride = (size_t)Hkv * D;  // between cache rows
      if constexpr (kQuant) {
        const float k_s = ks[(size_t)page * Hkv + g];
        const float v_s = vs[(size_t)page * Hkv + g];
        if ((D & 15) == 0) {
          // 16 int8 elements a thread, one 16-byte load per K and V
          const int nvec = D >> 4;
          for (int i = tid; i < n * nvec; i += kThreads) {
            const int c = i / nvec, d0 = (i - c * nvec) << 4;
            const size_t off = row0 + c * stride + d0;
            const int4 kw = *reinterpret_cast<const int4*>(kc + off);
            const int4 vw = *reinterpret_cast<const int4*>(vc + off);
            const int8_t* kb = reinterpret_cast<const int8_t*>(&kw);
            const int8_t* vb = reinterpret_cast<const int8_t*>(&vw);
#pragma unroll
            for (int e = 0; e < 16; ++e) {
              sk[c * (D + 1) + d0 + e] = (float)kb[e] * k_s;
              sv[c * D + d0 + e] = (float)vb[e] * v_s;
            }
          }
        } else {
          for (int i = tid; i < n * D; i += kThreads) {
            const int c = i / D, d = i - c * D;
            const size_t off = row0 + c * stride + d;
            sk[c * (D + 1) + d] = (float)kc[off] * k_s;
            sv[c * D + d] = (float)vc[off] * v_s;
          }
        }
      } else {
        for (int i = tid; i < n * D; i += kThreads) {
          const int c = i / D, d = i - c * D;
          const size_t off = row0 + c * stride + d;
          sk[c * (D + 1) + d] = stage<TQ>(kc[off]);
          sv[c * D + d] = stage<TQ>(vc[off]);
        }
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
          // fp pool: rounded to the value dtype (q's) before P.V, as the
          // TPU kernel; int8 pool: v is fp32 after dequant, p unrounded
          pr[c] = kQuant ? p : to_f(from_f<TQ>(p));
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
    out[((size_t)(b * S + t) * H + g * rep + hl) * D + d] = from_f<TQ>(val);
  }
}

template <typename TQ, typename TKV, bool kQuant>
int launch(const void* q, const void* kc, const void* vc, const float* ks,
           const float* vs, const void* pt, const void* pos,
           const void* qlens, const void* anc, void* out, int B, int S,
           int H, int Hkv, int D, int P, int maxp, float scale,
           cudaStream_t stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || P <= 0 ||
      maxp <= 0)
    return (int)cudaErrorInvalidValue;
  const int rmax = (H / Hkv) * S;
  int kt = P < kMaxTileRows ? P : kMaxTileRows;
  while (kt > 8 && smem_floats(rmax, D, kt) * sizeof(float) > kMaxSmemBytes)
    kt = (kt + 1) / 2;
  const size_t smem = smem_floats(rmax, D, kt) * sizeof(float);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  auto kernel = ragged_paged_attention_kernel<TQ, TKV, kQuant>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(B, Hkv), kThreads, smem, stream>>>(
      (const TQ*)q, (const TKV*)kc, (const TKV*)vc, ks, vs,
      (const int32_t*)pt, (const int32_t*)pos, (const int32_t*)qlens,
      (const uint8_t*)anc, (TQ*)out, S, H, Hkv, D, P, maxp, kt, scale);
  return (int)cudaGetLastError();
}

template <typename TQ>
int launch_fp(const void* q, const void* kc, const void* vc, const void* pt,
              const void* pos, const void* qlens, const void* anc,
              void* out, int B, int S, int H, int Hkv, int D, int P,
              int maxp, float scale, int kv_dtype, cudaStream_t st) {
  if (kv_dtype == 0)
    return launch<TQ, float, false>(q, kc, vc, nullptr, nullptr, pt, pos,
                                    qlens, anc, out, B, S, H, Hkv, D, P,
                                    maxp, scale, st);
  if (kv_dtype == 1)
    return launch<TQ, __nv_bfloat16, false>(q, kc, vc, nullptr, nullptr, pt,
                                            pos, qlens, anc, out, B, S, H,
                                            Hkv, D, P, maxp, scale, st);
  if (kv_dtype == 2)
    return launch<TQ, __half, false>(q, kc, vc, nullptr, nullptr, pt, pos,
                                     qlens, anc, out, B, S, H, Hkv, D, P,
                                     maxp, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q_dtype: 0 = float32, 1 = bfloat16 (q and out); kv_dtype: 0 = float32,
// 1 = bfloat16, 2 = float16 (the pools). Returns a cudaError_t:
// cudaErrorInvalidValue for shapes or dtypes the kernel does not take,
// otherwise the launch's cudaGetLastError().
int ff_ragged_paged_attention(const void* q, const void* kc, const void* vc,
                              const void* pt, const void* pos,
                              const void* qlens, const void* anc, void* out,
                              int B, int S, int H, int Hkv, int D, int P,
                              int maxp, float scale, int q_dtype,
                              int kv_dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (q_dtype == 0)
    return launch_fp<float>(q, kc, vc, pt, pos, qlens, anc, out, B, S, H,
                            Hkv, D, P, maxp, scale, kv_dtype, st);
  if (q_dtype == 1)
    return launch_fp<__nv_bfloat16>(q, kc, vc, pt, pos, qlens, anc, out, B,
                                    S, H, Hkv, D, P, maxp, scale, kv_dtype,
                                    st);
  return (int)cudaErrorInvalidValue;
}

// The int8 pool: kc/vc int8 (N, P, Hkv, D), ks/vs fp32 (N, Hkv) scales.
// q_dtype as above. The 16-byte loads need D % 16 == 0 and 16-byte
// aligned pools (checked here); other head dims load element by element.
int ff_ragged_paged_attention_quant(const void* q, const void* kc,
                                    const void* vc, const void* ks,
                                    const void* vs, const void* pt,
                                    const void* pos, const void* qlens,
                                    const void* anc, void* out, int B, int S,
                                    int H, int Hkv, int D, int P, int maxp,
                                    float scale, int q_dtype, void* stream) {
  if ((D & 15) == 0 &&
      (((uintptr_t)kc | (uintptr_t)vc) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (q_dtype == 0)
    return launch<float, int8_t, true>(q, kc, vc, (const float*)ks,
                                       (const float*)vs, pt, pos, qlens, anc,
                                       out, B, S, H, Hkv, D, P, maxp, scale,
                                       st);
  if (q_dtype == 1)
    return launch<__nv_bfloat16, int8_t, true>(
        q, kc, vc, (const float*)ks, (const float*)vs, pt, pos, qlens, anc,
        out, B, S, H, Hkv, D, P, maxp, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* ff_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
