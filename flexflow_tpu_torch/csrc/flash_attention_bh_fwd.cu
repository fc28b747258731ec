// Head-major flash-attention forward (kernel K4) and its ring-step variant
// (kernel K5) for Hopper (sm_90a), written by hand.
//
// K4 replaces flexflow_tpu/ops/pallas/flash_attention.py::_fwd (body
// _fwd_kernel, tile math _online_block): blockwise attention with an
// online softmax over head-major (BH, S, D) q and (BH, T, D) k/v, kv heads
// already repeated to the q heads by the caller. The reference reaches it
// for every head dim that is not a multiple of 128 (GPT-2, BERT: D 64).
//
// K5 replaces _fwd_carry (body _fwd_carry_kernel), one step of ring
// attention (ring_flash.py): the same online softmax, but (m, l, acc)
// are read from the caller's fp32 m, l (BH, S) and acc (BH, S, D) instead
// of starting at (-1e30, 0, 0), and written back to them, updated in
// place and not normalised, for the next ring step. In the wgmma and the
// CUDA-core designs below both kernels run one body (the CUDA-core body's
// template flag Carry, the wgmma body's layout tag), so their math cannot
// drift apart; each has a __global__ of its own, so a profile tells them
// apart. (K5 has no 3xTF32 body: fp32 K5 runs the CUDA-core one.)
//
// Contract (the TPU kernel's): scores are fp32 dots times `scale`; under
// `causal` key kpos is visible to query qpos when qpos >= kpos (top-left
// alignment) and a masked score is -1e30. (m, l, acc) stay in fp32;
// probabilities are rounded to v's dtype before the P.V product;
// out = acc / max(l, 1e-30) in q's dtype, and lse = m + log(max(l, 1e-30)),
// fp32 (BH, S). (The TPU pads D to 128 lanes and broadcasts lse over 128
// lanes; both are its tiling, not part of the contract.)
//
// Three designs. K4 in bf16 at head dims 48, 64, 80, 96, 100, 128 and 256
// (GPT-2's and bench.py's 200m Llama's D 64 in training; Phi-3-mini's D
// 96; OpenLLaMA-3B's D 100; the ring's D 128) runs on the tensor cores:
// K1's body of flash_wgmma_fwd.cuh (wgmma fed by TMA, 384-thread blocks of
// 128 query rows, K/V rings of mbarrier'd stages), instantiated here under
// the HeadMajor tag as flash_fwd_wgmma_kernel<HeadMajor, D, BK, Stages>: a
// head-major (BH, L, D) tensor is the (B = BH, L, heads = 1, D) tensor its
// 4-D tensor maps describe, and lse (BH, S) is K1's (B, H = 1, S). At D
// 48, 80 and 96 the maps' boxes are 64 columns past D, which TMA fills
// with zeros: the tiles are 64 / 128 columns wide (DP), the scores stop
// after ceil(D / 16) k-steps and P.V runs at N = D (flash_wgmma.cuh). D
// 100 has rows of 200 bytes, which TMA cannot stride (16-byte multiples):
// its producer warpgroup fills the same 128-column tiles by 8-byte
// cp.async copies (cp_rows) and P.V runs at N 104. K5 in bf16 at the same
// widths (the ring at Phi-3-mini's D 96 and OpenLLaMA-3B's D 100 among
// them) runs that body under the HeadMajorCarry tag: each item starts
// from the caller's (m, l, acc), loaded straight into the accumulator
// registers (the columns below D), and ends by writing them back. K4 in
// fp32 at 64, 128 and
// 256 (GPT-2 trains its attention in fp32, as the reference computes it)
// runs on the tensor cores too, in 3xTF32 on mma.sync
// (flash_bh_fwd_tf32_kernel below, over the forward body of
// flash_tf32.cuh): each fp32 product as three tf32 products of hi / lo
// halves, about fp32's accuracy. K4 in fp32 at the other widths, K5 in
// fp32 at every width, and K4 and K5 in bf16 at the widths not named
// above (no model of the repo runs them) run the CUDA-core body below.
//
// CUDA-core body: one block per (64-row query tile, bh), a loop over
// 64-row K/V tiles that stops at the causal diagonal. D is any width up
// to 256: the kernel is instantiated for a few padded widths DP
// (flash_bh_common.cuh), loads the D real columns of each (contiguous)
// tile and zeroes the columns D..DP-1 in shared memory, so no padded copy
// reaches device memory. Rows past S and keys past T are masked here.
//
// What bounds it on the card: operations. At GPT-2 XL training (B 8,
// S = T 1024, H 25, D 64, causal) K4 does 4 * D ops per visible pair, about
// 0.027 ms at the bf16 tensor-core peak, against ~0.1 GB of q, k, v, out
// and lse (~0.031 ms at 3.35 TB/s); in fp32 the 3xTF32 body does 3 x
// those operations at the tf32 peak (0.163 ms), against 0.063 ms of
// bytes. K5 at a bench_1b ring step (BH 16,
// S = T 2048, D 128, full) does 4 * D ops per pair (~0.035 ms) against
// ~59 MB, over half of it the fp32 acc read and written (~0.018 ms): the
// tensor-core body keeps the products at the wgmma rate and moves acc
// once each way, between the registers and device memory, at the item's
// ends. At Phi-3-mini's ring block (BH 32, S = T 2048, D 96) the same
// reckoning gives ~0.052 ms of operations full against ~89 MB (~0.027
// ms), so a causal block (half the pairs) is bound by its bytes. Its
// causal block is a persistent zigzag of square, top-left items, as
// K4's. The CUDA-core body runs the dots from fp32
// shared-memory tiles (register tiles of (BQ / 16) x (BK / 16) scores per
// thread).

#include "flash_bh_common.cuh"
#include "flash_tf32.cuh"
#include "flash_wgmma_fwd.cuh"

namespace {

using namespace ffflash;

// The block body of both kernels.
// Carry = false: K4, writes out and lse (m_io, l_io, acc_io unused).
// Carry = true: K5, reads and writes m_io, l_io, acc_io (out, lse unused).
template <typename T, int DP, int BT, bool Carry>
__device__ __forceinline__ void
flash_bh_fwd_body(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out,
                  float* __restrict__ lse, float* __restrict__ m_io,
                  float* __restrict__ l_io, float* __restrict__ acc_io,
                  int S, int Tk, int D, int causal, float scale) {
  constexpr int LD = DP + 1;   // padded row stride of DP-wide tiles
  constexpr int LP = BT + 1;   // padded row stride of the score tile
  constexpr int RI = BT / 16;  // query rows per thread
  constexpr int CJ = BT / 16;  // score columns per thread
  constexpr int JD = DP / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;            // (BT, LD)
  float* sK = sQ + BT * LD;    // (BT, LD)
  float* sV = sK + BT * LD;    // (BT, LD)
  float* sP = sV + BT * LD;    // (BT, LP) probabilities

  const int q0 = blockIdx.x * BT;
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * S * D;
  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<T, DP>(sQ, LD, qb, S, D, q0, BT);
  float m[RI], l[RI], acc[RI][JD];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qpos = q0 + ty * RI + i;
    const bool carried = Carry && qpos < S;
    const size_t row = bh * S + qpos;
    m[i] = carried ? m_io[row] : kNegInf;
    l[i] = carried ? l_io[row] : 0.f;
#pragma unroll
    for (int jd = 0; jd < JD; ++jd) {
      const int col = tx + 16 * jd;
      acc[i][jd] = carried && col < D ? acc_io[row * D + col] : 0.f;
    }
  }

  // tiles wholly past the diagonal are never visited (the reference's
  // _live)
  const int kend = causal ? min(Tk, q0 + BT) : Tk;
  for (int k0 = 0; k0 < kend; k0 += BT) {
    __syncthreads();  // the previous tile's P.V is done with sV and sP
    load_tile<T, DP>(sK, LD, kb, Tk, D, k0, BT);
    load_tile<T, DP>(sV, LD, vb, Tk, D, k0, BT);
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
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
    const size_t row = bh * S + qpos;
    if (Carry) {
      // the statistics as they stand, for the next ring step
#pragma unroll
      for (int jd = 0; jd < JD; ++jd) {
        const int col = tx + 16 * jd;
        if (col < D) acc_io[row * D + col] = acc[i][jd];
      }
      if (tx == 0) {
        m_io[row] = m[i];
        l_io[row] = l[i];
      }
      continue;
    }
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jd = 0; jd < JD; ++jd) {
      const int col = tx + 16 * jd;
      if (col < D) out[row * D + col] = from_f<T>(acc[i][jd] / l_safe);
    }
    if (tx == 0) lse[row] = m[i] + logf(l_safe);
  }
}

// Two entry points over one body, so that a profile names K4 and K5 apart.
template <typename T, int DP, int BT>
__global__ void __launch_bounds__(kThreads)
flash_bh_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out,
                    float* __restrict__ lse, float* __restrict__ m_io,
                    float* __restrict__ l_io, float* __restrict__ acc_io,
                    int S, int Tk, int D, int causal, float scale) {
  flash_bh_fwd_body<T, DP, BT, false>(q, k, v, out, lse, m_io, l_io, acc_io,
                                      S, Tk, D, causal, scale);
}

template <typename T, int DP, int BT>
__global__ void __launch_bounds__(kThreads)
flash_bh_fwd_carry_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ out,
                          float* __restrict__ lse, float* __restrict__ m_io,
                          float* __restrict__ l_io,
                          float* __restrict__ acc_io, int S, int Tk, int D,
                          int causal, float scale) {
  flash_bh_fwd_body<T, DP, BT, true>(q, k, v, out, lse, m_io, l_io, acc_io,
                                     S, Tk, D, causal, scale);
}

// ---- K4 in fp32 at D 64, 128 and 256: 3xTF32 on the tensor cores ---------
namespace tf32 {

template <int D>
__global__ void __launch_bounds__(fftf32::FwdTiles<D>::BR * 2, 1)
flash_bh_fwd_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         float* __restrict__ lse, int S, int Tk, int causal,
                         float scale, int vec) {
  fftf32::fwd_body<D>(q, k, v, out, lse, S, Tk, causal, scale, vec);
}

}  // namespace tf32

template <int DP>
constexpr size_t fwd_smem(int bt) {
  return ((size_t)3 * bt * (DP + 1) + (size_t)bt * (bt + 1)) * sizeof(float);
}

// the buffers of one launch: out and lse for K4, m, l and acc for K5
struct Outputs {
  void* out;
  void* lse;
  void* m;
  void* l;
  void* acc;
};

template <typename T, int DP, bool Carry>
int launch(const void* q, const void* k, const void* v, Outputs o, int BH,
           int S, int Tk, int D, int causal, float scale,
           cudaStream_t stream) {
  constexpr int BT = fwd_smem<DP>(64) <= kMaxSmemBytes ? 64 : 32;
  constexpr size_t smem = fwd_smem<DP>(BT);
  static_assert(smem <= kMaxSmemBytes, "tile does not fit shared memory");
  auto kernel = Carry ? flash_bh_fwd_carry_kernel<T, DP, BT>
                      : flash_bh_fwd_kernel<T, DP, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BT - 1) / BT, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o.out, (float*)o.lse,
      (float*)o.m, (float*)o.l, (float*)o.acc, S, Tk, D, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool Carry>
int dispatch(const void* q, const void* k, const void* v, Outputs o, int BH,
             int S, int Tk, int D, int causal, float scale,
             cudaStream_t st) {
#define FF_FWD(DP) \
  return launch<T, DP, Carry>(q, k, v, o, BH, S, Tk, D, causal, scale, st)
  if (D <= 32) FF_FWD(32);
  if (D <= 64) FF_FWD(64);
  if (D <= 96) FF_FWD(96);
  if (D <= 128) FF_FWD(128);
  if (D <= 192) FF_FWD(192);
  FF_FWD(256);
#undef FF_FWD
}

}  // namespace

extern "C" {

// q (BH, S, D), k/v (BH, T, D), out (BH, S, D), all contiguous and of one
// dtype: 0 = float32, 1 = bfloat16; lse fp32 (BH, S). bf16 at D 48, 64,
// 80, 96, 100, 128 and 256 runs the wgmma body (D 100's tiles filled by
// cp.async), fp32 at D 64, 128 and 256 the 3xTF32 one (mma.sync), every
// other case (fp32 at D 100 too) the CUDA-core body.
// Returns a cudaError_t: cudaErrorInvalidValue for shapes the kernel does
// not take (bh_shapes_ok) or tensors the wgmma body cannot load (TMA: a
// base that is not 16-byte aligned; cp.async at D 100: not 8-byte
// aligned), otherwise the launch's cudaGetLastError().
int ff_flash_attention_bh_fwd(const void* q, const void* k, const void* v,
                              void* out, void* lse, int BH, int S, int T,
                              int D, int causal, float scale, int dtype,
                              void* stream) {
  if (!bh_shapes_ok(BH, S, T, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FF_FWD_WG(DIM)                                                     \
  return ffwg::launch_fwd_wgmma<ffwg::HeadMajor, DIM>(                     \
      q, k, v, out, lse, BH, S, T, 1, 1, causal, scale, st)
  if (dtype == 1 && D == 48) FF_FWD_WG(48);
  if (dtype == 1 && D == 64) FF_FWD_WG(64);
  if (dtype == 1 && D == 80) FF_FWD_WG(80);
  if (dtype == 1 && D == 96) FF_FWD_WG(96);
  if (dtype == 1 && D == 100) FF_FWD_WG(100);
  if (dtype == 1 && D == 128) FF_FWD_WG(128);
  if (dtype == 1 && D == 256) FF_FWD_WG(256);
#undef FF_FWD_WG
#define FF_FWD_TF32(DIM)                                                    \
  return fftf32::launch_fwd<DIM>(tf32::flash_bh_fwd_tf32_kernel<DIM>, q, k, v, \
                                 out, lse, BH, S, T, causal, scale, st)
  if (dtype == 0 && D == 64) FF_FWD_TF32(64);
  if (dtype == 0 && D == 128) FF_FWD_TF32(128);
  if (dtype == 0 && D == 256) FF_FWD_TF32(256);
#undef FF_FWD_TF32
  const Outputs o{out, lse, nullptr, nullptr, nullptr};
  if (dtype == 0)
    return dispatch<float, false>(q, k, v, o, BH, S, T, D, causal, scale,
                                  st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, false>(q, k, v, o, BH, S, T, D, causal,
                                          scale, st);
  return (int)cudaErrorInvalidValue;
}

// K5: q (BH, S, D), k/v (BH, T, D) of one dtype (as K4); m, l fp32 (BH, S)
// and acc fp32 (BH, S, D), read and updated in place. bf16 at D 48, 64,
// 80, 96, 100, 128 and 256 runs the tensor-core body (HeadMajorCarry; D
// 100's tiles filled by cp.async), every other case (fp32 at every width)
// the CUDA-core body. Same return codes, and cudaErrorInvalidValue for a
// tensor-core launch whose acc is not 8-byte aligned.
int ff_flash_attention_bh_fwd_carry(const void* q, const void* k,
                                    const void* v, void* m, void* l,
                                    void* acc, int BH, int S, int T, int D,
                                    int causal, float scale, int dtype,
                                    void* stream) {
  if (!bh_shapes_ok(BH, S, T, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FF_CARRY_WG(DIM)                                                   \
  return ffwg::launch_fwd_wgmma<ffwg::HeadMajorCarry, DIM>(                \
      q, k, v, nullptr, nullptr, BH, S, T, 1, 1, causal, scale, st, m, l,  \
      acc)
  if (dtype == 1 && D == 48) FF_CARRY_WG(48);
  if (dtype == 1 && D == 64) FF_CARRY_WG(64);
  if (dtype == 1 && D == 80) FF_CARRY_WG(80);
  if (dtype == 1 && D == 96) FF_CARRY_WG(96);
  if (dtype == 1 && D == 100) FF_CARRY_WG(100);
  if (dtype == 1 && D == 128) FF_CARRY_WG(128);
  if (dtype == 1 && D == 256) FF_CARRY_WG(256);
#undef FF_CARRY_WG
  const Outputs o{nullptr, nullptr, m, l, acc};
  if (dtype == 0)
    return dispatch<float, true>(q, k, v, o, BH, S, T, D, causal, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, true>(q, k, v, o, BH, S, T, D, causal,
                                         scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* ff_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
