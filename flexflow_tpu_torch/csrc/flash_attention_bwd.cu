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
// Two bodies. bf16 at head dims 128 and 256 runs on the tensor cores
// (wgmma fed by TMA, below). fp32 at every head dim, and bf16 at 64, 384
// and 512, run the CUDA-core bodies (flash_dq_kernel, flash_dkv_kernel): fp32
// products stay exact (a tensor-core fp32 path would be TF32).
//
// CUDA-core bodies: tiles are BT x BT, the largest of 64, 32 and 16 whose
// four fp32 D-wide tiles fit a block's 227 KB (static_assert'ed): 64 at
// head dims 64 and 128, 32 at 256 and 384, 16 at 512.
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
// tensor-core peak). The CUDA-core bodies run the dots from fp32
// shared-memory tiles; the tensor-core bodies are built for that bound.

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

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

}  // namespace

// ---------------------------------------------------------------------------
// The bf16 bodies on the tensor cores (wgmma fed by TMA), at head dims
// 128 and 256. Every product runs on wgmma; ds and p go from
// the accumulator registers, rounded to bf16, straight into the A operand
// of the next product, and the row-major tiles serve as the transposed
// (MN-major) B operand where the contraction runs along their rows.
//
// Blocks of 384 threads: two consumer warpgroups and a producer warpgroup
// whose first warp loads, which hands its registers to the consumers
// (setmaxnreg: 40 / 232).
// dq: a block takes 128 query rows of one (b, h) as two consumer
// warpgroups of 64; the producer loads Q and dO once and K/V tiles of BK
// keys into a ring of kStages stages. Per tile: S = Q.K^T and
// dP = dO.V^T (shared x shared), p = exp(s - lse), ds = p (dp - delta)
// scale, dq += ds.K (ds from registers, K transposed). Heaviest query
// tiles first. BK: 64 at D 128, 32 at D 256 (dq's 64 x 256 fp32
// accumulator is 128 registers a thread).
// dk/dv: a block takes 128 keys of one (b, g) as two warpgroups of 64
// (at D 256: 64 keys, each warpgroup half of dk's and dv's columns; see
// dkv_keys), K and V loaded once; the producer walks (query head of the
// GQA group) x (live query tile of BQ rows), loading Q and dO by TMA and
// lse / delta (scaled to log2 units) by plain loads into a ring of
// kStages stages.
// Per tile: S^T = K.Q^T and dP^T = V.dO^T, so p^T and ds^T sit in the
// accumulator with keys as rows; dv += p^T.dO and dk += ds^T.Q, each from
// registers with dO and Q transposed. The group's heads are summed inside
// the block: no atomics, the same bits from run to run.

namespace {

using namespace ffflash;
using namespace ffwg;

constexpr int kBM = 128;                     // rows a block (q or k)
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kWgThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kStages = 2;
constexpr int kDkvBQ = 64;                   // dk/dv: query rows a tile

template <int D>
constexpr int dq_bk() { return D == 128 ? 64 : 32; }

template <int D>
constexpr size_t dq_wg_smem() {
  return (size_t)2 * kBM * D * 2 + (size_t)2 * kStages * dq_bk<D>() * D * 2 +
         1024 + 1024;
}

// dk/dv: keys a block. At D 128 each warpgroup takes 64 keys; at D 256
// both take the same 64 keys and split the columns of dk and dv (128
// each), since two 64 x 256 fp32 accumulators would need 256 registers a
// thread; each computes the whole S^T and dP^T (their D-long dots) for
// its half
template <int D>
__host__ __device__ constexpr int dkv_keys() { return D > 128 ? 64 : kBM; }

template <int D>
constexpr size_t dkv_wg_smem() {
  return (size_t)2 * dkv_keys<D>() * D * 2 +
         (size_t)2 * kStages * kDkvBQ * D * 2 +
         (size_t)2 * kStages * kDkvBQ * 4 + 1024 + 1024;
}

template <int D, int BK>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int S, int Tk, int H,
                      int Hkv, int causal, float scale) {
  constexpr int kQBytes = kBM * D * 2;
  constexpr int kKVBytes = BK * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  __nv_bfloat16* sQ = (__nv_bfloat16*)base;
  __nv_bfloat16* sO = (__nv_bfloat16*)(base + kQBytes);  // dO
  uint8_t* sK = base + 2 * kQBytes;                       // kStages tiles
  uint8_t* sV = sK + kStages * kKVBytes;                  // kStages tiles
  uint64_t* bar_q = (uint64_t*)(sV + kStages * kKVBytes);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, g = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // heaviest first
  const int kend = causal ? min(Tk, q0 + kBM) : Tk;
  const int nk = (kend + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer warpgroup: one thread
    producer_regs();                // issues every load
    if (warp == kConsumers / 32 && lane == 0) {
      mbar_expect_tx(bar_q, 2 * kQBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(sQ + c * kBM * 64, &map_q, bar_q, c * 64, h, q0, b);
        tma_load_4d(sO + c * kBM * 64, &map_do, bar_q, c * 64, h, q0, b);
      }
      for (int i = 0; i < nk; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * kKVBytes);
        __nv_bfloat16* k_s = (__nv_bfloat16*)(sK + s * kKVBytes);
        __nv_bfloat16* v_s = (__nv_bfloat16*)(sV + s * kKVBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(k_s + c * BK * 64, &map_k, &full[s], c * 64, g,
                      i * BK, b);
          tma_load_4d(v_s + c * BK * 64, &map_v, &full[s], c * 64, g,
                      i * BK, b);
        }
      }
    }
  } else {
    consumer_regs();
    // consumers: rows r0 and r0 + 8 of this thread, columns 8 j + cq + e
    const int wg = warp / 4;
    const int r0 = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
    const int cq = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2e;
    float row_lse[2], row_delta[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + 8 * hf;
      row_lse[hf] = row < S ? lse[(size_t)bh * S + row] * kLog2e : 0.f;
      row_delta[hf] = row < S ? delta[(size_t)bh * S + row] : 0.f;
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(bar_q, 0);
    for (int i = 0; i < nk; ++i) {
      const int s = i % kStages;
      const int k0 = i * BK;
      const __nv_bfloat16* k_s = (const __nv_bfloat16*)(sK + s * kKVBytes);
      const __nv_bfloat16* v_s = (const __nv_bfloat16*)(sV + s * kKVBytes);
      mbar_wait(&full[s], (i / kStages) & 1);

      float sc[BK / 2], dp[BK / 2];
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) sc[x] = dp[x] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(sc, kmajor<kBM>(sQ, wg * 64, kk), kmajor<BK>(k_s, 0, kk),
                     1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(dp, kmajor<kBM>(sO, wg * 64, kk), kmajor<BK>(v_s, 0, kk),
                     1);
      wg_commit();
      wg_wait0();
      fence_regs(sc);
      fence_regs(dp);

      const bool edge =
          k0 + BK > Tk || (causal && k0 + BK - 1 > q0 + wg * 64);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * hf + e;
            float p = exp2f(sc[x] * scale_log2 - row_lse[hf]);
            if (edge) {
              const int kpos = k0 + 8 * j + cq + e;
              if (kpos >= Tk || (causal && kpos > r0 + 8 * hf)) p = 0.f;
            }
            sc[x] = p * (dp[x] - row_delta[hf]) * scale;  // ds
          }
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          da[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D>(acc, da[kk], mnmajor<BK>(k_s, kk), 1);
      wg_commit();
      wg_wait0();
      fence_regs(acc);
      mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + 8 * hf;
      if (row >= S) continue;
      __nv_bfloat16* dst = dq + elem<D>(b, S, H, h, row, cq);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hf],
                                  acc[4 * j + 2 * hf + 1]);
    }
  }
}

template <int D, int BQ>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int S, int Tk, int H,
                       int Hkv, int causal, float scale) {
  constexpr int BN = dkv_keys<D>();
  constexpr int DW = D > 128 ? D / 2 : D;  // dk / dv columns a warpgroup
  constexpr int kKBytes = BN * D * 2;
  constexpr int kQBytes = BQ * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  __nv_bfloat16* sK = (__nv_bfloat16*)base;
  __nv_bfloat16* sV = (__nv_bfloat16*)(base + kKBytes);
  uint8_t* sQ = base + 2 * kKBytes;          // kStages tiles
  uint8_t* sO = sQ + kStages * kQBytes;      // kStages dO tiles
  float* sL = (float*)(sO + kStages * kQBytes);  // kStages x BQ lse, log2
  float* sD = sL + kStages * BQ;                 // kStages x BQ delta
  uint64_t* bar_kv = (uint64_t*)(sD + kStages * BQ);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + kStages;

  const int bg = blockIdx.x;
  const int b = bg / Hkv, g = bg % Hkv;
  const int rep = H / Hkv;
  const int k0 = blockIdx.y * BN;  // key tile 0 (the heaviest) first
  const int nq = (S + BQ - 1) / BQ;
  const int iq0 = causal ? min(k0 / BQ, nq) : 0;
  const int live = nq - iq0;  // live query tiles a head
  const int iters = rep * live;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer warpgroup: its first
    producer_regs();                // warp loads, the others idle
    if (warp == kConsumers / 32) {
      if (lane == 0) {
        mbar_expect_tx(bar_kv, 2 * kKBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(sK + c * BN * 64, &map_k, bar_kv, c * 64, g, k0, b);
          tma_load_4d(sV + c * BN * 64, &map_v, bar_kv, c * 64, g, k0, b);
        }
      }
      for (int it = 0; it < iters; ++it) {
        const int s = it % kStages;
        const int h = g * rep + it / live;
        const int q0 = (iq0 + it % live) * BQ;
        if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
        const size_t row_base = ((size_t)b * H + h) * S;
        for (int r = lane; r < BQ; r += 32) {
          const int qpos = q0 + r;
          sL[s * BQ + r] = qpos < S ? lse[row_base + qpos] * kLog2e : 0.f;
          sD[s * BQ + r] = qpos < S ? delta[row_base + qpos] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * kQBytes);
          __nv_bfloat16* q_s = (__nv_bfloat16*)(sQ + s * kQBytes);
          __nv_bfloat16* o_s = (__nv_bfloat16*)(sO + s * kQBytes);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(q_s + c * BQ * 64, &map_q, &full[s], c * 64, h, q0, b);
            tma_load_4d(o_s + c * BQ * 64, &map_do, &full[s], c * 64, h, q0,
                        b);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    consumer_regs();
    // consumers: key rows kr0 and kr0 + 8 of this thread, query columns
    // 8 j + cq + e of each tile
    const int wg = warp / 4;
    const int key_off = D > 128 ? 0 : wg * 64;  // keys of this warpgroup
    const int col_off = D > 128 ? wg * DW : 0;  // its dk / dv columns
    const int kr0 = k0 + key_off + (warp % 4) * 16 + lane / 4;
    const int cq = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2e;
    float dka[DW / 2], dva[DW / 2];
#pragma unroll
    for (int i = 0; i < DW / 2; ++i) dka[i] = dva[i] = 0.f;

    mbar_wait(bar_kv, 0);
    for (int it = 0; it < iters; ++it) {
      const int s = it % kStages;
      const int q0 = (iq0 + it % live) * BQ;
      const __nv_bfloat16* q_s = (const __nv_bfloat16*)(sQ + s * kQBytes);
      const __nv_bfloat16* o_s = (const __nv_bfloat16*)(sO + s * kQBytes);
      const float* l_s = sL + s * BQ;
      const float* d_s = sD + s * BQ;
      mbar_wait(&full[s], (it / kStages) & 1);

      float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
      for (int x = 0; x < BQ / 2; ++x) st[x] = dpt[x] = 0.f;
      fence_regs(st);
      fence_regs(dpt);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ>(st, kmajor<BN>(sK, key_off, kk), kmajor<BQ>(q_s, 0, kk),
                     1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ>(dpt, kmajor<BN>(sV, key_off, kk),
                     kmajor<BQ>(o_s, 0, kk), 1);
      wg_commit();
      wg_wait0();
      fence_regs(st);
      fence_regs(dpt);

      // a query of this tile is past S, or before a key of this warpgroup
      const bool edge = q0 + BQ > S || (causal && q0 < k0 + key_off + 63);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + cq + e;
          const float row_lse = l_s[c], row_delta = d_s[c];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int x = 4 * j + 2 * hf + e;
            float p = exp2f(st[x] * scale_log2 - row_lse);
            if (edge) {
              const int qpos = q0 + c;
              if (qpos >= S || (causal && kr0 + 8 * hf > qpos)) p = 0.f;
            }
            dpt[x] = p * (dpt[x] - row_delta) * scale;  // ds^T
            st[x] = p;                                  // p^T
          }
        }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
          da[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
        }
      fence_regs(dva);
      fence_regs(dka);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<DW>(dva, pa[kk], mnmajor<BQ>(o_s + col_off * BQ, kk), 1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<DW>(dka, da[kk], mnmajor<BQ>(q_s + col_off * BQ, kk), 1);
      wg_commit();
      wg_wait0();
      fence_regs(dva);
      fence_regs(dka);
      mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int kpos = kr0 + 8 * hf;
      if (kpos >= Tk) continue;
      const size_t off = elem<D>(b, Tk, Hkv, g, kpos, col_off + cq);
#pragma unroll
      for (int j = 0; j < DW / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
            __floats2bfloat162_rn(dka[4 * j + 2 * hf],
                                  dka[4 * j + 2 * hf + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
            __floats2bfloat162_rn(dva[4 * j + 2 * hf],
                                  dva[4 * j + 2 * hf + 1]);
      }
    }
  }
}

template <int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int B, int S, int Tk, int H, int Hkv,
                    int causal, float scale, cudaStream_t stream) {
  constexpr int BK = dq_bk<D>();
  constexpr size_t smem = dq_wg_smem<D>();
  static_assert(smem <= kMaxSmemBytes, "tiles do not fit shared memory");
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, q, B, S, H, D, kBM) ||
      !make_map(&mo, dout, B, S, H, D, kBM) ||
      !make_map(&mk, k, B, Tk, Hkv, D, BK) ||
      !make_map(&mv, v, B, Tk, Hkv, D, BK))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_dq_wgmma_kernel<D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + kBM - 1) / kBM);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      mq, mk, mv, mo, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dq, S, Tk, H, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int B, int S, int Tk, int H,
                     int Hkv, int causal, float scale, cudaStream_t stream) {
  constexpr int BN = dkv_keys<D>();
  constexpr size_t smem = dkv_wg_smem<D>();
  static_assert(smem <= kMaxSmemBytes, "tiles do not fit shared memory");
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, q, B, S, H, D, kDkvBQ) ||
      !make_map(&mo, dout, B, S, H, D, kDkvBQ) ||
      !make_map(&mk, k, B, Tk, Hkv, D, BN) ||
      !make_map(&mv, v, B, Tk, Hkv, D, BN))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_dkv_wgmma_kernel<D, kDkvBQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * Hkv, (Tk + BN - 1) / BN);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      mq, mk, mv, mo, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, S, Tk, H, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO, dq, dk, dv share it);
// lse and delta fp32 (B, H, S). bf16 at D 128 and 256 runs the
// tensor-core bodies, every other case the CUDA-core ones. Each returns
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
  if (dtype == 0 && D == 128) FF_DQ(float, 128);
  if (dtype == 0 && D == 256) FF_DQ(float, 256);
  if (dtype == 0 && D == 384) FF_DQ(float, 384);
  if (dtype == 0 && D == 512) FF_DQ(float, 512);
  if (dtype == 1 && D == 64) FF_DQ(__nv_bfloat16, 64);
  if (dtype == 1 && D == 384) FF_DQ(__nv_bfloat16, 384);
  if (dtype == 1 && D == 512) FF_DQ(__nv_bfloat16, 512);
#undef FF_DQ
  if (dtype == 1 && D == 128)
    return launch_dq_wgmma<128>(q, k, v, dout, lse, delta, dq, B, S, T, H,
                                Hkv, causal, scale, st);
  if (dtype == 1 && D == 256)
    return launch_dq_wgmma<256>(q, k, v, dout, lse, delta, dq, B, S, T, H,
                                Hkv, causal, scale, st);
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
  if (dtype == 0 && D == 256) FF_DKV(float, 256);
  if (dtype == 0 && D == 384) FF_DKV(float, 384);
  if (dtype == 0 && D == 512) FF_DKV(float, 512);
  if (dtype == 1 && D == 64) FF_DKV(__nv_bfloat16, 64);
  if (dtype == 1 && D == 384) FF_DKV(__nv_bfloat16, 384);
  if (dtype == 1 && D == 512) FF_DKV(__nv_bfloat16, 512);
#undef FF_DKV
  if (dtype == 1 && D == 128)
    return launch_dkv_wgmma<128>(q, k, v, dout, lse, delta, dk, dv, B, S, T,
                                 H, Hkv, causal, scale, st);
  if (dtype == 1 && D == 256)
    return launch_dkv_wgmma<256>(q, k, v, dout, lse, delta, dk, dv, B, S, T,
                                 H, Hkv, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* ff_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
