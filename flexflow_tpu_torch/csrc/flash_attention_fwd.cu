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
// Two bodies. bf16 at head dims 128 and 256 (every training shape of the
// repo's flat route) runs on the tensor cores: wgmma fed by TMA, below
// (flash_fwd_wgmma_kernel). fp32 at every head dim, and bf16 at 64, 384
// and 512, run the CUDA-core body (flash_fwd_kernel): fp32 products must
// stay exact (a tensor-core fp32 path would be TF32), and 64 / 384 / 512
// are off the training path.
//
// CUDA-core body: one block per (BT-row query tile, b * H + h). A loop
// over BT-row K/V tiles takes the place of the TPU's sequential grid axis
// and stops at the causal diagonal (the counterpart of _live). Rows and
// columns past S or T are masked here, so S and T need not be multiples
// of the tile. Head dims 64, 128, 256, 384 and 512 (the reference's flat
// route takes every multiple of 128); BT is the largest of 64, 32 and 16
// whose fp32 Q, K, V and score tiles fit a block's 227 KB
// (static_assert'ed): 64 up to D 256, 32 at 384 and 512.
//
// What bounds it on the card: operations. At the training shape (B 8,
// S = T 1024, H 16, D 128, causal) it does 4 * D ops per visible (query,
// key) pair against ~100 MB of q, k, v, out and lse: ~35 us at the bf16
// tensor-core peak against ~30 us of bytes. The CUDA-core body runs the
// dots from fp32 tiles in shared memory (4 x 4 register tiles per
// thread); the tensor-core body is built for that bound.

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

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
  constexpr int BT = fwd_smem<D>(64) <= kMaxSmemBytes   ? 64
                     : fwd_smem<D>(32) <= kMaxSmemBytes ? 32
                                                         : 16;
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

// ---------------------------------------------------------------------------
// The bf16 body at head dims 128 and 256: tensor cores (wgmma) fed by TMA.
//
// A block takes BM = 128 query rows of one (b, h) as two consumer
// warpgroups of 64 rows, plus a producer warpgroup (384 threads) of which
// one thread issues every TMA load and which hands its registers to the
// consumers (setmaxnreg: 40 / 232; at 288 threads ptxas caps every thread
// at 168 and the accumulators spill). The producer loads the Q tile
// once, then K/V tiles of BK keys into a ring of kStages stages (full /
// empty mbarriers). Each consumer warpgroup runs
// S = Q.K^T on wgmma (both operands in shared memory), the online softmax
// on the accumulator registers, then O += P.V on wgmma with P (rounded to
// bf16) as the A operand straight from those registers and V as the
// transposed (MN-major) B operand. O, m and l stay in fp32 registers; out
// and lse are written once. Under `causal` the loop stops at the diagonal
// and the grid launches the heaviest query tiles first (blockIdx.y counts
// down from the last tile). Keys past T are masked (TMA reads them as
// zeros); rows past S are not stored.
// BK: 128 at D 128 (S 64 registers a thread, O 64), 64 at D 256 (O 128).

namespace {

using namespace ffflash;
using namespace ffwg;

constexpr int kBM = 128;              // query rows a block
constexpr int kConsumers = 256;       // two warpgroups
constexpr int kWgThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kStages = 2;

template <int D>
constexpr int fwd_bk() { return D == 128 ? 128 : 64; }

template <int D>
constexpr size_t fwd_wg_smem() {
  return (size_t)kBM * D * 2 + (size_t)2 * kStages * fwd_bk<D>() * D * 2 +
         1024 /* barriers */ + 1024 /* alignment */;
}

template <int D, int BK>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int S, int Tk, int H,
                       int Hkv, int causal, float scale) {
  constexpr int kQBytes = kBM * D * 2;
  constexpr int kKVBytes = BK * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  __nv_bfloat16* sQ = (__nv_bfloat16*)base;
  uint8_t* sK = base + kQBytes;                       // kStages tiles
  uint8_t* sV = sK + kStages * kKVBytes;              // kStages tiles
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
      mbar_expect_tx(bar_q, kQBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(sQ + c * kBM * 64, &map_q, bar_q, c * 64, h, q0, b);
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
    // consumers: warpgroup wg takes rows q0 + 64 wg ..; this thread rows r0
    // and r0 + 8, columns 8 j + cq + {0, 1} of each 8-column group j
    const int wg = warp / 4;
    const int r0 = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
    const int cq = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2e;
    const float masked = kNegInf * kLog2e;  // -1e30, in log2 units
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(bar_q, 0);
    for (int i = 0; i < nk; ++i) {
      const int s = i % kStages;
      const int k0 = i * BK;
      const __nv_bfloat16* k_s = (const __nv_bfloat16*)(sK + s * kKVBytes);
      const __nv_bfloat16* v_s = (const __nv_bfloat16*)(sV + s * kKVBytes);
      mbar_wait(&full[s], (i / kStages) & 1);

      float sc[BK / 2];
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) sc[x] = 0.f;
      fence_regs(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(sc, kmajor<kBM>(sQ, wg * 64, kk), kmajor<BK>(k_s, 0, kk),
                     1);
      wg_commit();
      wg_wait0();
      fence_regs(sc);

      // a key of this tile may be hidden from a row of this warpgroup
      const bool edge =
          k0 + BK > Tk || (causal && k0 + BK - 1 > q0 + wg * 64);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = sc[4 * j + 2 * hf + e] * scale_log2;
            if (edge) {
              const int kpos = k0 + 8 * j + cq + e;
              if (kpos >= Tk)
                x = -INFINITY;
              else if (causal && kpos > r0 + 8 * hf)
                x = masked;
            }
            sc[4 * j + 2 * hf + e] = x;
            mx[hf] = fmaxf(mx[hf], x);
          }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
        corr[hf] = exp2f(m[hf] - mx[hf]);
        m[hf] = mx[hf];
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(sc[4 * j + 2 * hf + e] - m[hf]);
            sum[hf] += p;
            sc[4 * j + 2 * hf + e] = p;
          }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 1);
        sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 2);
        l[hf] = l[hf] * corr[hf] + sum[hf];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          o[4 * j + 2 * hf] *= corr[hf];
          o[4 * j + 2 * hf + 1] *= corr[hf];
        }
      // P rounded to bf16: the A operand of P.V, from the accumulator layout
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      fence_regs(o);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D>(o, pa[kk], mnmajor<BK>(v_s, kk), 1);
      wg_commit();
      wg_wait0();
      fence_regs(o);
      mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + 8 * hf;
      if (row >= S) continue;
      const float l_safe = fmaxf(l[hf], 1e-30f);
      __nv_bfloat16* dst = out + elem<D>(b, S, H, h, row, cq);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * hf] / l_safe,
                                  o[4 * j + 2 * hf + 1] / l_safe);
      if (lane % 4 == 0)
        lse[(size_t)bh * S + row] = m[hf] * kLn2 + logf(l_safe);
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 void* lse, int B, int S, int Tk, int H, int Hkv, int causal,
                 float scale, cudaStream_t stream) {
  constexpr int BK = fwd_bk<D>();
  constexpr size_t smem = fwd_wg_smem<D>();
  static_assert(smem <= kMaxSmemBytes, "tiles do not fit shared memory");
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, S, H, D, kBM) ||
      !make_map(&mk, k, B, Tk, Hkv, D, BK) ||
      !make_map(&mv, v, B, Tk, Hkv, D, BK))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_wgmma_kernel<D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + kBM - 1) / kBM);
  kernel<<<grid, kWgThreads, smem, stream>>>(mq, mk, mv,
                                              (__nv_bfloat16*)out,
                                              (float*)lse, S, Tk, H, Hkv,
                                              causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it); lse is
// fp32 (B, H, S). bf16 at D 128 and 256 runs the tensor-core body, every
// other case the CUDA-core body. Returns a cudaError_t:
// cudaErrorInvalidValue for shapes the kernels do not take (D other than
// 64, 128, 256, 384 or 512) or tensors TMA cannot map, otherwise the
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
  if (dtype == 0 && D == 384) FF_FWD(float, 384);
  if (dtype == 0 && D == 512) FF_FWD(float, 512);
  if (dtype == 1 && D == 64) FF_FWD(__nv_bfloat16, 64);
  if (dtype == 1 && D == 384) FF_FWD(__nv_bfloat16, 384);
  if (dtype == 1 && D == 512) FF_FWD(__nv_bfloat16, 512);
#undef FF_FWD
  if (dtype == 1 && D == 128)
    return launch_wgmma<128>(q, k, v, out, lse, B, S, T, H, Hkv, causal,
                             scale, st);
  if (dtype == 1 && D == 256)
    return launch_wgmma<256>(q, k, v, out, lse, B, S, T, H, Hkv, causal,
                             scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* ff_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
