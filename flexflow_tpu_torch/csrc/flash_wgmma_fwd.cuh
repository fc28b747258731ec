// The tensor-core flash-attention forward body (bf16, head dims 64, 128
// and 256): wgmma fed by TMA. One body for two kernels, each instantiating
// it under its own layout tag (flash_wgmma.cuh): K1
// (flash_attention_fwd.cu, FlatLayout) and K4's forward
// (flash_attention_bh_fwd.cu, HeadMajor).
//
// Work items are (query tile of kBM = 128 rows, b * H + h), numbered
// heaviest first (the last query tiles, under `causal`, then b * H + h).
// The grid is persistent (flash_wgmma.cuh): one block per SM takes items
// in zigzag rounds, so the loads of an item's Q tile and first K/V tiles
// overlap the previous item's last tiles and epilogue. A block is two
// consumer warpgroups of 64 query rows plus a producer warpgroup (384
// threads) of which one thread issues every TMA load and which hands its
// registers to the consumers (setmaxnreg: 40 / 232; at 288 threads ptxas
// caps every thread at 168 and the accumulators spill). The producer
// loads each item's Q tile into one of QBufs buffers, then its K/V tiles
// of BK keys into a ring of Stages stages that runs on across items
// (full / empty mbarriers for both). Each consumer warpgroup runs S =
// Q.K^T on wgmma (both operands in shared memory), the online softmax on
// the accumulator registers, then O += P.V on wgmma with P (rounded to
// bf16) as the A operand straight from those registers and V as the
// transposed (MN-major) B operand. The two products overlap across
// tiles: tile i's S is issued together with tile i - 1's P.V, and tile
// i's softmax runs while that P.V is on the tensor cores (the tile in
// flight holds its stage, so a ring of three keeps a load ahead). O, m
// and l stay in fp32 registers; out and lse are written once. Under
// `causal` an item's loop stops at the diagonal. Keys past T are masked
// (TMA reads them as zeros); rows past S are not stored.
//
// The contract is K1's and K4's (flash_attention_fwd.cu,
// flash_attention_bh_fwd.cu): scores are fp32 dots times `scale`, masked
// -1e30 under the top-left causal mask; p is rounded to bf16 before P.V;
// out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)), fp32 (B, H, S).

#pragma once

#include <algorithm>

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace ffwg {

// key rows a K/V tile and stages of the K/V ring, by head dim, picked by
// timing on the card (PERF.md, "Tiles"). O is D / 2 registers a
// thread (32 at D 64, 128 at D 256), S BK / 2. A tile in flight while the
// next is scored holds a stage, so a ring of two keeps no load ahead.
template <int D>
struct FwdTiles {
  static constexpr int kBK = D == 64 ? 128 : D == 128 ? 128 : 32;
  static constexpr int kStages = D == 64 ? 4 : D == 128 ? 3 : 4;
  // Q tiles in flight: two (the next item's loads while this one runs)
  // where they fit beside the K/V ring, else one
  static constexpr int kQBufs =
      (size_t)2 * kBM * D * 2 + (size_t)2 * kStages * kBK * D * 2 + 2048 <=
              ffflash::kMaxSmemBytes
          ? 2
          : 1;
};

template <int D>
constexpr size_t fwd_wg_smem() {
  using T = FwdTiles<D>;
  return (size_t)T::kQBufs * kBM * D * 2 +
         (size_t)2 * T::kStages * T::kBK * D * 2 + 1024 /* barriers */ +
         1024 /* alignment */;
}

// One tile's online softmax on this thread's scores sc (two rows, r0 and
// r0 + 8; fp32 dots of keys k0.. in the accumulator layout): masks what
// `edge` says a row may not see, folds the tile into the running max m
// and sum l (log2 units), leaves p = 2^(s - m) in sc and the rows'
// rescale factors in corr
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], bool edge,
                                             int k0, int Tk, int causal,
                                             int r0, int cq,
                                             float scale_log2) {
  const float masked = ffflash::kNegInf * kLog2e;  // -1e30, log2 units
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
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
    corr[hf] = exp2_approx(m[hf] - mx[hf]);
    m[hf] = mx[hf];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2_approx(sc[4 * j + 2 * hf + e] - m[hf]);
        sum[hf] += p;
        sc[4 * j + 2 * hf + e] = p;
      }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 1);
    sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 2);
    l[hf] = l[hf] * corr[hf] + sum[hf];
  }
}

template <class Tag, int D, int BK, int Stages, int QBufs>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int B, int S, int Tk, int H,
                       int Hkv, int causal, float scale) {
  constexpr int kQBytes = kBM * D * 2;
  constexpr int kKVBytes = BK * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  uint8_t* sQ = base;                               // QBufs tiles
  uint8_t* sK = sQ + QBufs * kQBytes;               // Stages tiles
  uint8_t* sV = sK + Stages * kKVBytes;             // Stages tiles
  uint64_t* q_full = (uint64_t*)(sV + Stages * kKVBytes);
  uint64_t* q_empty = q_full + QBufs;
  uint64_t* full = q_empty + QBufs;
  uint64_t* empty = full + Stages;

  const int BH = B * H;
  const int nq = (S + kBM - 1) / kBM;
  const int items = BH * nq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < QBufs; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], kConsumers);
    }
    for (int s = 0; s < Stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer warpgroup: one thread
    producer_regs();                // issues every load
    if (warp == kConsumers / 32 && lane == 0) {
      int it = 0, n = 0;  // K/V tiles and items loaded so far
      for (int r = 0, t; (t = zigzag_item(r, items)) >= 0; ++r) {
        if (t >= items) continue;
        int bh, q0;
        q_tile_item(t, BH, nq, bh, q0);
        const int b = bh / H, h = bh % H, g = h / (H / Hkv);
        const int kend = causal ? min(Tk, q0 + kBM) : Tk;
        const int nk = (kend + BK - 1) / BK;
        const int qb = n % QBufs;
        if (n >= QBufs) mbar_wait(&q_empty[qb], ((n / QBufs) - 1) & 1);
        ++n;
        mbar_expect_tx(&q_full[qb], kQBytes);
        __nv_bfloat16* q_s = (__nv_bfloat16*)(sQ + qb * kQBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(q_s + c * kBM * 64, &map_q, &q_full[qb], c * 64, h,
                      q0, b);
        for (int i = 0; i < nk; ++i, ++it) {
          const int s = it % Stages;
          if (it >= Stages) mbar_wait(&empty[s], ((it / Stages) - 1) & 1);
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
    }
  } else {
    consumer_regs();
    // consumers: warpgroup wg takes rows q0 + 64 wg ..; this thread rows
    // r0 and r0 + 8, columns 8 j + cq + {0, 1} of each 8-column group j.
    // Tile i's S = Q.K_i^T is issued together with tile i - 1's O += P.V,
    // and tile i's softmax runs while that P.V is on the tensor cores.
    const int wg = warp / 4;
    const int cq = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2e;
    int it = 0, n = 0;  // K/V tiles and items consumed so far
    for (int r = 0, t; (t = zigzag_item(r, items)) >= 0; ++r) {
      if (t >= items) continue;
      int bh, q0;
      q_tile_item(t, BH, nq, bh, q0);
      const int b = bh / H, h = bh % H;
      const int kend = causal ? min(Tk, q0 + kBM) : Tk;
      const int nk = (kend + BK - 1) / BK;
      const int r0 = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
      const int qb = n % QBufs;
      const __nv_bfloat16* q_s = (const __nv_bfloat16*)(sQ + qb * kQBytes);
      // a key of tile i may be hidden from a row of this warpgroup
      auto edge = [&](int k0) {
        return k0 + BK > Tk || (causal && k0 + BK - 1 > q0 + wg * 64);
      };
      float o[D / 2];
#pragma unroll
      for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
      float sc[BK / 2];
      uint32_t pa[BK / 16][4];  // P of the previous tile, bf16

      mbar_wait(&q_full[qb], (n / QBufs) & 1);
      ++n;
      {  // tile 0: S, then its softmax (O is still zero)
        const __nv_bfloat16* k_s =
            (const __nv_bfloat16*)(sK + (it % Stages) * kKVBytes);
        mbar_wait(&full[it % Stages], (it / Stages) & 1);
        fence_regs(sc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BK>(sc, kmajor<kBM>(q_s, wg * 64, kk),
                       kmajor<BK>(k_s, 0, kk), kk > 0);
        wg_commit();
        wg_wait0();
        fence_regs(sc);
        if (nk == 1) mbar_arrive(&q_empty[qb]);
        softmax_tile<BK>(sc, m, l, corr, edge(0), 0, Tk, causal, r0, cq,
                         scale_log2);
        pack_tile<BK>(pa, sc);
        ++it;
      }
      for (int i = 1; i < nk; ++i, ++it) {
        const int s = it % Stages, sp = (it - 1) % Stages;
        const __nv_bfloat16* k_s = (const __nv_bfloat16*)(sK + s * kKVBytes);
        const __nv_bfloat16* v_p = (const __nv_bfloat16*)(sV + sp * kKVBytes);
        mbar_wait(&full[s], (it / Stages) & 1);
        fence_regs(sc);
        fence_regs(o);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BK>(sc, kmajor<kBM>(q_s, wg * 64, kk),
                       kmajor<BK>(k_s, 0, kk), kk > 0);
        wg_commit();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)  // O += P.V, tile i - 1
          wgmma_rs<D>(o, pa[kk], mnmajor<BK>(v_p, kk), 1);
        wg_commit();
        wg_wait1();  // S done; P.V may still run
        fence_regs(sc);
        // the item's last use of its Q tile: the producer may refill it
        if (i == nk - 1) mbar_arrive(&q_empty[qb]);
        softmax_tile<BK>(sc, m, l, corr, edge(i * BK), i * BK, Tk, causal,
                         r0, cq, scale_log2);
        wg_wait0();
        fence_regs(o);
        fence_regs(pa);
        mbar_arrive(&empty[sp]);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            o[4 * j + 2 * hf] *= corr[hf];
            o[4 * j + 2 * hf + 1] *= corr[hf];
          }
        pack_tile<BK>(pa, sc);
      }
      {  // the last tile's P.V
        const int sp = (it - 1) % Stages;
        const __nv_bfloat16* v_p = (const __nv_bfloat16*)(sV + sp * kKVBytes);
        fence_regs(o);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<D>(o, pa[kk], mnmajor<BK>(v_p, kk), 1);
        wg_commit();
        wg_wait0();
        fence_regs(o);
        fence_regs(pa);
        mbar_arrive(&empty[sp]);
      }

#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + 8 * hf;
        if (row >= S) continue;
        const float l_safe = fmaxf(l[hf], 1e-30f);
        __nv_bfloat16* dst = out + ffflash::elem<D>(b, S, H, h, row, cq);
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
}

// Launch the body on contiguous bf16 q (B, S, H, D), k/v (B, T, Hkv, D),
// out like q, fp32 lse (B, H, S). cudaErrorInvalidValue when TMA refuses
// a map (e.g. a base address that is not 16-byte aligned), otherwise the
// launch's cudaGetLastError().
template <class Tag, int D>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                     void* lse, int B, int S, int Tk, int H, int Hkv,
                     int causal, float scale, cudaStream_t stream) {
  constexpr int BK = FwdTiles<D>::kBK;
  constexpr size_t smem = fwd_wg_smem<D>();
  static_assert(smem <= ffflash::kMaxSmemBytes,
                "tiles do not fit shared memory");
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, S, H, D, kBM) ||
      !make_map(&mk, k, B, Tk, Hkv, D, BK) ||
      !make_map(&mv, v, B, Tk, Hkv, D, BK))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_wgmma_kernel<Tag, D, BK, FwdTiles<D>::kStages,
                                       FwdTiles<D>::kQBufs>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int items = B * H * ((S + kBM - 1) / kBM);
  const int grid = std::min(items, sm_count());
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  kernel<<<grid, kWgThreads, smem, stream>>>(mq, mk, mv,
                                              (__nv_bfloat16*)out,
                                              (float*)lse, B, S, Tk, H, Hkv,
                                              causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace ffwg
