// The tensor-core flash-attention forward body (bf16; head dims 64, 128
// and 256, and the head-major 48, 80 and 96 on zero-padded 64 /
// 128-column tiles, flash_wgmma.cuh): wgmma fed by TMA, or at the
// head-major D 100 (rows TMA cannot stride) by the producer warpgroup's
// cp.async copies into the same tiles (cp_rows, CpAsyncPipe). One body
// for three kernels, each instantiating it under its own layout tag
// (flash_wgmma.cuh): K1 (flash_attention_fwd.cu, FlatLayout), K4's
// forward (flash_attention_bh_fwd.cu, HeadMajor) and K5, the ring step
// (the same source, HeadMajorCarry), the head-major two at D 48, 64, 80,
// 96, 100, 128 and 256.
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
// (full / empty mbarriers for both; at D 100 all 128 producer threads
// copy and arrive). Each consumer warpgroup runs S =
// Q.K^T on wgmma (both operands in shared memory), the online softmax on
// the accumulator registers, then O += P.V on wgmma with P (rounded to
// bf16) as the A operand straight from those registers and V as the
// transposed (MN-major) B operand. The two products overlap across
// tiles: tile i's S is issued together with tile i - 1's P.V, and tile
// i's softmax runs while that P.V is on the tensor cores (the tile in
// flight holds its stage, so a ring of three keeps a load ahead). O, m
// and l stay in fp32 registers; out and lse are written once. Under
// `causal` an item's loop stops at the diagonal. Keys past T are masked
// (TMA, or the zero-filling copy, reads them as zeros); rows past S and
// columns past D are not stored.
//
// The contract is K1's and K4's (flash_attention_fwd.cu,
// flash_attention_bh_fwd.cu): scores are fp32 dots times `scale`, masked
// -1e30 under the top-left causal mask; p is rounded to bf16 before P.V;
// out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)), fp32 (B, H, S).
// Under the HeadMajorCarry tag (K5, one ring step) an item starts from the
// caller's fp32 m, l (BH, S) and acc (BH, S, D) instead of (-inf, 0, 0):
// m in log2 units (m x log2 e), acc straight into the accumulator layout
// (two floats a load, columns below D only: at D 100 the N 104
// accumulators' columns 100..103 stay zero) and rescaled after tile 0; at
// its end it writes (m x ln 2, l, acc) back in place, unnormalised, the
// columns below D only, and no out or lse.

#pragma once

#include <algorithm>
#include <cstring>
#include <type_traits>

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace ffwg {

// key rows a K/V tile and stages of the K/V ring, by tile width DP =
// pad64(D), picked by timing on the card (PERF.md, "Tiles"). O is D / 2
// registers a thread (32 at D 64, 128 at D 256), S BK / 2. A tile in
// flight while the next is scored holds a stage, so a ring of two keeps
// no load ahead.
template <int D>
struct FwdTiles {
  static constexpr int DP = pad64(D);
  static constexpr int kBK = DP == 64 ? 128 : DP == 128 ? 128 : 32;
  static constexpr int kStages = DP == 64 ? 4 : DP == 128 ? 3 : 4;
  // Q tiles in flight: two (the next item's loads while this one runs)
  // where they fit beside the K/V ring, else one
  static constexpr int kQBufs =
      (size_t)2 * kBM * DP * 2 + (size_t)2 * kStages * kBK * DP * 2 +
                  2048 <=
              ffflash::kMaxSmemBytes
          ? 2
          : 1;
};

template <int D>
constexpr size_t fwd_wg_smem() {
  using T = FwdTiles<D>;
  return (size_t)T::kQBufs * kBM * T::DP * 2 +
         (size_t)2 * T::kStages * T::kBK * T::DP * 2 + 1024 /* barriers */ +
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
                       float* __restrict__ lse, float* __restrict__ m_io,
                       float* __restrict__ l_io, float* __restrict__ acc_io,
                       int B, int S, int Tk, int H, int Hkv, int causal,
                       float scale, const RowSrc rows) {
  constexpr bool kCarry = std::is_same<Tag, HeadMajorCarry>::value;
  constexpr bool kCp = rows_by_cp_async(D);
  // tiles DP columns wide; Q.K^T stops after ceil(D / 16) k-steps, P.V
  // has N = NV (vn)
  constexpr int DP = pad64(D), KD = (D + 15) / 16, NV = vn(D);
  static_assert(D % 4 == 0 && (DP <= 128 || DP == D),
                "a head dim the tile layout does not take");
  constexpr int kQBytes = kBM * DP * 2;
  constexpr int kKVBytes = BK * DP * 2;
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

  // a tile's producer arrivals: one TMA thread, or every producer thread
  constexpr int kArrivals = kCp ? 128 : 1;
  if constexpr (kCp)  // columns D .. DP - 1, which the copies never write
    zero_smem(sQ, (size_t)QBufs * kQBytes + 2 * Stages * kKVBytes);
  if (threadIdx.x == 0) {
    for (int i = 0; i < QBufs; ++i) {
      mbar_init(&q_full[i], kArrivals);
      mbar_init(&q_empty[i], kConsumers);
    }
    for (int s = 0; s < Stages; ++s) {
      mbar_init(&full[s], kArrivals);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer warpgroup: one thread
    producer_regs();                // issues every TMA load, or all 128
    if (kCp || (warp == kConsumers / 32 && lane == 0)) {  // copy
      const int pt = threadIdx.x - kConsumers;
      CpAsyncPipe pipe;
      // wait for a buffer to be free
      auto acquire = [&](uint64_t* bar, uint32_t parity) {
        if constexpr (kCp)
          pipe.wait(bar, parity);
        else
          mbar_wait(bar, parity);
      };
      int it = 0, n = 0;  // K/V tiles and items loaded so far
      for (int r = 0, t; (t = zigzag_item(r, items)) >= 0; ++r) {
        if (t >= items) continue;
        int bh, q0;
        q_tile_item(t, BH, nq, bh, q0);
        const int b = bh / H, h = bh % H, g = h / (H / Hkv);
        const int kend = causal ? min(Tk, q0 + kBM) : Tk;
        const int nk = (kend + BK - 1) / BK;
        const int qb = n % QBufs;
        if (n >= QBufs) acquire(&q_empty[qb], ((n / QBufs) - 1) & 1);
        ++n;
        __nv_bfloat16* q_s = (__nv_bfloat16*)(sQ + qb * kQBytes);
        if constexpr (kCp) {
          cp_rows<D, kBM>(q_s, rows.q, b, S, H, h, q0, pt);
          pipe.commit(&q_full[qb]);
        } else {
          mbar_expect_tx(&q_full[qb], kQBytes);
#pragma unroll
          for (int c = 0; c < DP / 64; ++c)
            tma_load_4d(q_s + c * kBM * 64, &map_q, &q_full[qb], c * 64, h,
                        q0, b);
        }
        for (int i = 0; i < nk; ++i, ++it) {
          const int s = it % Stages;
          if (it >= Stages) acquire(&empty[s], ((it / Stages) - 1) & 1);
          __nv_bfloat16* k_s = (__nv_bfloat16*)(sK + s * kKVBytes);
          __nv_bfloat16* v_s = (__nv_bfloat16*)(sV + s * kKVBytes);
          if constexpr (kCp) {
            cp_rows<D, BK>(k_s, rows.k, b, Tk, Hkv, g, i * BK, pt);
            cp_rows<D, BK>(v_s, rows.v, b, Tk, Hkv, g, i * BK, pt);
            pipe.commit(&full[s]);
          } else {
            mbar_expect_tx(&full[s], 2 * kKVBytes);
#pragma unroll
            for (int c = 0; c < DP / 64; ++c) {
              tma_load_4d(k_s + c * BK * 64, &map_k, &full[s], c * 64, g,
                          i * BK, b);
              tma_load_4d(v_s + c * BK * 64, &map_v, &full[s], c * 64, g,
                          i * BK, b);
            }
          }
        }
      }
      if constexpr (kCp) pipe.drain();
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
      float o[NV / 2];
#pragma unroll
      for (int x = 0; x < NV / 2; ++x) o[x] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
      if constexpr (kCarry) {  // the carried state of rows r0, r0 + 8
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = r0 + 8 * hf;
          if (row >= S) continue;
          const size_t idx = (size_t)bh * S + row;
          m[hf] = m_io[idx] * kLog2e;
          l[hf] = l_io[idx];
          // columns 8 j + cq, + 1 of acc's row, 8 bytes a load; the
          // accumulators past D (100..103 at N 104) stay zero
          const float* src = acc_io + idx * D + cq;
#pragma unroll
          for (int j = 0; j < NV / 8; ++j)
            if (D % 8 == 0 || 8 * j + cq < D) {
              const float2 a = *reinterpret_cast<const float2*>(src + 8 * j);
              o[4 * j + 2 * hf] = a.x;
              o[4 * j + 2 * hf + 1] = a.y;
            }
        }
      }
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
        for (int kk = 0; kk < KD; ++kk)
          wgmma_ss<BK>(sc, kmajor<kBM>(q_s, wg * 64, kk),
                       kmajor<BK>(k_s, 0, kk), kk > 0);
        wg_commit();
        wg_wait0();
        fence_regs(sc);
        if (nk == 1) mbar_arrive(&q_empty[qb]);
        softmax_tile<BK>(sc, m, l, corr, edge(0), 0, Tk, causal, r0, cq,
                         scale_log2);
        if constexpr (kCarry) {  // O holds the carried acc
#pragma unroll
          for (int j = 0; j < NV / 8; ++j)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              o[4 * j + 2 * hf] *= corr[hf];
              o[4 * j + 2 * hf + 1] *= corr[hf];
            }
        }
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
        for (int kk = 0; kk < KD; ++kk)
          wgmma_ss<BK>(sc, kmajor<kBM>(q_s, wg * 64, kk),
                       kmajor<BK>(k_s, 0, kk), kk > 0);
        wg_commit();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)  // O += P.V, tile i - 1
          wgmma_rs<NV>(o, pa[kk], mnmajor<BK>(v_p, kk), 1);
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
        for (int j = 0; j < NV / 8; ++j)
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
          wgmma_rs<NV>(o, pa[kk], mnmajor<BK>(v_p, kk), 1);
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
        if constexpr (kCarry) {  // the statistics, for the next ring step
          const size_t idx = (size_t)bh * S + row;
          float* dst = acc_io + idx * D + cq;
#pragma unroll
          for (int j = 0; j < NV / 8; ++j)
            if (D % 8 == 0 || 8 * j + cq < D)  // no column past D
              *reinterpret_cast<float2*>(dst + 8 * j) =
                  make_float2(o[4 * j + 2 * hf], o[4 * j + 2 * hf + 1]);
          if (lane % 4 == 0) {
            m_io[idx] = m[hf] * kLn2;
            l_io[idx] = l[hf];
          }
          continue;
        }
        const float l_safe = fmaxf(l[hf], 1e-30f);
        __nv_bfloat16* dst = out + ffflash::elem<D>(b, S, H, h, row, cq);
#pragma unroll
        for (int j = 0; j < (D + 7) / 8; ++j)
          if (D % 8 == 0 || 8 * j + cq < D)  // no column past D
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
// out like q, fp32 lse (B, H, S); under HeadMajorCarry fp32 m, l (B, S)
// and acc (B, S, D) instead of out and lse. cudaErrorInvalidValue when TMA
// refuses a map (e.g. a base address that is not 16-byte aligned), at a
// head dim loaded by cp.async a base is not 8-byte aligned (out: 4), or
// under HeadMajorCarry acc is not 8-byte aligned (its two-float loads) or
// m, l not 4-byte; otherwise the launch's cudaGetLastError().
template <class Tag, int D>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                     void* lse, int B, int S, int Tk, int H, int Hkv,
                     int causal, float scale, cudaStream_t stream,
                     void* m = nullptr, void* l = nullptr,
                     void* acc = nullptr) {
  constexpr int BK = FwdTiles<D>::kBK;
  constexpr size_t smem = fwd_wg_smem<D>();
  static_assert(smem <= ffflash::kMaxSmemBytes,
                "tiles do not fit shared memory");
  if constexpr (std::is_same<Tag, HeadMajorCarry>::value) {
    if (!aligned(acc, 8) || !aligned(m, 4) || !aligned(l, 4))
      return (int)cudaErrorInvalidValue;
  }
  CUtensorMap mq, mk, mv;
  RowSrc src{};
  if constexpr (rows_by_cp_async(D)) {
    if (!aligned(q, 8) || !aligned(k, 8) || !aligned(v, 8) ||
        !aligned(out, 4))
      return (int)cudaErrorInvalidValue;
    std::memset(&mq, 0, sizeof mq);
    mk = mv = mq;
    src = {(const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
           (const __nv_bfloat16*)v, nullptr};
  } else if (!make_map(&mq, q, B, S, H, D, kBM) ||
             !make_map(&mk, k, B, Tk, Hkv, D, BK) ||
             !make_map(&mv, v, B, Tk, Hkv, D, BK)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = flash_fwd_wgmma_kernel<Tag, D, BK, FwdTiles<D>::kStages,
                                       FwdTiles<D>::kQBufs>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int items = B * H * ((S + kBM - 1) / kBM);
  const int grid = std::min(items, sm_count());
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  kernel<<<grid, kWgThreads, smem, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)out, (float*)lse, (float*)m, (float*)l,
      (float*)acc, B, S, Tk, H, Hkv, causal, scale, src);
  return (int)cudaGetLastError();
}

}  // namespace ffwg
