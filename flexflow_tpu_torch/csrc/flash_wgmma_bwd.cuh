// The tensor-core flash-attention backward bodies (bf16, head dims 64,
// 128 and 256): wgmma fed by TMA, one kernel for dq and one for dk/dv.
// Each body serves two kernels, instantiated under their own layout tags
// (flash_wgmma.cuh): K2 (flash_attention_bwd.cu, FlatLayout, GQA summed
// in the block) and K4's backward (flash_attention_bh_bwd.cu, HeadMajor).
//
// The contract is K2's and K4's: both recompute the scores tile by tile
// from the caller's fp32 lse, with delta = sum_d dO * O from the caller:
//   p = exp(s - lse), ds = p (dp - delta) scale, dp = dO . v,
//   dq = ds (bf16) . k, dk = ds^T (bf16) . q, dv = p^T (bf16) . dO,
// every sum in fp32 and each result written once in bf16.
//
// Both grids are persistent (flash_wgmma.cuh): one block per SM takes
// its work items in zigzag rounds, heaviest first, and the producer loads
// the next item's tiles while the consumers finish this one. Where the
// registers allow (kOverlap: dq up to D 128, dk/dv at D 64), a tile's
// scores are issued together with the previous tile's products and its
// ds computed while those run, as the forward does.
// dq: an item is 128 query rows of one (b, h), two consumer warpgroups of
// 64; the producer loads the item's Q and dO into one of QBufs buffers
// and its K/V tiles of BK keys into a ring of Stages stages that runs on
// across items. Per tile: S = Q.K^T and dP = dO.V^T (shared x shared),
// p = exp(s - lse), ds = p (dp - delta) scale, dq += ds.K (ds from
// registers, K transposed).
// dk/dv: an item is 128 keys of one (b, g) as two warpgroups of 64 (at
// D 256: 64 keys, each warpgroup half of dk's and dv's columns; see
// dkv_keys), K and V loaded into one of KVBufs buffers; the producer
// walks (query head of the GQA group) x (live query tile of BQ rows),
// loading Q and dO by TMA and lse / delta (scaled to log2 units) by plain
// loads into a ring of Stages stages.
// Per tile: S^T = K.Q^T and dP^T = V.dO^T, so p^T and ds^T sit in the
// accumulator with keys as rows; dv += p^T.dO and dk += ds^T.Q, each from
// registers with dO and Q transposed. The group's heads are summed inside
// the block: no atomics, the same bits from run to run.

#pragma once

#include <algorithm>

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace ffwg {

// dq: key rows a K/V tile and stages of its ring, by head dim, picked by
// timing on the card (PERF.md, "Tiles"). dq's accumulator is D / 2
// registers a thread (128 at D 256), S and dP BK / 2 each. A tile in
// flight while the next is scored holds a stage, so the ring needs three
// to keep a load ahead. Q/dO buffers: two where they fit beside the ring,
// else one
template <int D>
struct DqTiles {
  static constexpr int kBK = D == 64 ? 128 : D == 128 ? 64 : 32;
  static constexpr int kStages = D == 64 ? 4 : D == 128 ? 4 : 2;
  static constexpr int kQBufs =
      (size_t)2 * 2 * kBM * D * 2 + (size_t)2 * kStages * kBK * D * 2 +
                  2048 <=
              ffflash::kMaxSmemBytes
          ? 2
          : 1;
  // overlap a tile's ds.K with the next tile's scores where the tile in
  // flight fits the registers: at D 256 it spills (ptxas -v)
  static constexpr bool kOverlap = D <= 128;
};

template <int D>
constexpr size_t dq_wg_smem() {
  using T = DqTiles<D>;
  return (size_t)T::kQBufs * 2 * kBM * D * 2 +
         (size_t)2 * T::kStages * T::kBK * D * 2 + 1024 + 1024;
}

// dk/dv: keys an item. At D 64 and 128 each warpgroup takes 64 keys; at
// D 256 both take the same 64 keys and split the columns of dk and dv
// (128 each), since two 64 x 256 fp32 accumulators would need 256
// registers a thread; each computes the whole S^T and dP^T (their D-long
// dots) for its half
template <int D>
__host__ __device__ constexpr int dkv_keys() { return D > 128 ? 64 : kBM; }

// dk/dv: query rows a Q/dO tile, stages of its ring (picked by timing on
// the card, PERF.md "Tiles"), K/V buffers
template <int D>
struct DkvTiles {
  static constexpr int kBQ = 64;
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr size_t kRing =
      (size_t)2 * kStages * kBQ * D * 2 + (size_t)2 * kStages * kBQ * 4;
  static constexpr int kKVBufs =
      (size_t)2 * 2 * dkv_keys<D>() * D * 2 + kRing + 2048 <=
              ffflash::kMaxSmemBytes
          ? 2
          : 1;
  // overlap a tile's products with the next tile's scores where p^T and
  // ds^T in flight beside dk and dv fit the registers: at D 128 and 256
  // they spill (ptxas -v)
  static constexpr bool kOverlap = D <= 64;
};

template <int D>
constexpr size_t dkv_wg_smem() {
  using T = DkvTiles<D>;
  return (size_t)T::kKVBufs * 2 * dkv_keys<D>() * D * 2 + T::kRing + 1024 +
         1024;
}

template <class Tag, int D, int BK, int Stages, int QBufs>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int B, int S, int Tk,
                      int H, int Hkv, int causal, float scale) {
  constexpr int kQBytes = kBM * D * 2;
  constexpr int kKVBytes = BK * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  uint8_t* sQ = base;                          // QBufs x (Q, dO) tiles
  uint8_t* sK = base + QBufs * 2 * kQBytes;    // Stages tiles
  uint8_t* sV = sK + Stages * kKVBytes;        // Stages tiles
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
        mbar_expect_tx(&q_full[qb], 2 * kQBytes);
        __nv_bfloat16* q_s = (__nv_bfloat16*)(sQ + qb * 2 * kQBytes);
        __nv_bfloat16* o_s = q_s + kBM * D;  // dO
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(q_s + c * kBM * 64, &map_q, &q_full[qb], c * 64, h,
                      q0, b);
          tma_load_4d(o_s + c * kBM * 64, &map_do, &q_full[qb], c * 64, h,
                      q0, b);
        }
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
    // consumers: rows r0 and r0 + 8 of this thread, columns 8 j + cq + e.
    // Tile i's S and dP are issued together with tile i - 1's dq += ds.K,
    // and tile i's ds is computed while that product runs.
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
      const __nv_bfloat16* q_s =
          (const __nv_bfloat16*)(sQ + qb * 2 * kQBytes);
      const __nv_bfloat16* o_s = q_s + kBM * D;  // dO
      float row_lse[2], row_delta[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + 8 * hf;
        row_lse[hf] = row < S ? lse[(size_t)bh * S + row] * kLog2e : 0.f;
        row_delta[hf] = row < S ? delta[(size_t)bh * S + row] : 0.f;
      }
      float acc[D / 2];
#pragma unroll
      for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
      float sc[BK / 2], dp[BK / 2];
      uint32_t da[BK / 16][4];  // ds of the previous tile, bf16

      // tile i's ds (fp32, into sc) from its S and dP
      auto ds_tile = [&](int i) {
        const int k0 = i * BK;
        const bool edge =
            k0 + BK > Tk || (causal && k0 + BK - 1 > q0 + wg * 64);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 4 * j + 2 * hf + e;
              float p = exp2_approx(sc[x] * scale_log2 - row_lse[hf]);
              if (edge) {
                const int kpos = k0 + 8 * j + cq + e;
                if (kpos >= Tk || (causal && kpos > r0 + 8 * hf)) p = 0.f;
              }
              sc[x] = p * (dp[x] - row_delta[hf]) * scale;
            }
      };
      // S = Q.K^T and dP = dO.V^T of the tile in stage s
      auto scores = [&](int s) {
        const __nv_bfloat16* k_s = (const __nv_bfloat16*)(sK + s * kKVBytes);
        const __nv_bfloat16* v_s = (const __nv_bfloat16*)(sV + s * kKVBytes);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BK>(sc, kmajor<kBM>(q_s, wg * 64, kk),
                       kmajor<BK>(k_s, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BK>(dp, kmajor<kBM>(o_s, wg * 64, kk),
                       kmajor<BK>(v_s, 0, kk), kk > 0);
        wg_commit();
      };
      // dq += ds.K with the ds in da and the K tile in stage s
      auto dq_product = [&](int s) {
        const __nv_bfloat16* k_s = (const __nv_bfloat16*)(sK + s * kKVBytes);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<D>(acc, da[kk], mnmajor<BK>(k_s, kk), 1);
        wg_commit();
      };

      mbar_wait(&q_full[qb], (n / QBufs) & 1);
      ++n;
      if constexpr (!DqTiles<D>::kOverlap) {
        for (int i = 0; i < nk; ++i, ++it) {  // tile by tile
          const int s = it % Stages;
          mbar_wait(&full[s], (it / Stages) & 1);
          fence_regs(sc);
          fence_regs(dp);
          wg_fence();
          scores(s);
          wg_wait0();
          fence_regs(sc);
          fence_regs(dp);
          if (i == nk - 1) mbar_arrive(&q_empty[qb]);
          ds_tile(i);
          pack_tile<BK>(da, sc);
          fence_regs(acc);
          wg_fence();
          dq_product(s);
          wg_wait0();
          fence_regs(acc);
          fence_regs(da);
          mbar_arrive(&empty[s]);
        }
      } else {
        {  // tile 0: S and dP, then its ds
          mbar_wait(&full[it % Stages], (it / Stages) & 1);
          fence_regs(sc);
          fence_regs(dp);
          wg_fence();
          scores(it % Stages);
          wg_wait0();
          fence_regs(sc);
          fence_regs(dp);
          if (nk == 1) mbar_arrive(&q_empty[qb]);
          ds_tile(0);
          pack_tile<BK>(da, sc);
          ++it;
        }
        for (int i = 1; i < nk; ++i, ++it) {
          const int s = it % Stages, sp = (it - 1) % Stages;
          mbar_wait(&full[s], (it / Stages) & 1);
          fence_regs(sc);
          fence_regs(dp);
          fence_regs(acc);
          wg_fence();
          scores(s);
          dq_product(sp);  // tile i - 1's
          wg_wait1();      // S and dP done; ds.K may still run
          fence_regs(sc);
          fence_regs(dp);
          // the item's last use of its Q and dO tiles
          if (i == nk - 1) mbar_arrive(&q_empty[qb]);
          ds_tile(i);
          wg_wait0();
          fence_regs(acc);
          fence_regs(da);
          mbar_arrive(&empty[sp]);
          pack_tile<BK>(da, sc);
        }
        {  // the last tile's ds.K
          const int sp = (it - 1) % Stages;
          fence_regs(acc);
          wg_fence();
          dq_product(sp);
          wg_wait0();
          fence_regs(acc);
          fence_regs(da);
          mbar_arrive(&empty[sp]);
        }
      }

#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + 8 * hf;
        if (row >= S) continue;
        __nv_bfloat16* dst = dq + ffflash::elem<D>(b, S, H, h, row, cq);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * hf],
                                    acc[4 * j + 2 * hf + 1]);
      }
    }
  }
}

// dk/dv work item t of nkt key tiles x BG kv heads (b * Hkv + g), key
// tile 0 (the heaviest under `causal`) first: key tile t / BG of kv head
// t % BG
__device__ __forceinline__ void k_tile_item(int t, int BG, int bn, int& bg,
                                            int& k0) {
  bg = t % BG;
  k0 = (t / BG) * bn;
}

template <class Tag, int D, int BQ, int Stages, int KVBufs>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int B, int S, int Tk,
                       int H, int Hkv, int causal, float scale) {
  constexpr int BN = dkv_keys<D>();
  constexpr int DW = D > 128 ? D / 2 : D;  // dk / dv columns a warpgroup
  constexpr int kKBytes = BN * D * 2;
  constexpr int kQBytes = BQ * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  uint8_t* sKV = base;                       // KVBufs x (K, V) tiles
  uint8_t* sQ = base + KVBufs * 2 * kKBytes;     // Stages tiles
  uint8_t* sO = sQ + Stages * kQBytes;           // Stages dO tiles
  float* sL = (float*)(sO + Stages * kQBytes);   // Stages x BQ lse, log2
  float* sD = sL + Stages * BQ;                  // Stages x BQ delta
  uint64_t* kv_full = (uint64_t*)(sD + Stages * BQ);
  uint64_t* kv_empty = kv_full + KVBufs;
  uint64_t* full = kv_empty + KVBufs;
  uint64_t* empty = full + Stages;

  const int BG = B * Hkv;
  const int rep = H / Hkv;
  const int nq = (S + BQ - 1) / BQ;
  const int items = BG * ((Tk + BN - 1) / BN);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < KVBufs; ++i) {
      mbar_init(&kv_full[i], 1);
      mbar_init(&kv_empty[i], kConsumers);
    }
    for (int s = 0; s < Stages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // an item's live query tiles a head, from the diagonal on under
  // `causal`; an item with none (keys past every query) loads nothing and
  // takes no buffer: its dk and dv are zeros
  auto live_from = [&](int k0) { return causal ? min(k0 / BQ, nq) : 0; };

  if (warp >= kConsumers / 32) {  // the producer warpgroup: its first
    producer_regs();                // warp loads, the others idle
    if (warp == kConsumers / 32) {
      int it = 0, n = 0;  // Q/dO tiles and K/V items loaded so far
      for (int r = 0, t; (t = zigzag_item(r, items)) >= 0; ++r) {
        if (t >= items) continue;
        int bg, k0;
        k_tile_item(t, BG, BN, bg, k0);
        const int b = bg / Hkv, g = bg % Hkv;
        const int iq0 = live_from(k0);
        const int live = nq - iq0;
        if (live == 0) continue;
        const int kb = n % KVBufs;
        if (lane == 0) {
          if (n >= KVBufs) mbar_wait(&kv_empty[kb], ((n / KVBufs) - 1) & 1);
          mbar_expect_tx(&kv_full[kb], 2 * kKBytes);
          __nv_bfloat16* k_s = (__nv_bfloat16*)(sKV + kb * 2 * kKBytes);
          __nv_bfloat16* v_s = k_s + BN * D;
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(k_s + c * BN * 64, &map_k, &kv_full[kb], c * 64, g,
                        k0, b);
            tma_load_4d(v_s + c * BN * 64, &map_v, &kv_full[kb], c * 64, g,
                        k0, b);
          }
        }
        ++n;
        for (int j = 0; j < rep * live; ++j, ++it) {
          const int s = it % Stages;
          const int h = g * rep + j / live;
          const int q0 = (iq0 + j % live) * BQ;
          if (it >= Stages) mbar_wait(&empty[s], ((it / Stages) - 1) & 1);
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
              tma_load_4d(q_s + c * BQ * 64, &map_q, &full[s], c * 64, h,
                          q0, b);
              tma_load_4d(o_s + c * BQ * 64, &map_do, &full[s], c * 64, h,
                          q0, b);
            }
          } else {
            mbar_arrive(&full[s]);
          }
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
    const int cq = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2e;
    int it = 0, n = 0;  // Q/dO tiles and K/V items consumed so far
    for (int r = 0, t; (t = zigzag_item(r, items)) >= 0; ++r) {
      if (t >= items) continue;
      int bg, k0;
      k_tile_item(t, BG, BN, bg, k0);
      const int b = bg / Hkv, g = bg % Hkv;
      const int iq0 = live_from(k0);
      const int live = nq - iq0;
      const int kr0 = k0 + key_off + (warp % 4) * 16 + lane / 4;
      float dka[DW / 2], dva[DW / 2];
#pragma unroll
      for (int i = 0; i < DW / 2; ++i) dka[i] = dva[i] = 0.f;
      if (live > 0) {
        const int kb = n % KVBufs;
        const __nv_bfloat16* k_s =
            (const __nv_bfloat16*)(sKV + kb * 2 * kKBytes);
        const __nv_bfloat16* v_s = k_s + BN * D;
        float st[BQ / 2], dpt[BQ / 2];
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // the previous tile's
        // S^T = K.Q^T and dP^T = V.dO^T of the tile in stage s
        auto scores = [&](int s) {
          const __nv_bfloat16* q_s = (const __nv_bfloat16*)(sQ + s * kQBytes);
          const __nv_bfloat16* o_s = (const __nv_bfloat16*)(sO + s * kQBytes);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss<BQ>(st, kmajor<BN>(k_s, key_off, kk),
                         kmajor<BQ>(q_s, 0, kk), kk > 0);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss<BQ>(dpt, kmajor<BN>(v_s, key_off, kk),
                         kmajor<BQ>(o_s, 0, kk), kk > 0);
          wg_commit();
        };
        // dv += p^T.dO and dk += ds^T.Q with pa, da and the tile in stage s
        auto products = [&](int s) {
          const __nv_bfloat16* q_s = (const __nv_bfloat16*)(sQ + s * kQBytes);
          const __nv_bfloat16* o_s = (const __nv_bfloat16*)(sO + s * kQBytes);
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            wgmma_rs<DW>(dva, pa[kk], mnmajor<BQ>(o_s + col_off * BQ, kk),
                         1);
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            wgmma_rs<DW>(dka, da[kk], mnmajor<BQ>(q_s + col_off * BQ, kk),
                         1);
          wg_commit();
        };
        // tile j's p^T (into st) and ds^T (into dpt), fp32, with the lse
        // and delta rows of stage s
        auto ds_tile = [&](int j, int s) {
          const int q0 = (iq0 + j % live) * BQ;
          const float* l_s = sL + s * BQ;
          const float* d_s = sD + s * BQ;
          // a query of this tile is past S, or before a key of this
          // warpgroup
          const bool edge =
              q0 + BQ > S || (causal && q0 < k0 + key_off + 63);
#pragma unroll
          for (int jj = 0; jj < BQ / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * jj + cq + e;
              const float row_lse = l_s[c], row_delta = d_s[c];
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const int x = 4 * jj + 2 * hf + e;
                float p = exp2_approx(st[x] * scale_log2 - row_lse);
                if (edge) {
                  const int qpos = q0 + c;
                  if (qpos >= S || (causal && kr0 + 8 * hf > qpos)) p = 0.f;
                }
                dpt[x] = p * (dpt[x] - row_delta) * scale;  // ds^T
                st[x] = p;                                  // p^T
              }
            }
        };

        mbar_wait(&kv_full[kb], (n / KVBufs) & 1);
        ++n;
        if constexpr (!DkvTiles<D>::kOverlap) {
          for (int j = 0; j < rep * live; ++j, ++it) {  // tile by tile
            const int s = it % Stages;
            mbar_wait(&full[s], (it / Stages) & 1);
            fence_regs(st);
            fence_regs(dpt);
            wg_fence();
            scores(s);
            wg_wait0();
            fence_regs(st);
            fence_regs(dpt);
            ds_tile(j, s);
            pack_tile<BQ>(pa, st);
            pack_tile<BQ>(da, dpt);
            fence_regs(dva);
            fence_regs(dka);
            wg_fence();
            products(s);
            wg_wait0();
            fence_regs(dva);
            fence_regs(dka);
            fence_regs(pa);
            fence_regs(da);
            mbar_arrive(&empty[s]);
          }
        } else {
          {  // tile 0: S^T and dP^T, then its p^T and ds^T
            mbar_wait(&full[it % Stages], (it / Stages) & 1);
            fence_regs(st);
            fence_regs(dpt);
            wg_fence();
            scores(it % Stages);
            wg_wait0();
            fence_regs(st);
            fence_regs(dpt);
            ds_tile(0, it % Stages);
            pack_tile<BQ>(pa, st);
            pack_tile<BQ>(da, dpt);
            ++it;
          }
          // tile j's S^T and dP^T are issued with tile j - 1's products,
          // and tile j's p^T and ds^T computed while those run
          for (int j = 1; j < rep * live; ++j, ++it) {
            const int s = it % Stages, sp = (it - 1) % Stages;
            mbar_wait(&full[s], (it / Stages) & 1);
            fence_regs(st);
            fence_regs(dpt);
            fence_regs(dva);
            fence_regs(dka);
            wg_fence();
            scores(s);
            products(sp);
            wg_wait1();  // S^T and dP^T done; the products may still run
            fence_regs(st);
            fence_regs(dpt);
            ds_tile(j, s);
            wg_wait0();
            fence_regs(dva);
            fence_regs(dka);
            fence_regs(pa);
            fence_regs(da);
            mbar_arrive(&empty[sp]);
            pack_tile<BQ>(pa, st);
            pack_tile<BQ>(da, dpt);
          }
          {  // the last tile's products
            const int sp = (it - 1) % Stages;
            fence_regs(dva);
            fence_regs(dka);
            wg_fence();
            products(sp);
            wg_wait0();
            fence_regs(dva);
            fence_regs(dka);
            fence_regs(pa);
            fence_regs(da);
            mbar_arrive(&empty[sp]);
          }
        }
        // the item's last use of its K and V tiles
        mbar_arrive(&kv_empty[kb]);
      }

#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int kpos = kr0 + 8 * hf;
        if (kpos >= Tk) continue;
        const size_t off =
            ffflash::elem<D>(b, Tk, Hkv, g, kpos, col_off + cq);
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
}

// Launch the dq body on contiguous bf16 q, dO (B, S, H, D), k/v (B, T,
// Hkv, D), dq like q, fp32 lse and delta (B, H, S). cudaErrorInvalidValue
// when TMA refuses a map, otherwise the launch's cudaGetLastError().
template <class Tag, int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int B, int S, int Tk, int H, int Hkv,
                    int causal, float scale, cudaStream_t stream) {
  using T = DqTiles<D>;
  constexpr size_t smem = dq_wg_smem<D>();
  static_assert(smem <= ffflash::kMaxSmemBytes,
                "tiles do not fit shared memory");
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, q, B, S, H, D, kBM) ||
      !make_map(&mo, dout, B, S, H, D, kBM) ||
      !make_map(&mk, k, B, Tk, Hkv, D, T::kBK) ||
      !make_map(&mv, v, B, Tk, Hkv, D, T::kBK))
    return (int)cudaErrorInvalidValue;
  auto kernel =
      flash_dq_wgmma_kernel<Tag, D, T::kBK, T::kStages, T::kQBufs>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = std::min(B * H * ((S + kBM - 1) / kBM), sm_count());
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  kernel<<<grid, kWgThreads, smem, stream>>>(
      mq, mk, mv, mo, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dq, B, S, Tk, H, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

// Launch the dk/dv body: dk, dv like k, v (at Hkv heads). Same codes.
template <class Tag, int D>
int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int B, int S, int Tk, int H,
                     int Hkv, int causal, float scale, cudaStream_t stream) {
  using T = DkvTiles<D>;
  constexpr int BN = dkv_keys<D>();
  constexpr size_t smem = dkv_wg_smem<D>();
  static_assert(smem <= ffflash::kMaxSmemBytes,
                "tiles do not fit shared memory");
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, q, B, S, H, D, T::kBQ) ||
      !make_map(&mo, dout, B, S, H, D, T::kBQ) ||
      !make_map(&mk, k, B, Tk, Hkv, D, BN) ||
      !make_map(&mv, v, B, Tk, Hkv, D, BN))
    return (int)cudaErrorInvalidValue;
  auto kernel =
      flash_dkv_wgmma_kernel<Tag, D, T::kBQ, T::kStages, T::kKVBufs>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = std::min(B * Hkv * ((Tk + BN - 1) / BN), sm_count());
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  kernel<<<grid, kWgThreads, smem, stream>>>(
      mq, mk, mv, mo, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, B, S, Tk, H, Hkv, causal,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace ffwg
