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
//   online softmax keeps (m, l, acc) in fp32 with the running max floored
//   at -1e30; out = acc / max(l, 1e-30) in q's dtype, and rows
//   t >= qlens[b] are exact zeros.
//   * fp pool: K/V are converted to q's dtype on load (a pool of another
//     float dtype than q, e.g. kv_dtype="bf16" under an fp32 model, as
//     the TPU kernel's k.astype(q.dtype)), then to fp32; probabilities
//     are rounded to q's dtype before the P.V product.
//   * int8 pool: K/V are read as int8 x scale[pt[b, j], g] in fp32 (q
//     upcast to fp32), and p is NOT rounded before P.V (v is fp32 after
//     dequant), as the TPU kernel's quantized branch.
//
// What bounds it on the card: the bytes of the K/V pages it reads. A
// decode row does 4 operations per K/V element pair it loads (two dots of
// D), far below the ~295 operations per byte at which an H100 turns
// compute-bound. So each needed page is read once, no other page is read,
// and the reads have to run at the memory's rate across enough SMs.
//
// Every pool (fp and int8) runs one design: a split page walk and a
// combine pass (flash-decoding).
//   * The grid is (kv head, split, entry). Block s walks pages
//     s * pps .. s * pps + pps - 1 of its entry's table and serves all
//     rep = H / Hkv query heads of its GQA group and all live window rows
//     from them (the K/V of a group is read once). It stops at the
//     horizon pos + q_len - 1; a block whose run starts past it, and
//     every block of a padded entry, reads and writes nothing. At
//     Llama-3-8B decode (4 slots, 8 kv heads) the old one-block-per-
//     (entry, kv head) grid had 32 blocks for 132 SMs; split in runs of
//     two 64-row pages it has 16 x 32, of which those up to the horizon
//     run (9 x 32 at pos 1024, two blocks for each SM).
//   * A block keeps its rows' q and acc in shared memory, rep x S rows
//     of D. Where those leave no room even beside one-row K/V sub-tiles
//     (rep 4, D 128: a window of 64, the unpacked prefill's 64-token
//     chunk, or a 65-node draft tree), the window is cut into row tiles,
//     a further grid dimension: each tile's block walks the same pages
//     into the partials of its own rows, so every window launches. The
//     launcher takes the fewest tiles that fit; a window that fits whole
//     (decode 1, the packed 8, the 9-node tree) keeps its one tile.
//   * The block leaves a partial (m, l, unnormalised acc) in fp32 in a
//     workspace the wrapper allocates; a second kernel merges the live
//     partials of each (entry, window row, q head) by max and rescale,
//     and writes out, with exact zeros past q_len. It is a programmatic
//     dependent launch (griddepcontrol), so its launch overlaps the page
//     walk's tail. The plan (pps, the number of splits) depends on static
//     shapes only (the wrapper's ragged_split_plan), so nothing is read
//     back to the host and the grids are fixed for a CUDA graph.
//   * A block first issues every load that needs nothing else together
//     (the descriptor, its page ids, the q rows), then its K/V: sub-tiles
//     of up to 64 rows (never crossing a page) staged with 16-byte
//     cp.async copies (16 int8, 8 bf16/fp16 or 4 fp32 elements a
//     thread, neighbouring threads on neighbouring addresses of one (page
//     row, kv head) slice) into a ring of two stages, so the next sub-tile's
//     bytes are in flight while this one's dots run. Where D x the
//     element size is not a multiple of 16 or a pool is not 16-byte
//     aligned, the same layout is filled element by element.
//   * Chunk x of staged row c sits at chunk x ^ (c & 7), so eight
//     neighbouring rows' 16-byte reads fall in eight bank groups (the
//     ldmatrix reads of the tensor-core tiles and the CUDA-core reads
//     alike).
//   * The dots are few (bytes bound the work) but sit between a tile's
//     arrival and the next load, so they must be short: bf16 q over a
//     bf16 pool runs both products on the tensor cores (mma.sync
//     m16n8k16, q rows padded to 16, P rounded to bf16 in a padded
//     shared tile, V as the transposed operand); fp32 q (exact fp32
//     products), pools of another dtype than q and int8 pools (whose p
//     stays fp32 into P.V, which bf16 tiles would round) run on CUDA
//     cores: in
//     the score pass a thread owns one key and reads its row 16 bytes at
//     a time; in the P.V pass a thread owns a 16-byte column chunk of
//     four rows over a slice of the tile's keys, the slices of one chunk
//     neighbouring lanes summed by shuffles.
//   * An int8 pool is ragged_split_kernel<TQ, int8_t>: a (page row, kv
//     head) slice is D bytes (128 at Llama-3-8B), half an fp pool's, and
//     a staged 16-byte chunk is 16 elements, each dequantized as it is
//     read (chunk_to_f: int8 x the sub-tile's scale, fp32). A sub-tile
//     never crosses a page, so it has one K and one V scale, read with
//     the split's page ids.
//   * Numerics are the contract's; each split rounds p (fp pools) against
//     its own running max, as any smaller tile of the online softmax
//     does, and the combine only rescales fp32 sums: the result stays
//     within the plain version's tolerances (bf16 2e-2, fp32 1e-5).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;       // the combine pass
constexpr int kWarps = kThreads / 32;
constexpr int kSplitThreads = 256;  // the split walk
constexpr int kSplitWarps = kSplitThreads / 32;
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

// ---- split page walk + combine ---------------------------------------------

// everything both kernels of one launch read
struct SplitArgs {
  const void* q;
  const void* kc;
  const void* vc;
  const float* ks;  // int8 pools: (N, Hkv) scales of K and V; else null
  const float* vs;
  const int32_t* pt;
  const int32_t* pos;
  const int32_t* qlens;
  const uint8_t* anc;
  void* out;
  float* ws_acc;  // (B, nsplit, S, H, D) partial acc
  float* ws_m;    // (B, nsplit, S, H) partial running max
  float* ws_l;    // (B, nsplit, S, H) partial denominator
  int B, S, H, Hkv, D, P, maxp;
  int pps;     // pages a split walks
  int nsplit;  // splits per (entry, kv head): ceil(maxp / pps)
  int kt;      // K/V rows a staged sub-tile
  int ldk;     // row stride of staged K/V and of the fp32 q/acc rows: D
               // rounded up to whole 16-byte chunks of the pool's element
  int stages;  // sub-tiles in flight: 2, or 1 where two do not fit
  int vec;     // 16-byte copies (D x element size % 16 == 0, aligned pools)
  int mma;     // products on the tensor cores (bf16 q and pool, D and kt
               // multiples of 16)
  int ts;      // window rows a row tile holds (S, or less where the
               // whole window's q and acc rows do not fit one block)
  int nrt;     // row tiles: ceil(S / ts)
  int rows;    // q rows a block holds: rep * ts (rounded up to 16 for mma)
  float scale;
};

// an entry's pages up to its last visible cache row (horizon - 1, the
// horizon pos + q_len), none for a padded entry
__device__ __forceinline__ int live_pages(const SplitArgs& a, int qlen,
                                          int horizon) {
  return qlen > 0 ? min(a.maxp, (horizon - 1) / a.P + 1) : 0;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one staged 16-byte chunk of TKV as fp32: an fp element converted to q's
// type first (skipped where that is the identity: a pool of q's type, or
// fp32 q); an int8 element dequantized, times its page's scale `s`
template <typename TQ, typename TKV>
__device__ __forceinline__ void chunk_to_f(const TKV* src,
                                           float (&f)[16 / sizeof(TKV)],
                                           float s) {
  constexpr bool kExact =
      std::is_same<TQ, TKV>::value || std::is_same<TQ, float>::value;
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  const TKV* x = reinterpret_cast<const TKV*>(&w);
#pragma unroll
  for (int e = 0; e < 16 / (int)sizeof(TKV); ++e) {
    if constexpr (std::is_same<TKV, int8_t>::value)
      f[e] = (float)x[e] * s;
    else
      f[e] = kExact ? to_f(x[e]) : to_f(from_f<TQ>(to_f(x[e])));
  }
}

// column group y of a staged row (swizzle `swz` = the row's c & sw) as
// fp32, for the CUDA-core P.V pass: a whole 16-byte chunk (PVE = the
// chunk's elements), or over an int8 pool a 4-byte quarter of one (PVE =
// 4), so a group's partial sums stay few enough to shuffle
template <typename TQ, typename TKV, int PVE>
__device__ __forceinline__ void group_to_f(const TKV* row, int y, int swz,
                                           float (&f)[PVE], float s) {
  constexpr int EPC = 16 / sizeof(TKV);
  if constexpr (PVE == EPC) {
    chunk_to_f<TQ>(row + (y ^ swz) * EPC, f, s);
  } else {
    static_assert(std::is_same<TKV, int8_t>::value && PVE == 4, "");
    const int x = y / (EPC / PVE), sub = y - x * (EPC / PVE);
    const uint32_t w =
        *reinterpret_cast<const uint32_t*>(row + (x ^ swz) * EPC + sub * 4);
    const int8_t* b = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = (float)b[e] * s;
  }
}

// ---- tensor-core tiles (mma.sync m16n8k16, bf16 in, fp32 accumulate) -----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// four 8 x 8 bf16 matrices; lanes 8 m .. 8 m + 7 give matrix m's rows
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
// two matrices (lanes 0 .. 15 give the rows), plain or transposed
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}
// d += a (16 x 16, row-major) . b (16 x 8, column-major); d, like c, is
// rows lane / 4 and lane / 4 + 8, columns 2 (lane % 4) + {0, 1}
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bytes of dynamic shared memory of a split block: the K/V stages, then q
// (fp32, or bf16 for the tensor-core tiles), acc, the bf16 P tile of the
// tensor-core tiles (rows padded by 16 bytes), scores, (m, l, corr), the
// split's page ids and their K and V scales (int8 pools)
size_t split_smem(int rows, int ldk, int kt, int esz, int stages, bool mma,
                  int pps) {
  return (size_t)stages * 2 * kt * ldk * esz +
         (size_t)rows * ldk * (mma ? 2 : 4) + (size_t)rows * ldk * 4 +
         (mma ? (size_t)rows * (kt + 8) * 2 : 0) + (size_t)rows * kt * 4 +
         (size_t)3 * rows * 4 + (size_t)pps * 12;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kSplitThreads)
ragged_split_kernel(const SplitArgs a) {
  constexpr int EPC = 16 / sizeof(TKV);  // elements a 16-byte chunk
  constexpr bool kMmaTypes = std::is_same<TQ, __nv_bfloat16>::value &&
                             std::is_same<TKV, __nv_bfloat16>::value;
  // p is rounded to q's dtype before P.V, except over an int8 pool
  constexpr bool kRoundP = !std::is_same<TKV, int8_t>::value;
  constexpr int PVE = kRoundP ? EPC : 4;  // elements a CUDA-core P.V item
  using Bits = typename std::conditional<
      sizeof(TKV) == 4, uint32_t,
      typename std::conditional<sizeof(TKV) == 2, uint16_t,
                                uint8_t>::type>::type;
  // kv head fastest: the blocks that read the Hkv slices of one page's
  // rows are dispatched together; then the row tile, whose window rows
  // t0 .. t0 + ts - 1 the block serves
  const int g = blockIdx.x % a.Hkv, s = blockIdx.y, b = blockIdx.z;
  const int t0 = blockIdx.x / a.Hkv * a.ts;
  const int j0 = s * a.pps;
  const int rep = a.H / a.Hkv;
  const bool mma = kMmaTypes && a.mma;
  const int rows = a.rows;  // rep * ts, rounded up to 16 for mma
  const int kt = a.kt, ldk = a.ldk, D = a.D, P = a.P;
  const int nch = ldk / EPC;              // chunks a staged row
  const int sw = min(8, nch & -nch) - 1;  // chunk swizzle mask
  const int lp = kt + 8;                  // row stride of the bf16 P tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) uint8_t split_smem_raw[];
  uint8_t* cur = split_smem_raw;
  TKV* skv = reinterpret_cast<TKV*>(cur);  // stages x {K, V} x (kt, ldk)
  cur += (size_t)a.stages * 2 * kt * ldk * sizeof(TKV);
  float* sq = reinterpret_cast<float*>(cur);  // (rows, ldk) q, fp32 ..
  __nv_bfloat16* sqb = reinterpret_cast<__nv_bfloat16*>(cur);  // .. or bf16
  cur += (size_t)rows * ldk * (mma ? 2 : 4);
  float* sacc = reinterpret_cast<float*>(cur);  // (rows, ldk) P.V sums
  cur += (size_t)rows * ldk * 4;
  __nv_bfloat16* spb = reinterpret_cast<__nv_bfloat16*>(cur);  // (rows, lp)
  if (mma) cur += (size_t)rows * lp * 2;
  float* sp = reinterpret_cast<float*>(cur);  // (rows, kt) scores -> p
  cur += (size_t)rows * kt * 4;
  float* sm = reinterpret_cast<float*>(cur);  // (rows) running max
  float* sl = sm + rows;                      // (rows) running denominator
  float* scorr = sl + rows;                   // (rows) this tile's rescale
  int* spt = reinterpret_cast<int*>(scorr + rows);  // (pps) page ids
  float* sks = reinterpret_cast<float*>(spt + a.pps);  // (pps) K scales
  float* svs = sks + a.pps;                            // (pps) V scales

  // The loads that need nothing else are issued together: the entry's
  // descriptor, the split's page ids (and an int8 pool's scales of those
  // pages), and q's rows r = (t - t0) * rep + hl for every window row t of
  // the tile (zeros past D; the live rows, t < q_len, are the first R).
  // acc 0, (m, l) = (-1e30, 0).
  const int qlen = a.qlens[b], p0 = a.pos[b];
  for (int i = tid; i < a.pps; i += kSplitThreads) {
    const int page = j0 + i < a.maxp ? a.pt[b * a.maxp + j0 + i] : 0;
    spt[i] = page;
    if constexpr (!kRoundP) {
      sks[i] = a.ks[(size_t)page * a.Hkv + g];
      svs[i] = a.vs[(size_t)page * a.Hkv + g];
    }
  }
  const TQ* q = static_cast<const TQ*>(a.q);
  const int rmax = rep * min(a.ts, a.S - t0);
  for (int i = tid; i < rows * ldk; i += kSplitThreads) {
    const int r = i / ldk, d = i - r * ldk;
    const int t = t0 + r / rep, hl = r % rep;
    const float x = r < rmax && d < D ? to_f(q[((size_t)(b * a.S + t) * a.H +
                                                g * rep + hl) * D + d])
                                      : 0.f;
    if (mma) {
      const int c = d / 8;
      sqb[r * ldk + (c ^ (r & sw)) * 8 + (d - c * 8)] = __float2bfloat16(x);
    } else {
      sq[i] = x;
    }
    sacc[i] = 0.f;
  }
  if (mma)
    for (int i = tid; i < rows * lp; i += kSplitThreads)
      spb[i] = __float2bfloat16(0.f);
  for (int r = tid; r < rows; r += kSplitThreads) {
    sm[r] = kNegInf;
    sl[r] = 0.f;
    scorr[r] = 1.f;
  }
  const int horizon = p0 + qlen;
  const int npages = live_pages(a, qlen, horizon);
  const int R = rep * max(0, min(a.ts, qlen - t0));  // live rows
  // past the horizon, or a tile of no live row: no K/V read, no partial
  if (j0 >= npages || R == 0) return;
  const int j1 = min(npages, j0 + a.pps);
  __syncthreads();

  // sub-tile i: page j0 + i / tpp, rows c0 .. c0 + n - 1 of it
  const int tpp = (P + kt - 1) / kt;
  const int last = min(tpp, (horizon - (j1 - 1) * P + kt - 1) / kt);
  const int ntiles = (j1 - 1 - j0) * tpp + last;
  const TKV* kc = static_cast<const TKV*>(a.kc);
  const TKV* vc = static_cast<const TKV*>(a.vc);
  const size_t stride = (size_t)a.Hkv * D;  // between cache rows
  auto load = [&](int i, int slot) {
    const int j = j0 + i / tpp, c0 = (i % tpp) * kt;
    const int n = min(kt, min(P - c0, horizon - (j * P + c0)));
    const int page = spt[i / tpp];
    const size_t row0 = ((size_t)(page * P + c0) * a.Hkv + g) * D;
    TKV* dk = skv + (size_t)slot * 2 * kt * ldk;
    TKV* dv = dk + (size_t)kt * ldk;
    if (a.vec) {  // D == ldk
      for (int i2 = tid; i2 < n * nch; i2 += kSplitThreads) {
        const int c = i2 / nch, x = i2 - c * nch;
        const size_t off = row0 + c * stride + x * EPC;
        const int dst = c * ldk + (x ^ (c & sw)) * EPC;
        cp_async16(dk + dst, kc + off);
        cp_async16(dv + dst, vc + off);
      }
    } else {
      const Bits* kb = reinterpret_cast<const Bits*>(kc);
      const Bits* vb = reinterpret_cast<const Bits*>(vc);
      for (int i2 = tid; i2 < n * ldk; i2 += kSplitThreads) {
        const int c = i2 / ldk, d = i2 - c * ldk, x = d / EPC;
        const int dst = c * ldk + (x ^ (c & sw)) * EPC + (d - x * EPC);
        const size_t off = row0 + c * stride + d;
        reinterpret_cast<Bits*>(dk)[dst] = d < D ? kb[off] : Bits(0);
        reinterpret_cast<Bits*>(dv)[dst] = d < D ? vb[off] : Bits(0);
      }
    }
    // a short tile's missing rows read as zeros (the tensor-core tiles
    // multiply them by p = 0)
    for (int i2 = n * ldk + tid; i2 < kt * ldk; i2 += kSplitThreads) {
      reinterpret_cast<Bits*>(dk)[i2] = Bits(0);
      reinterpret_cast<Bits*>(dv)[i2] = Bits(0);
    }
  };

  const int nrp = kSplitThreads / kt;  // row phases of the score pass
  // the CUDA-core P.V pass: row blocks of 4, column groups of PVE, key
  // slices nks
  const int nrb = (R + 3) / 4, ngr = ldk / PVE;
  int nks = 1;
  while (nks < 32 && 2 * nks * nrb * ngr <= kSplitThreads) nks *= 2;
  const int items = nks * nrb * ngr;
  const int mts = (R + 15) / 16;  // the tensor-core tiles' 16-row blocks
  load(0, 0);
  cp_async_commit();
  for (int i = 0; i < ntiles; ++i) {
    const int slot = a.stages == 2 ? (i & 1) : 0;
    if (a.stages == 2 && i + 1 < ntiles) {
      load(i + 1, slot ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int j = j0 + i / tpp, c0 = (i % tpp) * kt;
    const int base = j * P + c0;  // cache row of tile row 0
    const int n = min(kt, min(P - c0, horizon - base));
    const TKV* tk = skv + (size_t)slot * 2 * kt * ldk;
    const TKV* tv = tk + (size_t)kt * ldk;
    // an int8 pool's scales of this sub-tile's page (unused otherwise)
    const float k_s = kRoundP ? 1.f : sks[i / tpp];
    const float v_s = kRoundP ? 1.f : svs[i / tpp];
    // score of row r, key c: fp32 dot times scale where visible, -inf
    // where not (it adds nothing)
    auto put_score = [&](int r, int c, float dot) {
      const int t = t0 + r / rep, kpos = base + c, rel = kpos - p0;
      const bool vis =
          kpos < p0 || (rel >= 0 && rel < qlen &&
                        a.anc[((size_t)b * a.S + t) * a.S + rel]);
      sp[r * kt + c] = vis ? dot * a.scale : -INFINITY;
    };

    if constexpr (kMmaTypes) {
      if (mma) {
        // scores on the tensor cores: warp unit (16-row block mt, 8-key
        // block nt), D / 16 k-steps
        const int nt_n = kt / 8;
        for (int u = warp; u < mts * nt_n; u += kSplitWarps) {
          const int mt = u / nt_n, nt = u - mt * nt_n;
          if (nt * 8 >= n) continue;
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          const int ar = mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
          const int br = nt * 8 + (lane & 7);
          for (int ks = 0; ks < ldk / 16; ++ks) {
            uint32_t fa[4], fb[2];
            const int ac = 2 * ks + (lane >> 4);
            ldsm_x4(fa, sqb + ar * ldk + ((ac ^ (ar & sw)) * 8));
            const int bc = 2 * ks + ((lane >> 3) & 1);
            ldsm_x2(fb, reinterpret_cast<const __nv_bfloat16*>(tk) +
                            br * ldk + ((bc ^ (br & sw)) * 8));
            mma_bf16(acc, fa, fb);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = mt * 16 + lane / 4 + 8 * (e >> 1);
            const int c = nt * 8 + 2 * (lane % 4) + (e & 1);
            if (r < R && c < n) put_score(r, c, acc[e]);
          }
        }
      }
    }
    if (!mma) {
      // scores on CUDA cores: thread (row phase rp, key c) takes rows rp,
      // rp + nrp, .. four at a time, EPC partial sums a row
      const int c = tid % kt, rp = tid / kt;
      if (c < n && rp < nrp) {
        const TKV* krow = tk + c * ldk;
        for (int rb = rp; rb < R; rb += 4 * nrp) {
          float acc[4][EPC];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int e = 0; e < EPC; ++e) acc[u][e] = 0.f;
#pragma unroll 2
          for (int x = 0; x < nch; ++x) {
            float kf[EPC];
            chunk_to_f<TQ>(krow + (x ^ (c & sw)) * EPC, kf, k_s);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int r = rb + u * nrp;
              if (r < R) {
                const float4* q4 =
                    reinterpret_cast<const float4*>(sq + r * ldk + x * EPC);
#pragma unroll
                for (int e4 = 0; e4 < EPC / 4; ++e4) {
                  const float4 qv = q4[e4];
                  acc[u][4 * e4] = fmaf(qv.x, kf[4 * e4], acc[u][4 * e4]);
                  acc[u][4 * e4 + 1] =
                      fmaf(qv.y, kf[4 * e4 + 1], acc[u][4 * e4 + 1]);
                  acc[u][4 * e4 + 2] =
                      fmaf(qv.z, kf[4 * e4 + 2], acc[u][4 * e4 + 2]);
                  acc[u][4 * e4 + 3] =
                      fmaf(qv.w, kf[4 * e4 + 3], acc[u][4 * e4 + 3]);
                }
              }
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = rb + u * nrp;
            if (r >= R) break;
            float dot = 0.f;
#pragma unroll
            for (int e = 0; e < EPC; ++e) dot += acc[u][e];
            put_score(r, c, dot);
          }
        }
      }
    }
    __syncthreads();

    // online softmax update, one warp per row; p rounded to q's dtype
    // before P.V over an fp pool (into the bf16 P tile for the tensor
    // cores, zeros past the tile's n keys), kept fp32 over an int8 pool
    for (int r = warp; r < R; r += kSplitWarps) {
      float* pr = sp + r * kt;
      float mx = kNegInf;
      for (int c = lane; c < n; c += 32) mx = fmaxf(mx, pr[c]);
      mx = warp_max(mx);
      const float m_prev = sm[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < kt; c += 32) {
        const float sc = c < n ? pr[c] : -INFINITY;
        const float p = sc == -INFINITY ? 0.f : expf(sc - m_new);
        sum += p;
        if (mma)
          spb[r * lp + c] = __float2bfloat16(p);
        else if (c < n)
          pr[c] = kRoundP ? to_f(from_f<TQ>(p)) : p;
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

    if constexpr (kMmaTypes) {
      if (mma) {
        // acc = acc * corr + P.V on the tensor cores: warp unit (16-row
        // block mt, 8 columns dt), kt / 16 k-steps over the keys; V is
        // the transposed B operand (ldmatrix .trans)
        const int dt_n = ldk / 8;
        for (int u = warp; u < mts * dt_n; u += kSplitWarps) {
          const int mt = u / dt_n, dt = u - mt * dt_n;
          const int r0 = mt * 16 + lane / 4, col = dt * 8 + 2 * (lane % 4);
          float acc[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r0 + 8 * (e >> 1);
            acc[e] = sacc[r * ldk + col + (e & 1)] * scorr[r];
          }
          const int ar = mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
          for (int kk = 0; kk * 16 < n; ++kk) {
            uint32_t fa[4], fb[2];
            ldsm_x4(fa, spb + ar * lp + kk * 16 + 8 * (lane >> 4));
            const int vr = kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
            ldsm_x2_t(fb, reinterpret_cast<const __nv_bfloat16*>(tv) +
                              vr * ldk + ((dt ^ (vr & sw)) * 8));
            mma_bf16(acc, fa, fb);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sacc[(r0 + 8 * (e >> 1)) * ldk + col + (e & 1)] = acc[e];
        }
      }
    }
    if (!mma) {
      // acc = acc * corr + P.V on CUDA cores: item (key slice ks,
      // column group y of PVE elements, rows 4 rb .. 4 rb + 3) sums keys
      // ks, ks + nks, .. of the tile; the nks slices of one (y, rb) are
      // neighbouring lanes of a warp and are summed by shuffles (nks a
      // power of two up to 32, as many as leave no thread idle)
      for (int it0 = 0; it0 < items; it0 += kSplitThreads) {
        const int it = it0 + tid;
        const int ks = it & (nks - 1), y = (it / nks) % ngr;
        const int rb = it / (nks * ngr);
        float av[4][PVE];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < PVE; ++e) av[u][e] = 0.f;
        if (it < items) {
          for (int c = ks; c < n; c += nks) {
            float vf[PVE];
            group_to_f<TQ, TKV, PVE>(tv + c * ldk, y, c & sw, vf, v_s);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int r = 4 * rb + u;
              if (r < R) {
                const float p = sp[r * kt + c];
#pragma unroll
                for (int e = 0; e < PVE; ++e)
                  av[u][e] = fmaf(p, vf[e], av[u][e]);
              }
            }
          }
        }
        for (int o = 1; o < nks; o <<= 1)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (u < R) {  // uniform: rows a block of fewer than 4 lacks
#pragma unroll
              for (int e = 0; e < PVE; ++e)
                av[u][e] += __shfl_xor_sync(0xffffffffu, av[u][e], o);
            }
        if (it < items && ks == 0) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = 4 * rb + u;
            if (r >= R) break;
            const float corr = scorr[r];
            float4* ar = reinterpret_cast<float4*>(sacc + r * ldk + y * PVE);
#pragma unroll
            for (int e4 = 0; e4 < PVE / 4; ++e4) {
              const float4 o = ar[e4];
              ar[e4] = make_float4(fmaf(o.x, corr, av[u][4 * e4]),
                                   fmaf(o.y, corr, av[u][4 * e4 + 1]),
                                   fmaf(o.z, corr, av[u][4 * e4 + 2]),
                                   fmaf(o.w, corr, av[u][4 * e4 + 3]));
            }
          }
        }
      }
    }
    __syncthreads();
    if (a.stages == 1 && i + 1 < ntiles) {
      load(i + 1, 0);
      cp_async_commit();
    }
  }

  // the combine pass may be scheduled once every block is past its page
  // walk (or has exited): it waits for this grid's writes itself
  // (griddepcontrol.wait), so only its launch overlaps this tail
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  // this split's partial: row ((b * nsplit + s) * S + t) * H + h
  const size_t row0 = (size_t)(b * a.nsplit + s) * a.S;
  for (int it = tid; it < R * D; it += kSplitThreads) {
    const int r = it / D, d = it - r * D;
    const int t = t0 + r / rep, hl = r % rep;
    const size_t row = (row0 + t) * a.H + g * rep + hl;
    a.ws_acc[row * D + d] = sacc[r * ldk + d];
  }
  for (int r = tid; r < R; r += kSplitThreads) {
    const int t = t0 + r / rep, hl = r % rep;
    const size_t row = (row0 + t) * a.H + g * rep + hl;
    a.ws_m[row] = sm[r];
    a.ws_l[row] = sl[r];
  }
}

// One warp per output row (b, t, h): merge the live splits' partials by
// max and rescale, out = acc / max(l, 1e-30) in q's dtype; rows past
// q_len (every row of a padded entry) are exact zeros. Up to kBatch
// splits' partials are loaded at once (a lane takes columns lane + 32 e,
// so each split's row is one coalesced read), then merged with a running
// max.
constexpr int kBatch = 16;

template <typename TQ>
__global__ void __launch_bounds__(kThreads)
ragged_combine_kernel(const SplitArgs a) {
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= a.B * a.S * a.H) return;
  const int h = w % a.H, t = (w / a.H) % a.S, b = w / (a.H * a.S);
  TQ* out = static_cast<TQ*>(a.out) + (size_t)w * a.D;
  const int qlen = a.qlens[b];
  const int npages = live_pages(a, qlen, a.pos[b] + qlen);
  if (t >= qlen) {
    for (int d = lane; d < a.D; d += 32) out[d] = from_f<TQ>(0.f);
    return;
  }
  const int nlive = (npages + a.pps - 1) / a.pps;
  const size_t row0 = ((size_t)b * a.nsplit * a.S + t) * a.H + h;
  const size_t step = (size_t)a.S * a.H;  // between splits
  // launched as a dependent of the split walk: its partials are complete
  // and visible past this point
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int d0 = 0; d0 < a.D; d0 += 128) {
    float mx = kNegInf, l = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < nlive; s0 += kBatch) {
      float m_s[kBatch], l_s[kBatch], v[kBatch][4];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const bool live = s0 + k < nlive;
        const size_t row = row0 + (size_t)(s0 + k) * step;
        m_s[k] = live ? a.ws_m[row] : kNegInf;
        l_s[k] = live ? a.ws_l[row] : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = d0 + lane + 32 * e;
          v[k][e] = live && d < a.D ? a.ws_acc[row * a.D + d] : 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (s0 + k >= nlive) break;
        const float m_new = fmaxf(mx, m_s[k]);
        const float corr = expf(mx - m_new), wgt = expf(m_s[k] - m_new);
        l = fmaf(l, corr, wgt * l_s[k]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[e] = fmaf(acc[e], corr, wgt * v[k][e]);
        mx = m_new;
      }
    }
    const float l_safe = fmaxf(l, 1e-30f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = d0 + lane + 32 * e;
      if (d < a.D) out[d] = from_f<TQ>(acc[e] / l_safe);
    }
  }
}

template <typename TQ, typename TKV>
int launch_split(SplitArgs a, cudaStream_t stream) {
  if (a.B <= 0 || a.S <= 0 || a.Hkv <= 0 || a.H % a.Hkv != 0 || a.D <= 0 ||
      a.P <= 0 || a.maxp <= 0 || a.pps <= 0 ||
      a.nsplit != (a.maxp + a.pps - 1) / a.pps ||
      a.B > 65535 || a.nsplit > 65535)
    return (int)cudaErrorInvalidValue;
  constexpr int esz = sizeof(TKV), epc = 16 / esz;
  constexpr bool kMmaTypes = std::is_same<TQ, __nv_bfloat16>::value &&
                             std::is_same<TKV, __nv_bfloat16>::value;
  a.ldk = (a.D + epc - 1) / epc * epc;
  a.vec = a.vec && a.ldk == a.D;
  // two stages of up to 64-row sub-tiles; smaller ones (then one stage)
  // where a wide window's q and acc rows leave no room. bf16 q over a
  // bf16 pool runs its products on the tensor cores where the tiles are
  // whole k-steps (D and the sub-tile multiples of 16). Where not even
  // one-row sub-tiles leave room for the whole window's rep x S q and acc
  // rows, the window is cut into nrt row tiles of ts rows, each a block
  // of its own that walks the same pages into the partials of its rows
  // (the fewest tiles that fit, each planned afresh from 64-row
  // sub-tiles), so any window up to the table's rows launches
  auto fit = [&]() {
    a.mma = kMmaTypes && a.D % 16 == 0 && a.kt % 16 == 0;
    const int rmax = (a.H / a.Hkv) * a.ts;
    a.rows = a.mma ? (rmax + 15) / 16 * 16 : rmax;
    return split_smem(a.rows, a.ldk, a.kt, esz, a.stages, a.mma, a.pps);
  };
  a.nrt = 0;
  for (int nrt = 1; nrt <= a.S && a.nrt == 0; ++nrt) {
    a.ts = (a.S + nrt - 1) / nrt;
    a.kt = a.P < kMaxTileRows ? a.P : kMaxTileRows;
    a.stages = 2;
    while (fit() > kMaxSmemBytes) {
      if (a.kt > 8 || (a.stages == 1 && a.kt > 1))
        a.kt = (a.kt + 1) / 2;
      else if (a.stages == 2)
        a.stages = 1;
      else
        break;
    }
    if (fit() <= kMaxSmemBytes) a.nrt = (a.S + a.ts - 1) / a.ts;
  }
  if (a.nrt == 0 || (long long)a.Hkv * a.nrt > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = fit();
  auto split = ragged_split_kernel<TQ, TKV>;
  cudaError_t err = cudaFuncSetAttribute(
      split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // all of the SM's 228 KB as shared memory: as many blocks on an SM as
  // their stages fit, for the bytes in flight
  err = cudaFuncSetAttribute(split,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  split<<<dim3(a.Hkv * a.nrt, a.nsplit, a.B), kSplitThreads, smem,
           stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the combine pass as a programmatic dependent launch: its blocks start
  // while the split walk's last blocks write their partials, read the
  // descriptor and write the zero rows, then wait for the partials
  // (griddepcontrol.wait)
  const long long rows = (long long)a.B * a.S * a.H;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((rows + kWarps - 1) / kWarps));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ragged_combine_kernel<TQ>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

SplitArgs split_args(const void* q, const void* kc, const void* vc,
                     const void* pt, const void* pos, const void* qlens,
                     const void* anc, void* out, void* ws_acc, void* ws_m,
                     void* ws_l, int B, int S, int H, int Hkv, int D, int P,
                     int maxp, int pps, int nsplit, float scale) {
  SplitArgs a{};
  a.q = q;
  a.kc = kc;
  a.vc = vc;
  a.pt = (const int32_t*)pt;
  a.pos = (const int32_t*)pos;
  a.qlens = (const int32_t*)qlens;
  a.anc = (const uint8_t*)anc;
  a.out = out;
  a.ws_acc = (float*)ws_acc;
  a.ws_m = (float*)ws_m;
  a.ws_l = (float*)ws_l;
  a.B = B;
  a.S = S;
  a.H = H;
  a.Hkv = Hkv;
  a.D = D;
  a.P = P;
  a.maxp = maxp;
  a.pps = pps;
  a.nsplit = nsplit;
  a.scale = scale;
  // 16-byte copies need 16-byte aligned pools (and whole chunks a row,
  // checked by the launcher); other pools load element by element
  a.vec = (((uintptr_t)kc | (uintptr_t)vc) & 15) == 0;
  return a;
}

template <typename TQ>
int launch_split_fp(const SplitArgs& a, int kv_dtype, cudaStream_t st) {
  if (kv_dtype == 0) return launch_split<TQ, float>(a, st);
  if (kv_dtype == 1) return launch_split<TQ, __nv_bfloat16>(a, st);
  if (kv_dtype == 2) return launch_split<TQ, __half>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The fp pools. q_dtype: 0 = float32, 1 = bfloat16 (q and out);
// kv_dtype: 0 = float32, 1 = bfloat16, 2 = float16 (the pools). ws_acc
// (B * nsplit * S * H * D), ws_m and ws_l (B * nsplit * S * H): fp32
// workspace of the partials; pps pages a split, nsplit = ceil(maxp / pps)
// splits (ragged_split_plan). Returns a cudaError_t:
// cudaErrorInvalidValue for shapes or dtypes the kernels do not take,
// otherwise the launches' cudaGetLastError().
int ff_ragged_paged_attention(const void* q, const void* kc, const void* vc,
                              const void* pt, const void* pos,
                              const void* qlens, const void* anc, void* out,
                              void* ws_acc, void* ws_m, void* ws_l, int B,
                              int S, int H, int Hkv, int D, int P, int maxp,
                              int pps, int nsplit, float scale, int q_dtype,
                              int kv_dtype, void* stream) {
  const SplitArgs a = split_args(q, kc, vc, pt, pos, qlens, anc, out, ws_acc,
                                 ws_m, ws_l, B, S, H, Hkv, D, P, maxp, pps,
                                 nsplit, scale);
  cudaStream_t st = (cudaStream_t)stream;
  if (q_dtype == 0) return launch_split_fp<float>(a, kv_dtype, st);
  if (q_dtype == 1) return launch_split_fp<__nv_bfloat16>(a, kv_dtype, st);
  return (int)cudaErrorInvalidValue;
}

// The int8 pool: kc/vc int8 (N, P, Hkv, D), ks/vs fp32 (N, Hkv) scales;
// the other arguments as above. The split walk of ragged_split_kernel<TQ,
// int8_t> and the same combine pass.
int ff_ragged_paged_attention_quant(
    const void* q, const void* kc, const void* vc, const void* ks,
    const void* vs, const void* pt, const void* pos, const void* qlens,
    const void* anc, void* out, void* ws_acc, void* ws_m, void* ws_l, int B,
    int S, int H, int Hkv, int D, int P, int maxp, int pps, int nsplit,
    float scale, int q_dtype, void* stream) {
  SplitArgs a = split_args(q, kc, vc, pt, pos, qlens, anc, out, ws_acc, ws_m,
                           ws_l, B, S, H, Hkv, D, P, maxp, pps, nsplit,
                           scale);
  a.ks = (const float*)ks;
  a.vs = (const float*)vs;
  cudaStream_t st = (cudaStream_t)stream;
  if (q_dtype == 0) return launch_split<float, int8_t>(a, st);
  if (q_dtype == 1) return launch_split<__nv_bfloat16, int8_t>(a, st);
  return (int)cudaErrorInvalidValue;
}

const char* ff_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
