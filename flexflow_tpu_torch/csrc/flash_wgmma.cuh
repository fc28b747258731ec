// Hopper building blocks of the tensor-core flash kernels (the bf16
// bodies of flash_wgmma_fwd.cuh and flash_wgmma_bwd.cuh, instantiated by
// K1/K2's and K4's sources): mbarriers, TMA loads, wgmma and its
// shared-memory descriptors, and the host-side tensor maps.
//
// Tiles in shared memory: a tile of R rows of one head, DP = 64 * c
// columns wide, is loaded by TMA as DP / 64 boxes of R rows x 64 bf16 (128
// bytes a row) with the 128-byte swizzle, box after box, each 1024-byte
// aligned. DP is the head dim D rounded up to 64 (pad64): the tensor map's
// dims say D, and TMA fills the columns D .. DP - 1 of a box with zeros
// (rows past L alike), so a D 96 head lands as a zero-padded 128-column
// tile read from unpadded device memory. A contraction over D then runs
// ceil(D / 16) k-steps (the zeros past them add nothing), and a product
// whose N runs along D has N = D (wgmma's N steps by 8), reading its last
// box in part.
// A head dim whose bf16 rows are not a multiple of 16 bytes (D 100: 200
// bytes) has no TMA stride. Its tiles are filled by the producer
// warpgroup's threads instead (cp_rows): 8-byte cp.async copies into the
// same boxes and swizzle, rows past L zero-filled by the copy, columns D ..
// DP - 1 zeroed once when the block starts (the copies never write them);
// a tile reaches its `full` barrier through CpAsyncPipe. Such a head dim's
// value products run at N = 104 (vn), since wgmma's N steps by 8.
// One such tile serves wgmma both ways:
//  - K-major (the contraction runs along D: q.k^T, dO.v^T, k.q^T, v.dO^T):
//    k-step kk (16 columns) starts at box kk / 4, byte 32 * (kk % 4) of
//    the row; 8-row groups are 1024 bytes apart (SBO);
//  - MN-major (the contraction runs along the rows, wgmma's transposed B:
//    p.v, ds.k, p^T.dO, ds^T.q): k-step kk (16 rows) starts at row 16 * kk;
//    8-row groups are 1024 bytes apart (SBO), 64-column boxes R * 128
//    bytes apart (LBO).
// The wgmma accumulator of an m64nN product gives thread t of the
// warpgroup (warp w = t / 32, lane) rows 16 w + lane / 4 (r) and r + 8,
// and of each 8-column group j columns 8 j + 2 (lane % 4) + {0, 1}:
// d[4 j + 2 half + e] is (r + 8 half, 8 j + 2 (lane % 4) + e). That is
// also the layout of wgmma's A operand in registers, so a score tile
// becomes the A operand of the next product with no shuffle: k-step kk's
// four registers are d[8 kk + 2 i], d[8 kk + 2 i + 1] packed to bf16.
// A row's reduction runs over the 4 lanes of a quad.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from
                   // the driver at run time (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ffwg {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// arrive and add `bytes` to the transactions the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// arrive on the barrier at shared-memory address `bar`
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  mbar_arrive(smem_u32(bar));
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ------------------------------------------------------------------

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing `bytes` of `bar`'s transactions
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ---- cp.async: rows TMA cannot stride --------------------------------------

// true when a head dim's bf16 rows are not a multiple of 16 bytes, TMA's
// stride unit: the bodies then fill their tiles by cp.async (cp_rows)
__host__ __device__ constexpr bool rows_by_cp_async(int d) {
  return d * 2 % 16 != 0;
}

// an 8-byte copy from global memory to the shared-memory address dst;
// `bytes` 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// rows row0 .. row0 + R - 1 of head h of batch entry b of a contiguous
// bf16 (B, L, heads, D) tensor into a tile of R rows as TMA lays it out
// (boxes of R rows x 64 columns, box after box, the 128-byte swizzle: the
// 16-byte chunk j of row r at chunk j ^ (r & 7), an 8-byte half within it),
// by the producer warpgroup's thread `tid`: one cp.async of 8 bytes per 4
// columns, rows past L zero-filled. Columns D .. pad64(D) - 1 are not
// written. Thread tid copies the 8-byte pieces p = tid % 16 and p + 16
// (columns 4 p and 64 + 4 p, where they are below D) of rows tid / 16 + 8
// i: its swizzle and its two shared-memory offsets are fixed, and each
// row costs it a pointer step and its copies. D in (64, 128].
template <int D, int R>
__device__ __forceinline__ void cp_rows(__nv_bfloat16* tile,
                                        const __nv_bfloat16* src, int b,
                                        int L, int heads, int h, int row0,
                                        int tid) {
  static_assert(D % 4 == 0 && D > 64 && D <= 128 && R % 8 == 0,
                "cp_rows takes two 8-byte pieces a row and thread");
  const int r0 = tid / 16, p = tid % 16;
  const bool second = p + 16 < D / 4;  // a piece in the second box
  const size_t step = (size_t)8 * heads * D;  // 8 rows, in elements
  const __nv_bfloat16* s =
      src + (((size_t)b * L + row0 + r0) * heads + h) * D + 4 * p;
  uint32_t d =
      smem_u32(tile) + r0 * 128 + (((p >> 1) ^ r0) << 4) + (p & 1) * 8;
#pragma unroll 1
  for (int r = row0 + r0; r < row0 + R; r += 8, s += step, d += 1024) {
    const bool live = r < L;
    const __nv_bfloat16* g = live ? s : src;  // and reads nothing
    cp_async8(d, g, live ? 8 : 0);
    if (second) cp_async8(d + R * 128, g + 64, live ? 8 : 0);
  }
}

// true when the phase of parity `parity` has completed (no wait)
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// makes this thread's generic-proxy writes to shared memory (cp.async,
// plain stores) visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One producer thread's hand-off of cp.async tiles: it commits a tile's
// copies as a group, and arrives on the tile's `full` barrier once that
// group has landed (cp.async.wait_group, then fence.proxy.async, then
// mbarrier.arrive): a barrier of a tile counts every producer thread. The
// arrival lags one group, so a tile's copies are in flight while the
// previous one lands. Before blocking on an `empty` barrier the thread
// drains its pending arrival: the consumers may be waiting on that tile.
struct CpAsyncPipe {
  static constexpr uint32_t kNone = ~0u;
  // the pending barrier's shared-memory address (32 bits: the producer
  // has 40 registers)
  uint32_t pending = kNone;

  __device__ __forceinline__ void commit(uint64_t* full) {
    asm volatile("cp.async.commit_group;" ::: "memory");
    if (pending != kNone) {
      asm volatile("cp.async.wait_group 1;" ::: "memory");
      fence_proxy_async();
      mbar_arrive(pending);
    }
    pending = smem_u32(full);
  }
  __device__ __forceinline__ void drain() {
    if (pending != kNone) {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      fence_proxy_async();
      mbar_arrive(pending);
      pending = kNone;
    }
  }
  // wait for `bar`'s phase of parity `parity`, draining first if it has
  // not completed
  __device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
    if (!mbar_test(bar, parity)) {
      drain();
      mbar_wait(bar, parity);
    }
  }
};

// zeros over `bytes` (a multiple of 16) of shared memory from `p`, by the
// whole block, made visible to the async proxy; the caller syncs
__device__ __forceinline__ void zero_smem(uint8_t* p, size_t bytes) {
  for (size_t i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16)
    *reinterpret_cast<uint4*>(p + i) = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
}

// where the cp.async bodies read q, k, v and dO (TMA's maps stay unused)
struct RowSrc {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
};

// ---- warp specialisation ---------------------------------------------------

// a head dim's tile width in shared memory: D rounded up to 64 columns
__host__ __device__ constexpr int pad64(int d) { return (d + 63) / 64 * 64; }

// the N of a value product (p.v, ds.k, p^T.dO, ds^T.q) at head dim d: d
// rounded up to wgmma's N step of 8 (104 at D 100; timed against the tile
// width 128 on the card, PERF.md)
__host__ __device__ constexpr int vn(int d) { return (d + 7) / 8 * 8; }

// A block of the tensor-core bodies (flash_wgmma_fwd.cuh,
// flash_wgmma_bwd.cuh): kBM rows (queries, or keys for dk/dv) as two
// consumer warpgroups of 64, plus a producer warpgroup
constexpr int kBM = 128;
constexpr int kConsumers = 256;
constexpr int kWgThreads = kConsumers + 128;

// The layouts the bodies are instantiated for. All are a contiguous
// bf16 (B, L, heads, D) tensor to TMA; the tag gives each instantiation a
// __global__ name of its own, so a profile and the SASS tell K1/K2's
// launches from K4's and K5's:
//  - FlatLayout: K1/K2, the projection layout (B, L, heads, D), GQA
//    resolved in the kernel (q head h reads kv head h / (H / Hkv));
//  - HeadMajor: K4, (BH, L, D) launched as B = BH, heads = H = Hkv = 1
//    (the caller has repeated the kv heads);
//  - HeadMajorCarry: K5, K4's layout; the forward body starts each item
//    from the caller's fp32 (m, l, acc) and writes them back (the ring
//    step) instead of writing out and lse.
struct FlatLayout {};
struct HeadMajor {};
struct HeadMajorCarry {};

// The bodies' grids are persistent: one block per SM walks the work items,
// which are numbered heaviest first, in rounds of gridDim.x: in round r
// block b takes item r G + b, or r G + G - 1 - b when r is odd (G =
// gridDim.x), so a block that took one of the heaviest items of a round
// takes one of the lightest of the next. Returns -1 past the last round.
__device__ __forceinline__ int zigzag_item(int r, int items) {
  const int G = gridDim.x, t0 = r * G;
  if (t0 >= items) return -1;
  return t0 + ((r & 1) ? G - 1 - (int)blockIdx.x : (int)blockIdx.x);
}

// Item t of nq query tiles x BH heads (b * H + h; the forward and dq):
// query tile nq - 1 - t / BH of head t % BH
__device__ __forceinline__ void q_tile_item(int t, int BH, int nq, int& bh,
                                            int& q0) {
  bh = t % BH;
  q0 = (nq - 1 - t / BH) * kBM;
}

// the producer warpgroup hands registers to the two consumer warpgroups:
// 168 a thread at launch (384 threads), 40 for the producer, 232 for the
// consumers (128 x 40 + 256 x 232 = 384 x 168)
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

// ---- wgmma ----------------------------------------------------------------

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// all but the last committed group done (groups complete in order)
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// the same for a register A operand (K steps x 4 packed registers): the
// hardware reads it until the wgmma that takes it completes, so it must
// stay where it is until then
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[k][i])::"memory");
}

// 2^x on the special-function unit, denormals flushed: exp2(-inf) = 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a shared-memory matrix descriptor with the 128-byte swizzle
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// k-step kk of a K-major operand: rows row0.. of a tile of R rows
template <int R>
__device__ __forceinline__ uint64_t kmajor(const __nv_bfloat16* tile,
                                           int row0, int kk) {
  const char* p = (const char*)tile + (kk >> 2) * (R * 128) + row0 * 128 +
                  (kk & 3) * 32;
  return desc_sw128(p, 16, 1024);
}

// k-step kk (rows 16 kk .. 16 kk + 15) of an MN-major operand, a tile of R
// rows
template <int R>
__device__ __forceinline__ uint64_t mnmajor(const __nv_bfloat16* tile,
                                            int kk) {
  return desc_sw128((const char*)tile + kk * 16 * 128, R * 128, 1024);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// p (fp32, the accumulator layout) rounded to bf16 as wgmma's register A
// operand: k-step kk's four registers are p[8 kk + 2 x], p[8 kk + 2 x + 1]
template <int BK>
__device__ __forceinline__ void pack_tile(uint32_t (&a)[BK / 16][4],
                                          const float (&p)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      a[kk][x] = pack_bf16(p[8 * kk + 2 * x], p[8 * kk + 2 * x + 1]);
}

// m64nNk16, A and B from shared memory (both K-major), fp32 accumulators
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// m64nNk16 with A from registers at N 48, 80, 96 and 104: the value
// products of K4's head dims 48, 80, 96 and 100, B MN-major over 64-column
// boxes, its last box read in part
__device__ __forceinline__ void wgmma_rs_n48(float (&d)[24],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23},"
      " {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39},"
      " {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47},"
      " {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n104(float (&d)[52],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51},"
      " {%52, %53, %54, %55}, %56, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89,"
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109,"
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (N == 32) wgmma_ss_n32(d, a, b, scale_d);
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, scale_d);
  if constexpr (N == 128) wgmma_ss_n128(d, a, b, scale_d);
  static_assert(N == 32 || N == 64 || N == 128, "no wgmma_ss for this N");
}

// m64nNk16, A from registers, B from shared memory MN-major (transposed)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (N == 48) wgmma_rs_n48(d, a, b, scale_d);
  if constexpr (N == 64) wgmma_rs_n64(d, a, b, scale_d);
  if constexpr (N == 80) wgmma_rs_n80(d, a, b, scale_d);
  if constexpr (N == 96) wgmma_rs_n96(d, a, b, scale_d);
  if constexpr (N == 104) wgmma_rs_n104(d, a, b, scale_d);
  if constexpr (N == 128) wgmma_rs_n128(d, a, b, scale_d);
  if constexpr (N == 256) wgmma_rs_n256(d, a, b, scale_d);
  static_assert(N == 48 || N == 64 || N == 80 || N == 96 || N == 104 ||
                    N == 128 || N == 256,
                "no wgmma_rs for this N");
}

// ---- host: tensor maps ----------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched once from the driver
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = (EncodeTiledFn)p;
  }
  return fn;
}

// the map of a contiguous bf16 (B, L, heads, D) tensor whose box is `rows`
// rows x 64 columns of one head of one batch entry; rows past L and
// columns past D read as zeros. False when the driver refuses it (a base
// address that is not 16-byte aligned, or a row of D bf16 that is not a
// multiple of 16 bytes: D 100, which the bodies load by cp.async).
inline bool make_map(CUtensorMap* map, const void* ptr, int B, int L,
                     int heads, int D, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || ((uintptr_t)ptr & 15) != 0) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)L * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// true when p is a multiple of `bytes` (a power of two)
inline bool aligned(const void* p, uintptr_t bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

// the number of SMs of the current device: a persistent grid's size (0
// when it cannot be read)
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

// shared-memory layout helpers
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return (uint8_t*)(((uintptr_t)p + 1023) & ~(uintptr_t)1023);
}

}  // namespace ffwg
