// Kernels B and C of the exact λ-aware batched search.
//
// Kernel B (scores_tilemax_kernel) replaces the TPU kernel
// matternet_rs_tpu/ops/pallas/tilemax_fused.py `scores_and_tilemax`
// (_kernel): full-f32 dots of a query batch against the corpus, the guarded
// cosine, the λ blend α·cos + (1-α)(1 - min(|λ-λq|, 1)) with per-query α,
// the `mask_from` -inf mask; it writes the [B, n0] scores once and the
// per-sub-tile maxima [B, n0/256] while the tile is still on chip.
//
//   What bounds it on the H100: operations. At B = 256, N = 1M, F = 128 it
//   does 2·B·n0·F = 65.5 GFLOP of f32 FFMA (0.98 ms at 67 TFLOP/s) against
//   ≈1.5 GB moved (the corpus read once, the scores written once: 0.46 ms
//   at 3.35 TB/s), and FFMAs take whole issue slots, so what the kernel
//   loses is issue: the product's reads and copies, the epilogue, and the
//   cycles in which no warp of a sub-partition can issue.
//
//   Design. A block of 128 threads owns a [64 × 256] output tile at a
//   time: 64 queries by one sub-tile of ts = tile/SUBS = 2048/8 = 256
//   corpus rows; two blocks an SM. The grid is persistent; a block walks
//   items blockIdx.x, + grid, ..., an item being (corpus tile, query block)
//   with the query block fastest, so the query blocks of one corpus tile run
//   side by side and its second and later reads come from L2. The product
//   is csrc/f32_tile_product.cuh, shared with kernel G's scan and the
//   energy scan (8 queries × 16 rows of accumulators a thread, exact FFMA,
//   ascending k, 32-feature chunks by 16-byte cp.async in a 2-stage ring).
//   The epilogue does not run on the accumulators: they go to a dot tile in
//   the ring (free after the product), and each warp then blends 16 whole
//   query rows of it: 16-byte loads of the dots, the guarded cosine (the
//   division by csrc/div_rn.cuh: __fdiv_rn's five FFMAs, with one
//   warp-uniform branch a row to __fdiv_rn itself where an operand is out
//   of their range), the blend and the mask, 16-byte stores of the scores,
//   and the sub-tile's maximum by five shuffles — no atomic, no barrier
//   across warps for it. Staging the dots ends the accumulators' life before
//   the epilogue's code, so each is register-allocated alone; the epilogue
//   of one block runs while the other block of the SM multiplies. The
//   epilogue uses rounded multiplies and adds (no contraction) so it rounds
//   as the plain version does, leaving only the dot's summation order as a
//   difference.
//
//   Limits: the sub-tile width is fixed at 256 corpus rows (tile 2048 with
//   SUBS = 8) and n0 must be a multiple of it; any B, any F. F or a base
//   address that is not a multiple of 16 bytes takes the header's
//   element-wise loader (same layout, same arithmetic).
//
// Kernel C (gather_subtiles_kernel) replaces the TPU kernel
// tilemax_fused.py `gather_subtiles`:
//   cand[b, i·ts + a] = scores[b, sel[b, i]·ts + a].
//   What bounds it: bytes (B·c·ts floats read and written once: ≈7 MB at
//   B = 256, c = 14, ts = 256). Design: one block per (query, selected
//   sub-tile) copies ts contiguous floats with coalesced 16-byte loads
//   and stores. The TPU's 8-row DMA band and masked sublane sum existed
//   for Mosaic's alignment rules and do not carry over; any B works. The
//   exact tier calls it only for kk > 128 (c = kk + 4 > 132); below, the
//   stage that follows takes its place.
//
// The exact tier's candidate stage (subtile_topk_kernel) replaces
// tilemax_fused.py:622 `gather_subtiles` together with the XLA selection
// around it (matternet_rs_tpu/ops/search.py:290-326, `_tilemax_select`):
// per query, the c = min(ns, kk + 4) sub-tiles with the largest maxima
// under (maximum descending, sub-tile id ascending), then the best kk ≤ 16
// of their scores and the ragged tail under (score descending, global id
// ascending) — the order of the plain chain's stable sorts, so values and
// ids are its own bit for bit.
//   What bounds it: bytes, 4·B·(ns + c·ts + nr) + 12·B·kk (8.3 MB, 2.5 µs
//   at B = 256, ns = 3,904, c = 14, ts = 256, nr = 576, kk = 10): less than
//   one launch. The stage is launch-bound, and the design answers that: one
//   launch takes the place of some fifteen PyTorch calls (two full stable
//   sorts, the gather, the concatenation, the index arithmetic) and of the
//   [B, c·ts] candidate plane. One block of 8 warps per query: (a) the
//   maxima row, staged 4,096 at a time by 16-byte cp.async (the tail's
//   copies already in flight), goes through csrc/warp_topk.cuh's
//   take_filtered with k = c, the sub-tile id in the key; (b) one warp sorts
//   the c ids ascending; (c) the c sub-tiles arrive in shared memory by
//   16-byte cp.async, all in flight before any ranking, so the candidates
//   lie in the plain chain's order; (d) take_filtered ranks them and the
//   tail with k = kk, the global id in the key; (e) warp 0 writes the best
//   kk. Nothing is read back to the host, nothing allocated. A row whose
//   address is not a multiple of 16 bytes is read element by element.
//   Where the time goes (clock64 per step, one block a query, two blocks an
//   SM): every warp of the SM runs the same selection code at once, so its
//   steps are bound by the issue of instructions, not by their latency;
//   take_filtered keeps the per-candidate work to one 32-bit compare and
//   lets only the few candidates that reach its bar (about c, then kk, on
//   the main path) into the bitonic networks, ranked by warp 0 alone.
//
// For 16 < kk ≤ 128 the same stage is subtile_topk_wide_kernel: one
// register lane a list entry stops at 32, so this design keeps its lists in
// shared memory. What bounds it: bytes, 4·B·(ns + c·ts + nr) + 12·B·kk
// (32.2 MB, 9.6 µs at B = 256, ns = 3,904, c = 104, nr = 576, kk = 100).
// One block of 512 threads per query reads the maxima, then the c
// sub-tiles and the tail, where they lie (no staging: 12 KB of shared
// memory a block, two blocks an SM). Each selection takes a bar that at
// least k keys reach, lists the few candidates that reach it and ranks
// them against each other, and falls back to an exact radix select where a
// row lets through more than the list holds, so it is exact whatever the
// data (select_best below). Staging the sub-tiles in shared memory (up to
// 140 KB: one block an SM), a 512-wide bitonic sort of the thread bests and
// a ballot per position each measured slower (clock64 per step); what
// bounds this design is the latency of each thread's chain of loads and
// compares, not the bytes (a warm L2 is no faster).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "div_rn.cuh"
#include "f32_tile_product.cuh"
#include "warp_topk.cuh"

namespace {

constexpr int BM = f32tile::BM;                      // queries per block
constexpr int BN = f32tile::BN;                      // corpus rows per block = one sub-tile
constexpr int THREADS = f32tile::THREADS;            // 4 warps: 2 along the queries × 2 along the rows
constexpr int SMEM_BYTES = f32tile::SMEM_BYTES;
constexpr int QW = BM / (THREADS / 32);              // queries a warp blends

// The epilogue of one item from its dot tile: warp w takes queries
// w·QW .. w·QW + QW − 1, lane l columns 4l .. 4l + 3 and 128 + 4l ..
// 128 + 4l + 3: the guarded cosine, the blend and the mask, 16-byte stores
// of the scores, the sub-tile's maximum by shuffles. Lane j < QW loads
// query j's norm, λ and α once; the loop takes them by shuffle.
__device__ __forceinline__ void blend_tile(const float* dots, const float* __restrict__ norms,
                                           const float* __restrict__ lams, const float* __restrict__ qn,
                                           const float* __restrict__ ql, const float* __restrict__ alpha,
                                           int64_t mask_from, int q0, int b, int64_t tile, int64_t n0,
                                           int64_t ns, float* __restrict__ scores,
                                           float* __restrict__ submax, int warp, int lane) {
  const int64_t c0 = tile * BN;
  float nrm[8], lm[8];
  bool masked[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int64_t col = c0 + (j < 4 ? 4 * lane + j : 128 + 4 * lane + (j - 4));
    nrm[j] = norms[col];
    lm[j] = lams[col];
    masked[j] = col >= mask_from;
  }
  const int qj = q0 + warp * QW + lane % QW;
  const bool okj = qj < b;
  const float qn_l = okj ? qn[qj] : 0.f, ql_l = okj ? ql[qj] : 0.f, al_l = okj ? alpha[qj] : 0.f;
#pragma unroll 1                                 // unrolled by 2, 4 or 16: slower
  for (int qq = 0; qq < QW; ++qq) {
    const int q = warp * QW + qq;
    const int bq = q0 + q;
    if (bq >= b) break;
    const float qnb = __shfl_sync(0xffffffffu, qn_l, qq), qlb = __shfl_sync(0xffffffffu, ql_l, qq);
    const float ab = __shfl_sync(0xffffffffu, al_l, qq);
    const float4 d0 = *reinterpret_cast<const float4*>(dots + q * BN + 4 * lane);
    const float4 d1 = *reinterpret_cast<const float4*>(dots + q * BN + 128 + 4 * lane);
    const float d[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
    float den[8], cosv[8];
    bool slow = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float denom = __fmul_rn(qnb, nrm[j]);
      den[j] = fmaxf(denom, 1e-12f);
      cosv[j] = denom > 1e-12f ? divrn::div_fast(d[j], den[j]) : 0.f;
      slow |= denom > 1e-12f && !divrn::div_in_range(d[j], den[j]);
    }
    if (__any_sync(0xffffffffu, slow)) {         // a pair out of div_fast's range: the row exactly
#pragma unroll
      for (int j = 0; j < 8; ++j) cosv[j] = den[j] > 1e-12f ? __fdiv_rn(d[j], den[j]) : 0.f;
    }
    float s[8];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float lsim = __fsub_rn(1.f, fminf(fabsf(__fsub_rn(lm[j], qlb)), 1.f));
      float v = __fadd_rn(__fmul_rn(ab, cosv[j]), __fmul_rn(__fsub_rn(1.f, ab), lsim));
      if (masked[j]) v = -INFINITY;
      s[j] = v;
      m = fmaxf(m, v);
    }
    float* row = scores + (int64_t)bq * n0 + c0;
    *reinterpret_cast<float4*>(row + 4 * lane) = make_float4(s[0], s[1], s[2], s[3]);
    *reinterpret_cast<float4*>(row + 128 + 4 * lane) = make_float4(s[4], s[5], s[6], s[7]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) submax[(int64_t)bq * ns + tile] = m;
  }
}

__global__ void __launch_bounds__(THREADS, 2)
scores_tilemax_kernel(const float* __restrict__ X, const float* __restrict__ norms,
                      const float* __restrict__ lams, const float* __restrict__ Q,
                      const float* __restrict__ qn, const float* __restrict__ ql,
                      const float* __restrict__ alpha, int64_t mask_from,
                      int64_t n0, int f, int b, int qblocks, int vec,
                      float* __restrict__ scores, float* __restrict__ submax) {
  extern __shared__ __align__(16) float ring[];
  const int tid = threadIdx.x;
  const int64_t ns = n0 / BN;
  const int64_t items = ns * qblocks;     // item = (corpus tile, query block), query block fastest

  int64_t item = blockIdx.x;
  if (item < items)
    f32tile::tile_prefetch(Q, X, (int)(item % qblocks) * BM, b, (item / qblocks) * BN, n0, f, vec != 0,
                           ring);
  for (; item < items; item += gridDim.x) {
    const int q0 = (int)(item % qblocks) * BM;
    const int64_t tile = item / qblocks;
    float acc[f32tile::TQ][f32tile::TR];
    f32tile::tile_product(Q, X, q0, b, tile * BN, n0, f, vec != 0, ring, acc);
    f32tile::store_dots(ring, acc);
    blend_tile(ring, norms, lams, qn, ql, alpha, mask_from, q0, b, tile, n0, ns, scores, submax,
               tid >> 5, tid & 31);
    __syncthreads();                             // the dot tile is read out: the ring is free
    const int64_t next = item + gridDim.x;
    if (next < items)
      f32tile::tile_prefetch(Q, X, (int)(next % qblocks) * BM, b, (next / qblocks) * BN, n0, f,
                             vec != 0, ring);
  }
}

__global__ void gather_subtiles_kernel(const float* __restrict__ scores,
                                       const int64_t* __restrict__ sel,
                                       float* __restrict__ out, int c, int ts,
                                       int64_t n0) {
  const int64_t bi = blockIdx.x;           // query b = bi / c, slot i = bi % c
  const int64_t b = bi / c;
  const int64_t s = sel[bi];
  float* dst = out + bi * ts;               // out [B, c·ts]: row b, slot i
  if (s < 0 || (s + 1) * ts > n0) {         // out-of-range selection → NaN
    for (int a = threadIdx.x; a < ts; a += blockDim.x) dst[a] = NAN;
    return;
  }
  const float* src = scores + b * n0 + s * ts;
  if ((ts & 3) == 0 && (n0 & 3) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int a = threadIdx.x; a < ts / 4; a += blockDim.x) d4[a] = s4[a];
  } else {
    for (int a = threadIdx.x; a < ts; a += blockDim.x) dst[a] = src[a];
  }
}

constexpr int TOPK_TS = 256;                          // sub-tile width (kernel B's)
constexpr int TOPK_MAX_C = 20;                        // c ≤ kk + SELECT_MARGIN = 16 + 4
constexpr int TOPK_MAX_K = 16;
constexpr int TOPK_MAX_TAIL = 2048;                   // the ragged tail: less than a tile
constexpr int TOPK_CHUNK = 4096;                      // maxima staged at a time
constexpr int TOPK_THREADS = 32 * warptopk::WARPS;
constexpr int TOPK_TAIL_AT = TOPK_MAX_C * TOPK_TS;    // the tail's place in the staging buffer
static_assert(TOPK_CHUNK <= TOPK_TAIL_AT, "a maxima chunk must not reach the tail");

// len floats from src into shared dst (16-byte aligned): 16-byte cp.async
// when src is 16-byte aligned, element by element otherwise and for what
// is left past the last whole unit.
__device__ __forceinline__ void stage_row(float* dst, const float* src, int len, int tid) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int u = tid; u < len / 4; u += TOPK_THREADS) f32tile::cp_async16(dst + 4 * u, src + 4 * u, true);
    done = len & ~3;
  }
  for (int e = done + tid; e < len; e += TOPK_THREADS) dst[e] = src[e];
}

__global__ void __launch_bounds__(TOPK_THREADS)
subtile_topk_kernel(const float* __restrict__ scores, const float* __restrict__ submax,
                    const float* __restrict__ tail, int ns, int nr, int c, int k,
                    float* __restrict__ top, int64_t* __restrict__ idx) {
  using warptopk::Cand;
  __shared__ __align__(16) float buf[TOPK_TAIL_AT + TOPK_MAX_TAIL];
  __shared__ Cand lists[warptopk::WARPS][32];
  __shared__ int sel[TOPK_MAX_C];
  __shared__ uint16_t picked[TOPK_TAIL_AT + TOPK_MAX_TAIL];   // positions that reach a bar
  __shared__ int npicked;
  __shared__ Cand kth;
  const int64_t bq = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = ns * TOPK_TS;
  const float* mrow = submax + bq * ns;
  const float* srow = scores + bq * n0;

  // The tail does not depend on the selection: its copies fly during it.
  if (nr > 0) stage_row(buf + TOPK_TAIL_AT, tail + bq * nr, nr, tid);

  // (a) The c sub-tiles with the largest maxima, into warp 0's list.
  Cand list = warptopk::nothing(), floor = warptopk::nothing();
  for (int c0 = 0; c0 < ns; c0 += TOPK_CHUNK) {
    const int len = min(TOPK_CHUNK, ns - c0);
    stage_row(buf, mrow + c0, len, tid);
    f32tile::cp_async_commit();
    f32tile::cp_async_wait<0>();
    __syncthreads();
    warptopk::take_filtered(list, floor, lists, picked, &npicked, len, c, tid,
                            [&](int e) { return buf[e]; }, [&](int e) { return c0 + e; });
    if (c0 + TOPK_CHUNK < ns) {                       // the next chunk's floor; its copies wait
      if (warp == 0 && lane == c - 1) kth = list;
      __syncthreads();
      floor = kth;
    }
  }

  // (b) Their ids ascending (warp 0 holds the best c in lanes 0 .. c-1).
  if (warp == 0) {
    uint32_t s = lane < c ? (uint32_t)warptopk::key_id(list.key) : 0xffffffffu;
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
      for (int m = size >> 1; m > 0; m >>= 1) {
        const uint32_t o = __shfl_xor_sync(0xffffffffu, s, m);
        s = (((lane & m) == 0) == ((lane & size) == 0)) ? min(s, o) : max(s, o);
      }
    if (lane < c) sel[lane] = (int)s;
  }
  __syncthreads();

  // (c) The selected sub-tiles, all in flight at once.
  const bool vec = (reinterpret_cast<uintptr_t>(srow) & 15) == 0;
  for (int u = tid; u < c * (TOPK_TS / 4); u += TOPK_THREADS) {
    const int i = u / (TOPK_TS / 4), a = (u % (TOPK_TS / 4)) * 4;
    const float* src = srow + (int64_t)sel[i] * TOPK_TS + a;
    if (vec) {
      f32tile::cp_async16(buf + i * TOPK_TS + a, src, true);
    } else {
      for (int j = 0; j < 4; ++j) buf[i * TOPK_TS + a + j] = src[j];
    }
  }
  f32tile::cp_async_commit();
  f32tile::cp_async_wait<0>();
  __syncthreads();

  // (d) The best k of the c·ts candidates and the tail; candidate e is
  // what the plain chain's candidate row holds at position e.
  const int main_len = c * TOPK_TS;
  auto at = [&](int e) { return e < main_len ? e : TOPK_TAIL_AT + (e - main_len); };
  auto gid = [&](int e) { return e < main_len ? sel[e / TOPK_TS] * TOPK_TS + e % TOPK_TS : n0 + (e - main_len); };
  list = warptopk::nothing();
  warptopk::take_filtered(list, warptopk::nothing(), lists, picked, &npicked, main_len + nr, k, tid,
                          [&](int e) { return buf[at(e)]; }, gid);

  // (e)
  if (warp == 0 && lane < k) {
    top[bq * k + lane] = buf[at(list.pos)];
    idx[bq * k + lane] = gid(list.pos);
  }
}

// ---- The candidate stage for 16 < k ≤ 128 (subtile_topk_wide_kernel) ----
//
// One block of WIDE_THREADS per query. Each of its two selections (the c
// best sub-tiles by (maximum, sub-tile id), then the best k candidates by
// (score, global id)) takes the best k of n distinct 64-bit keys
// (warp_topk.cuh's order_key) in select_best:
//   1. a bar that at least k keys reach, so every one of the best k does:
//      for the candidates, the c-th best maximum's score (each selected
//      sub-tile holds its maximum), checked by counting; otherwise, or
//      where fewer than k or more than `cap` keys reach it, the k-th best
//      of the thread bests (thread t's best key of its units of 4
//      positions t, t + WIDE_THREADS, ...), found by a sort of 32 in each
//      warp and the thread bests' ranks by binary search in the 16 sorted
//      lists;
//   2. the keys that reach it are compacted (an atomic each: few reach it)
//      into a list of `cap` (≤ WIDE_CAP) entries; a pass compares
//      the score's half of each key and computes a position's id only
//      where the score ties the bar's or passes;
//   3. where more than `cap` reach it, an exact MSB-first radix select on
//      the keys that reach it — 8-bit digits, a shared histogram, warp-
//      aggregated increments — finds the k-th key itself, and the keys
//      from there are compacted again: exactly k;
//   4. each listed key's rank is the number of listed keys above it (the
//      keys are distinct): ranks below k are written out in key order.
// Every pass reads the maxima or the candidates from device memory where
// they lie, 16 bytes a thread where the row is aligned, the next UNROLL
// units of 4 in flight while a thread compares the last (the candidates
// once on the common path; a fallback reads them again from L2), so a
// block needs 12 KB of shared memory and two share an SM (64 registers).
// Nothing is read back to the host or allocated; positions are 32-bit.

constexpr int WIDE_THREADS = 512;
constexpr int WIDE_WARPS = WIDE_THREADS / 32;
constexpr int WIDE_MAX_K = 128;
constexpr int WIDE_MAX_C = WIDE_MAX_K + 4;            // c ≤ kk + SELECT_MARGIN
constexpr int WIDE_CAP = 512;                         // a bar's survivors ranked directly
constexpr int UNROLL = 2;                             // units of 4 positions a thread loads at a time
constexpr unsigned FULL = 0xffffffffu;

struct WideShared {
  uint64_t key[WIDE_CAP];                             // the listed candidates' keys
  uint32_t pos[WIDE_CAP];                             // and positions
  uint64_t best[WIDE_THREADS];                        // the thread bests, a sorted list a warp
  uint32_t hist[256];
  int top[WIDE_MAX_C];                                // the best c sub-tiles, by key
  int sel[WIDE_MAX_C];                                // the same, ids ascending
  uint64_t prefix, bar, kth;
  int count, need, done;
};

__device__ __forceinline__ void load4(const float* p, bool vec, float (&v)[4]) {
  if (vec) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = p[j];
  }
}

// A query's sub-tile maxima: position e is sub-tile e.
struct MaximaRow {
  const float* row;
  int n;
  bool vec;                                           // row 16-byte aligned
  __device__ void load(int u, float (&v)[4]) const {
    const int e = 4 * u;
    if (e + 4 <= n) {
      load4(row + e, vec, v);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = e + j < n ? row[e + j] : 0.f;
    }
  }
  __device__ int id(int e) const { return e; }
  __device__ float value(int e) const { return row[e]; }
};

// A query's candidates in the plain chain's order: the selected sub-tiles
// (ids ascending, `sel`), then the tail; n = main_len + nr.
struct CandidateRow {
  const float* srow;                                  // the query's scores [n0]
  const float* trow;                                  // its tail [nr]
  const int* sel;
  int main_len, n, n0;
  bool vec;                                           // srow 16-byte aligned
  __device__ void load(int u, float (&v)[4]) const {
    const int e = 4 * u;                              // main_len is a multiple of 4
    if (e < main_len) {
      load4(srow + sel[e / TOPK_TS] * TOPK_TS + e % TOPK_TS, vec, v);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = e + j < n ? trow[e + j - main_len] : 0.f;
    }
  }
  __device__ int id(int e) const {
    return e < main_len ? sel[e / TOPK_TS] * TOPK_TS + e % TOPK_TS : n0 + (e - main_len);
  }
  __device__ float value(int e) const {
    return e < main_len ? srow[sel[e / TOPK_TS] * TOPK_TS + e % TOPK_TS] : trow[e - main_len];
  }
};

// UNROLL units of the row from unit u0 on (this thread's: u0 + i·WIDE_THREADS
// + tid), and f for each of their positions.
template <class Row>
__device__ __forceinline__ void load_units(const Row& row, int u0, int units, int tid, float (&v)[UNROLL][4]) {
#pragma unroll
  for (int i = 0; i < UNROLL; ++i) {
    const int u = u0 + i * WIDE_THREADS + tid;
    if (u < units) row.load(u, v[i]);
  }
}
template <class Row, class F>
__device__ __forceinline__ void take_units(const Row& row, int u0, int tid, const float (&v)[UNROLL][4], F& f) {
#pragma unroll
  for (int i = 0; i < UNROLL; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = 4 * (u0 + i * WIDE_THREADS + tid) + j;
      const bool valid = e < row.n;
      f(e, valid ? warptopk::score_bits(v[i][j]) : 0u, valid);
    }
}

// f(e, bits, valid) for every position e of the row, `bits` its score's
// half of the key (warp_topk.cuh's score_bits): thread t takes the units
// of 4 positions t, t + WIDE_THREADS, ..., ascending, UNROLL units loaded
// at once and the next UNROLL in flight while it compares. Every lane of a
// warp calls f together (it may use warp votes). A position's id, the
// key's other half, is computed only where the score leaves the order
// open.
template <class Row, class F>
__device__ __forceinline__ void for_scores(const Row& row, int tid, F f) {
  constexpr int STEP = UNROLL * WIDE_THREADS;
  const int units = (row.n + 3) / 4;
  float a[UNROLL][4], b[UNROLL][4];
  load_units(row, 0, units, tid, a);
  for (int u0 = 0; u0 < units; u0 += 2 * STEP) {
    if (u0 + STEP < units) load_units(row, u0 + STEP, units, tid, b);
    take_units(row, u0, tid, a, f);
    if (u0 + STEP >= units) break;                  // block-uniform
    if (u0 + 2 * STEP < units) load_units(row, u0 + 2 * STEP, units, tid, a);
    take_units(row, u0 + STEP, tid, b, f);
  }
}

// Whether position e's key (its score's `bits`, then its id) is ≥ bar.
template <class Row>
__device__ __forceinline__ bool reaches(const Row& row, int e, uint32_t bits, uint64_t bar) {
  const uint32_t bar_bits = (uint32_t)(bar >> 32);
  return bits > bar_bits || (bits == bar_bits && warptopk::id_bits(row.id(e)) >= (uint32_t)bar);
}

// The k-th best of the thread bests (0 where fewer than k threads saw a
// candidate: every key is above 0). Ids ascend with positions, so a
// thread's first position of its best score holds its best key.
template <class Row>
__device__ uint64_t thread_best_bar(WideShared& s, const Row& row, int k, int tid) {
  const int lane = tid & 31;
  uint32_t best_bits = 0;                             // below every score's (−inf's: 0x007fffff)
  int best_e = -1;
  for_scores(row, tid, [&](int e, uint32_t bits, bool) {
    if (bits > best_bits) {
      best_bits = bits;
      best_e = e;
    }
  });
  uint64_t best = best_e < 0 ? 0ull : ((uint64_t)best_bits << 32) | warptopk::id_bits(row.id(best_e));
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)        // bitonic, best in lane 0
#pragma unroll
    for (int m = size >> 1; m > 0; m >>= 1) {
      const uint64_t o = __shfl_xor_sync(FULL, best, m);
      const bool take_larger = ((lane & m) == 0) == ((lane & size) == 0);
      best = take_larger == (o > best) ? o : best;
    }
  s.best[tid] = best;
  if (tid == 0) s.bar = 0;
  __syncthreads();
  if (best != 0) {                                    // its rank: the larger keys of every list
    int lo[WIDE_WARPS];
#pragma unroll
    for (int w = 0; w < WIDE_WARPS; ++w) lo[w] = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1)       // the 16 searches side by side
#pragma unroll
      for (int w = 0; w < WIDE_WARPS; ++w)
        if (s.best[w * 32 + lo[w] + step - 1] > best) lo[w] += step;
    int r = 0;
#pragma unroll
    for (int w = 0; w < WIDE_WARPS; ++w) r += lo[w] + (s.best[w * 32 + lo[w]] > best ? 1 : 0);
    if (r == k - 1) s.bar = best;
  }
  __syncthreads();
  const uint64_t bar = s.bar;
  __syncthreads();                                    // s.bar is reset by the next call
  return bar;
}

// The keys ≥ bar into the list (the first `room` of them); returns how
// many there are, counted past `room`.
template <class Row>
__device__ int compact(WideShared& s, const Row& row, uint64_t bar, int room, int tid) {
  if (tid == 0) s.count = 0;
  __syncthreads();
  for_scores(row, tid, [&](int e, uint32_t bits, bool valid) {
    if (valid && reaches(row, e, bits, bar)) {      // few do: an atomic each
      const int i = atomicAdd(&s.count, 1);
      if (i < room) {
        s.key[i] = ((uint64_t)bits << 32) | warptopk::id_bits(row.id(e));
        s.pos[i] = (uint32_t)e;
      }
    }
  });
  __syncthreads();
  const int count = s.count;
  __syncthreads();                                    // s.count is reset by the next call
  return count;
}

// The k-th best key among the keys ≥ lo (at least k of them), MSB first,
// 8 bits a round; returns the threshold from which exactly k keys are ≥ lo
// and ≥ it. A round ends the search once the digit that holds the k-th
// key holds nothing beyond it; the last round always does (distinct keys).
template <class Row>
__device__ uint64_t radix_kth(WideShared& s, const Row& row, int k, uint64_t lo, int tid) {
  uint64_t prefix = 0;
  int need = k;
  for (int shift = 56; shift >= 0; shift -= 8) {
    const uint64_t hi = shift == 56 ? 0ull : ~0ull << (shift + 8);
    if (tid < 256) s.hist[tid] = 0;
    __syncthreads();
    for_scores(row, tid, [&](int e, uint32_t bits, bool valid) {
      const uint64_t key = valid ? ((uint64_t)bits << 32) | warptopk::id_bits(row.id(e)) : 0ull;
      const int d = valid && key >= lo && (key & hi) == prefix ? (int)((key >> shift) & 255) : -1;
      const unsigned peers = __match_any_sync(FULL, d);   // one increment per digit a warp
      if (d >= 0 && (tid & 31) == __ffs(peers) - 1) atomicAdd(&s.hist[d], (uint32_t)__popc(peers));
    });
    __syncthreads();
    if (tid < 32) {                                   // lane l holds digits 8l .. 8l + 7
      uint32_t h[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        h[j] = s.hist[tid * 8 + j];
        sum += h[j];
      }
      uint32_t suf = sum;                             // the digits of lanes ≥ this one
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t t = __shfl_down_sync(FULL, suf, o);
        if (tid + o < 32) suf += t;
      }
      uint32_t acc = suf - sum;                       // keys in larger digits
#pragma unroll
      for (int j = 7; j >= 0; --j) {
        if (acc < (uint32_t)need && acc + h[j] >= (uint32_t)need) {
          s.prefix = prefix | ((uint64_t)(tid * 8 + j) << shift);
          s.need = need - (int)acc;
          s.done = h[j] == (uint32_t)(need - (int)acc);
        }
        acc += h[j];
      }
    }
    __syncthreads();
    prefix = s.prefix;
    need = s.need;
    if (s.done) break;                                // block-uniform
  }
  return prefix > lo ? prefix : lo;
}

// Steps 1-3 above: lists at least k and at most WIDE_CAP candidates, the
// best k among them; returns how many. `hint` (0: none) is a bar to try
// first; where fewer than k or more than `cap` keys reach it, the thread
// bests' bar is taken if it is the higher (both are valid bars then).
template <class Row>
__device__ int select_best(WideShared& s, const Row& row, int k, int cap, uint64_t hint, int tid) {
  uint64_t bar = hint;
  int m = hint != 0 ? compact(s, row, bar, cap, tid) : 0;
  if (m < k || m > cap) {
    const uint64_t own = thread_best_bar(s, row, k, tid);
    if (m < k || own > bar) {
      bar = own;
      m = compact(s, row, bar, cap, tid);
    }
  }
  if (m > cap) m = compact(s, row, radix_kth(s, row, k, bar, tid), WIDE_CAP, tid);
  return m;
}

// Step 4: emit(r, pos) for the listed candidates of rank r < k; s.kth
// becomes the k-th key.
template <class Emit>
__device__ void rank_best(WideShared& s, int m, int k, int tid, Emit emit) {
  for (int i = tid; i < m; i += WIDE_THREADS) {
    const uint64_t key = s.key[i];
    int r = 0;
#pragma unroll 8
    for (int j = 0; j < m; ++j) r += s.key[j] > key;
    if (r < k) emit(r, s.pos[i]);
    if (r == k - 1) s.kth = key;
  }
}

__global__ void __launch_bounds__(WIDE_THREADS, 2)
subtile_topk_wide_kernel(const float* __restrict__ scores, const float* __restrict__ submax,
                         const float* __restrict__ tail, int ns, int nr, int c, int k, int cap,
                         float* __restrict__ top, int64_t* __restrict__ idx) {
  __shared__ WideShared s;
  const int64_t bq = blockIdx.x;
  const int tid = threadIdx.x;
  const int n0 = ns * TOPK_TS, main_len = c * TOPK_TS;
  const float* mrow = submax + bq * ns;
  const float* srow = scores + bq * n0;

  // (a) The c sub-tiles with the largest maxima; (b) their ids ascending.
  const MaximaRow maxima{mrow, ns, (reinterpret_cast<uintptr_t>(mrow) & 15) == 0};
  int m = select_best(s, maxima, c, cap, 0ull, tid);
  rank_best(s, m, c, tid, [&](int r, uint32_t pos) { s.top[r] = (int)pos; });
  __syncthreads();
  for (int i = tid; i < c; i += WIDE_THREADS) {
    const int id = s.top[i];
    int r = 0;
#pragma unroll 8
    for (int j = 0; j < c; ++j) r += s.top[j] < id;
    s.sel[r] = id;
  }
  __syncthreads();

  // (c, d) The best k of the candidates, written in order; the first bar
  // is the c-th best maximum's score, whatever the id.
  const CandidateRow cand{srow, tail + bq * nr, s.sel, main_len, main_len + nr, n0,
                          (reinterpret_cast<uintptr_t>(srow) & 15) == 0};
  m = select_best(s, cand, k, cap, s.kth & 0xffffffff00000000ull, tid);
  rank_best(s, m, k, tid, [&](int r, uint32_t pos) {
    top[bq * k + r] = cand.value((int)pos);
    idx[bq * k + r] = cand.id((int)pos);
  });
}

// 16-byte copies need f a multiple of 4 floats and both addresses aligned.
inline int vec_copies(const float* X, const float* Q, int f) {
  return f % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(Q) % 16 == 0;
}

}  // namespace

extern "C" {

const char* mrs_cuda_strerror(int rc) { return cudaGetErrorString((cudaError_t)rc); }

// X [N, f] (only the first n0 rows are read), norms/lams [N], Q [b, f],
// qn/ql/alpha [b] → scores [b, n0], submax [b, n0/256]; float32, contiguous.
// n0 % 256 == 0. 16-byte copies when f is a multiple of 4 and X and Q are
// 16-byte aligned, the element-wise loader otherwise. Returns
// cudaGetLastError() after the launch.
int mrs_scores_tilemax(const float* X, const float* norms, const float* lams,
                       const float* Q, const float* qn, const float* ql,
                       const float* alpha, int64_t mask_from, int64_t n0, int f,
                       int b, float* scores, float* submax, void* stream) {
  if (n0 % BN != 0 || f <= 0) return (int)cudaErrorInvalidValue;
  const int qblocks = (b + BM - 1) / BM;
  int64_t blocks = (n0 / BN) * qblocks;
  if (blocks == 0) return 0;
  cudaError_t rc = cudaFuncSetAttribute(scores_tilemax_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  int dev = 0, sms = 0, per_sm = 0;
  if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scores_tilemax_kernel, THREADS, SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  // Persistent: a block walks items blockIdx.x, + grid, ...; two blocks an SM.
  if (blocks > (int64_t)sms * per_sm) blocks = (int64_t)sms * per_sm;
  const int vec = vec_copies(X, Q, f);
  scores_tilemax_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      X, norms, lams, Q, qn, ql, alpha, mask_from, n0, f, b, qblocks, vec, scores, submax);
  return (int)cudaGetLastError();
}

// What mrs_scores_tilemax chooses for these addresses and f: *vec 1 for
// 16-byte copies, 0 for the element-wise loader; *queries_per_block and the
// dynamic shared memory *smem in bytes, the same for every launch.
int mrs_scores_tilemax_plan(const float* X, const float* Q, int f, int* vec,
                            int* queries_per_block, int* smem) {
  *vec = vec_copies(X, Q, f);
  *queries_per_block = BM;
  *smem = SMEM_BYTES;
  return 0;
}

// scores [b, n0], sel [b, c] int64 → out [b, c·ts]. 16-byte copies when
// ts and n0 are multiples of 4 (the base pointers come from the caching
// allocator, which aligns them). Returns cudaGetLastError().
int mrs_gather_subtiles(const float* scores, const int64_t* sel, float* out,
                        int b, int c, int ts, int64_t n0, void* stream) {
  const int64_t blocks = (int64_t)b * c;
  gather_subtiles_kernel<<<(unsigned)blocks, 64, 0, (cudaStream_t)stream>>>(
      scores, sel, out, c, ts, n0);
  return (int)cudaGetLastError();
}

// scores [b, ns·256], submax [b, ns], tail [b, nr] (null when nr = 0),
// float32 contiguous → top [b, k] float32 and idx [b, k] int64: per query
// the best k (≤ 16) of the c (≤ 20, ≤ ns) sub-tiles with the largest maxima
// and the tail (nr ≤ 2048), under (score descending, global id ascending),
// the tail's ids following n0 = ns·256; n0 + nr < 2^31. Returns
// cudaGetLastError() after the launch.
int mrs_subtile_topk(const float* scores, const float* submax, const float* tail, int b, int ns,
                     int nr, int c, int k, float* top, int64_t* idx, void* stream) {
  if (b <= 0 || ns <= 0 || c < 1 || c > TOPK_MAX_C || c > ns || k < 1 || k > TOPK_MAX_K ||
      nr < 0 || nr > TOPK_MAX_TAIL || (nr > 0 && tail == nullptr) ||
      (int64_t)ns * TOPK_TS + nr > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  subtile_topk_kernel<<<b, TOPK_THREADS, 0, (cudaStream_t)stream>>>(scores, submax, tail, ns, nr,
                                                                     c, k, top, idx);
  return (int)cudaGetLastError();
}


// As mrs_subtile_topk for 16 < k ≤ 128 (any k ≥ 1 is taken): c ≤ 132 and
// c ≤ ns, k ≤ c·256 + nr. `cap` (0 .. 512; the wrapper passes 512) is how
// many candidates a bar may let through before the radix select takes
// over; 0 sends every selection through the radix select. Returns
// cudaGetLastError() after the launch.
int mrs_subtile_topk_wide(const float* scores, const float* submax, const float* tail, int b, int ns,
                          int nr, int c, int k, int cap, float* top, int64_t* idx, void* stream) {
  if (b <= 0 || ns <= 0 || c < 1 || c > WIDE_MAX_C || c > ns || k < 1 || k > WIDE_MAX_K ||
      k > c * TOPK_TS + nr || cap < 0 || cap > WIDE_CAP || nr < 0 || nr > TOPK_MAX_TAIL ||
      (nr > 0 && tail == nullptr) || (int64_t)ns * TOPK_TS + nr > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  subtile_topk_wide_kernel<<<b, WIDE_THREADS, 0, (cudaStream_t)stream>>>(scores, submax, tail, ns, nr, c,
                                                                       k, cap, top, idx);
  return (int)cudaGetLastError();
}

// What mrs_subtile_topk_wide chooses: *threads a block (one block a
// query) and the *cap the wrapper passes.
int mrs_subtile_topk_wide_plan(int* threads, int* cap) {
  *threads = WIDE_THREADS;
  *cap = WIDE_CAP;
  return 0;
}

}  // extern "C"
