// Full-f32 product of a [64 queries] × [256 corpus rows] tile over F, for
// kernel B (csrc/tilemax.cu), kernel G's scan and the energy scan
// (csrc/search_fused.cu). Exact FFMA: no tensor cores, no TF32, no bf16
// splitting. Every accumulator sums its F products in ascending k, one fmaf
// each starting from 0, so the result does not depend on the tiling.
//
//   What bounds it on the H100 is the issue of instructions: an SM
//   sub-partition issues one warp instruction a cycle and an FFMA takes a
//   whole issue slot, so every read, copy, barrier and epilogue instruction
//   is an FFMA not issued, and every cycle in which no warp of the
//   sub-partition is ready is one lost. On the H100 the inner loop alone
//   (staged data, no copies, no barriers) issues FFMAs in 75% of its
//   cycles; kernel B as a whole, at F = 2048 where its epilogue hardly
//   counts, in 59%.
//
//   Block. 128 threads (4 warps), two blocks an SM (≤ 255 registers a
//   thread): a thread owns 8 queries × 16 corpus rows (128 accumulators),
//   queries 8·qg .. 8·qg + 7 of the tile and rows tile_row(rg, r) =
//   64·(r >> 2) + 4·rg + (r & 3), r = 0..15, for its query group qg = 0..7
//   and row group rg = 0..15; a warp's lanes are 4 query groups × 8 row
//   groups. Two blocks an SM are what lets one block's epilogue, barriers
//   and copies run while the other block issues FFMAs.
//
//   Staging. Q and X are row-major with F contiguous, so a K-chunk of
//   BK = 32 features is 128 bytes of every row: eight 16-byte units, each
//   brought by one cp.async straight into shared memory. A ring of
//   STAGES = 2 chunks (80 KB) keeps the next chunk's loads in flight while
//   one is multiplied; one __syncthreads() per chunk. The tile is kept
//   untransposed, [row][32 floats], and the inner product reads along K: per
//   16-byte unit (4 features) a thread reads its 8 query units, then one row
//   unit at a time, and does 8 × 4 FMAs per row: 24 reads for 512 FMAs.
//   After the last chunk the ring is free: a caller stages its dot tile
//   there (store_dots) for its epilogue, then starts the next tile's first
//   chunk (tile_prefetch).
//
//   Bank conflicts. Rows are 128 bytes apart, so the same unit of different
//   rows falls into the same banks. Unit u of row r is therefore stored at
//   unit u ^ ((r >> 2) & 7): the 8 row groups that a 16-byte read serves
//   together hold rows 4 apart and read different units, the 4 query groups
//   (rows 8 apart) read different units too, and the 8 consecutive threads
//   that copy one row write its 8 units (conflict-free). Lanes of one query
//   group or row group share an address (a broadcast).
//
//   Edges. Query rows ≥ b, corpus rows ≥ `row_limit` and features ≥ f are
//   zero-filled (cp.async with a source size of 0). A row pitch or base
//   address that is not a multiple of 16 bytes cannot be copied in 16-byte
//   units: `vec == false` selects a loader that reads element by element
//   into the same layout (chosen by the C entry point from f and the
//   pointers, never by catching a failure).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace f32tile {

constexpr int BM = 64;        // queries per tile
constexpr int BN = 256;       // corpus rows per tile
constexpr int BK = 32;        // features per K-chunk (128 bytes a row)
constexpr int STAGES = 2;     // K-chunks in the shared-memory ring
constexpr int UNITS = BK / 4; // 16-byte units per row and chunk
constexpr int THREADS = 128;  // a thread: 8 queries × 16 rows
constexpr int TQ = 8, TR = 16;
constexpr int STAGE_FLOATS = (BM + BN) * BK;
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * (int)sizeof(float);
static_assert((BM * UNITS) % THREADS == 0 && (BN * UNITS) % THREADS == 0,
              "every thread copies the same number of units");
static_assert(BM * BN <= STAGES * STAGE_FLOATS, "the dot tile fits the ring");

// The thread's query group (queries 8·qg .. 8·qg + 7 of the tile) and row
// group (rows tile_row(rg, r)): a warp's lanes are 4 query groups × 8 row
// groups, the 4 warps 2 along the queries × 2 along the rows.
__device__ __forceinline__ int query_group(int tid) { return (tid >> 6) * 4 + ((tid & 31) >> 3); }
__device__ __forceinline__ int row_group(int tid) { return ((tid >> 5) & 1) * 8 + (tid & 7); }

// Row r (0..15) of row group rg: 4 consecutive rows of each 64-row quarter.
__device__ __forceinline__ int tile_row(int rg, int r) { return 64 * (r >> 2) + 4 * rg + (r & 3); }

__device__ __forceinline__ int swizzled(int row, int unit) {
  return row * BK + ((unit ^ ((row >> 2) & 7)) << 2);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int bytes = valid ? 16 : 0;             // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// One 16-byte unit of a row, element by element (any alignment).
__device__ __forceinline__ void load_unit_generic(float* dst, const float* row, bool row_ok,
                                                  int k, int f) {
  float4 v;
  v.x = (row_ok && k + 0 < f) ? row[k + 0] : 0.f;
  v.y = (row_ok && k + 1 < f) ? row[k + 1] : 0.f;
  v.z = (row_ok && k + 2 < f) ? row[k + 2] : 0.f;
  v.w = (row_ok && k + 3 < f) ? row[k + 3] : 0.f;
  *reinterpret_cast<float4*>(dst) = v;
}

// Bring features [k0, k0 + BK) of queries [q0, q0 + BM) and corpus rows
// [c0, c0 + BN) into one stage: Q tile first, X tile behind it.
__device__ __forceinline__ void load_stage(float* stage, const float* __restrict__ Q,
                                           const float* __restrict__ X, int q0, int b,
                                           int64_t c0, int64_t row_limit, int f, int k0,
                                           bool vec, int tid) {
  float* Qs = stage;
  float* Xs = stage + BM * BK;
#pragma unroll
  for (int it = 0; it < BM * UNITS / THREADS; ++it) {
    const int e = tid + it * THREADS;
    const int m = e / UNITS, u = e % UNITS;
    const int k = k0 + u * 4;
    const bool row_ok = q0 + m < b;
    const float* row = Q + (int64_t)(row_ok ? q0 + m : 0) * f;
    if (vec) cp_async16(Qs + swizzled(m, u), row + (k < f ? k : 0), row_ok && k < f);
    else load_unit_generic(Qs + swizzled(m, u), row, row_ok, k, f);
  }
#pragma unroll
  for (int it = 0; it < BN * UNITS / THREADS; ++it) {
    const int e = tid + it * THREADS;
    const int n = e / UNITS, u = e % UNITS;
    const int k = k0 + u * 4;
    const bool row_ok = c0 + n < row_limit;
    const float* row = X + (row_ok ? c0 + n : 0) * f;
    if (vec) cp_async16(Xs + swizzled(n, u), row + (k < f ? k : 0), row_ok && k < f);
    else load_unit_generic(Xs + swizzled(n, u), row, row_ok, k, f);
  }
}

// acc[i][r] += Σ_k Q[8·qg + i][k] · X[tile_row(rg, r)][k] over one staged
// chunk. The loop over units stays rolled: unrolled by 2, the product ran
// slower.
__device__ __forceinline__ void multiply_stage(const float* stage, int qg, int rg,
                                               float (&acc)[TQ][TR]) {
  const float* Qs = stage;
  const float* Xs = stage + BM * BK;
  const int xkey = rg & 7;                 // ((64h + 4rg + j) >> 2) & 7 for all the thread's rows
  const int qkey = (2 * qg) & 7;           // ((8qg + i) >> 2) & 7 = (qkey + (i >> 2)) & 7
#pragma unroll 1
  for (int u = 0; u < UNITS; ++u) {
    float4 a[TQ];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
      a[i] = *reinterpret_cast<const float4*>(Qs + (8 * qg + i) * BK + ((u ^ ((qkey + (i >> 2)) & 7)) << 2));
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(Xs + tile_row(rg, r) * BK + ((u ^ xkey) << 2));
#pragma unroll
      for (int i = 0; i < TQ; ++i) acc[i][r] = fmaf(a[i].x, x.x, acc[i][r]);
#pragma unroll
      for (int i = 0; i < TQ; ++i) acc[i][r] = fmaf(a[i].y, x.y, acc[i][r]);
#pragma unroll
      for (int i = 0; i < TQ; ++i) acc[i][r] = fmaf(a[i].z, x.z, acc[i][r]);
#pragma unroll
      for (int i = 0; i < TQ; ++i) acc[i][r] = fmaf(a[i].w, x.w, acc[i][r]);
    }
  }
}

// Begin a tile: start the copies of its first STAGES − 1 chunks. The ring
// must be free: tile_product ends with a barrier, and a caller that staged
// its dot tile there has read it out behind another.
__device__ __forceinline__ void tile_prefetch(const float* __restrict__ Q,
                                              const float* __restrict__ X, int q0, int b,
                                              int64_t c0, int64_t row_limit, int f, bool vec,
                                              float* smem) {
  const int nk = (f + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage(smem + s * STAGE_FLOATS, Q, X, q0, b, c0, row_limit, f, s * BK, vec, threadIdx.x);
    cp_async_commit();
  }
}

// acc = Q[q0 .. q0+BM) · X[c0 .. c0+BN)ᵀ over all F, for the calling block
// (THREADS threads; `smem` holds SMEM_BYTES, 16-byte aligned), after
// tile_prefetch of the same tile. Ends with a barrier, so the ring may be
// reused at once.
__device__ __forceinline__ void tile_product(const float* __restrict__ Q,
                                             const float* __restrict__ X, int q0, int b,
                                             int64_t c0, int64_t row_limit, int f, bool vec,
                                             float* smem, float (&acc)[TQ][TR]) {
  const int tid = threadIdx.x;
  const int qg = query_group(tid), rg = row_group(tid);
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int r = 0; r < TR; ++r) acc[i][r] = 0.f;

  const int nk = (f + BK - 1) / BK;
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();                 // chunk kc has landed (this thread's copies)
    __syncthreads();                             // ... everyone's; and chunk kc-1 is read out
    const int nxt = kc + STAGES - 1;
    if (nxt < nk)
      load_stage(smem + (nxt % STAGES) * STAGE_FLOATS, Q, X, q0, b, c0, row_limit, f, nxt * BK, vec, tid);
    cp_async_commit();
    multiply_stage(smem + (kc % STAGES) * STAGE_FLOATS, qg, rg, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The dot tile, for an epilogue that any thread may run on any dot: acc
// into `dots` [BM][BN] (the ring, free after tile_product), row 8·qg + i,
// columns tile_row(rg, r), 16-byte writes; ends with a barrier. Staging it
// also ends the accumulators' life before the epilogue's code begins, so
// the two are register-allocated apart.
__device__ __forceinline__ void store_dots(float* dots, const float (&acc)[TQ][TR]) {
  const int qg = query_group(threadIdx.x), rg = row_group(threadIdx.x);
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int h = 0; h < TR / 4; ++h)
      *reinterpret_cast<float4*>(dots + (8 * qg + i) * BN + 64 * h + 4 * rg) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  __syncthreads();
}

}  // namespace f32tile
