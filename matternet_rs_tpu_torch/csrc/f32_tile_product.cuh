// Full-f32 product of a [BM queries] × [256 corpus rows] tile over F, for
// kernel B (csrc/tilemax.cu) and kernel G's scan (csrc/search_fused.cu),
// both with BM = 64. Exact FFMA: no tensor cores, no TF32, no bf16
// splitting. Every accumulator sums its F products in ascending k, one fmaf
// each, so the result does not depend on the tiling.
//
//   Thread map. THREADS = 4·BM; a thread owns 8 queries × 8 corpus rows:
//   query group qg (queries 8qg .. 8qg+7 of the block) and row group rg
//   (rows 4rg .. 4rg+3 and 128+4rg .. 128+4rg+3 of the tile). LQ says how a
//   warp's lanes are laid over the two: LQ = 1 gives a warp 8 queries × all
//   256 rows (kernel G keeps each query's running list in the warp that owns
//   it), LQ = 4 gives it 32 queries × 64 rows (kernel B: its lanes then read
//   8 distinct row units and 4 distinct query units instead of 32 and 1).
//
//   Staging. Q and X are row-major with F contiguous, so a K-chunk of
//   BK = 32 features is 128 bytes of every row: eight 16-byte units, each
//   brought by one cp.async straight into shared memory (no register
//   staging, no transpose). A ring of STAGES = 3 chunks keeps two chunks'
//   loads in flight while the third is multiplied; one __syncthreads() per
//   chunk. A caller that walks several tiles starts the next tile's first
//   chunks (tile_prefetch) before its own epilogue. The tile is kept
//   untransposed, [row][32 floats], and the inner product reads along K: a
//   thread takes one float4 (4 consecutive k) of each of its 8 rows and,
//   query by query, one float4 of the query, and does the 4 × 64 FMAs —
//   16 FMAs per 16-byte shared-memory read, which is what bounds this
//   design: a 16-byte read returns 512 bytes to a warp, 4 cycles of the
//   SM's 128 bytes a cycle, against 16 cycles of FMA dispatch for the warp.
//
//   Bank conflicts. Rows are 128 bytes apart, so the same unit of different
//   rows falls into the same banks. Unit u of row r is therefore stored at
//   unit u ^ ((r >> 2) & 7): the lanes that a 16-byte read serves together
//   hold rows 4 apart and so read different units (conflict-free), and the
//   8 consecutive threads that copy one row write its 8 units (conflict-
//   free). Lanes of one query group read one address (a broadcast).
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

constexpr int BN = 256;       // corpus rows per tile
constexpr int BK = 32;        // features per K-chunk (128 bytes a row)
constexpr int STAGES = 3;     // K-chunks in the shared-memory ring
constexpr int UNITS = BK / 4; // 16-byte units per row and chunk

template <int BM, int LQ>
struct Tile {
  static constexpr int THREADS = 4 * BM;              // a thread: 8 queries × 8 rows
  static constexpr int LR = 32 / LQ;                  // lanes along the corpus rows
  static constexpr int WR = 32 / LR;                  // warps along the corpus rows
  // The thread's query group (queries 8·qg .. 8·qg + 7 of the block) and row
  // group (rows 4·rg .. 4·rg + 3 and 128 + 4·rg .. 128 + 4·rg + 3 of the tile).
  static __device__ __forceinline__ int query_group(int tid) {
    return ((tid >> 5) / WR) * LQ + (tid & 31) / LR;
  }
  static __device__ __forceinline__ int row_group(int tid) {
    return ((tid >> 5) % WR) * LR + (tid & 31) % LR;
  }
  static constexpr int STAGE_FLOATS = (BM + BN) * BK;
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * (int)sizeof(float);
  static_assert((BM * UNITS) % THREADS == 0 && (BN * UNITS) % THREADS == 0,
                "every thread copies the same number of units");
};

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
template <int BM, int LQ>
__device__ __forceinline__ void load_stage(float* stage, const float* __restrict__ Q,
                                           const float* __restrict__ X, int q0, int b,
                                           int64_t c0, int64_t row_limit, int f, int k0,
                                           bool vec, int tid) {
  constexpr int THREADS = Tile<BM, LQ>::THREADS;
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

// acc[i][j] += Σ_k Q[8·tr + i][k] · X[col(j)][k] over one staged chunk,
// col(j) = 4·tc + j (j < 4) or 128 + 4·tc + j − 4.
template <int BM, int LQ>
__device__ __forceinline__ void multiply_stage(const float* stage, int tr, int tc,
                                               float (&acc)[8][8]) {
  const float* Qs = stage;
  const float* Xs = stage + BM * BK;
  const int xkey = tc & 7;                       // ((4tc + j) >> 2) & 7, both halves
#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
    float4 x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = j < 4 ? tc * 4 + j : 128 + tc * 4 + (j - 4);
      x[j] = *reinterpret_cast<const float4*>(Xs + n * BK + ((u ^ xkey) << 2));
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(Qs + swizzled(tr * 8 + i, u));
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a.x, x[j].x, acc[i][j]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a.y, x[j].y, acc[i][j]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a.z, x[j].z, acc[i][j]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a.w, x[j].w, acc[i][j]);
    }
  }
}

// Begin a tile: start the copies of its first STAGES − 1 chunks. The ring
// must be free (tile_product ends with a barrier), so a caller that walks
// several tiles calls this for the next tile before its own epilogue, and the
// copies fly while it runs.
template <int BM, int LQ>
__device__ __forceinline__ void tile_prefetch(const float* __restrict__ Q,
                                              const float* __restrict__ X, int q0, int b,
                                              int64_t c0, int64_t row_limit, int f, bool vec,
                                              float* smem) {
  constexpr int STAGE = Tile<BM, LQ>::STAGE_FLOATS;
  const int nk = (f + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage<BM, LQ>(smem + s * STAGE, Q, X, q0, b, c0, row_limit, f, s * BK, vec, threadIdx.x);
    cp_async_commit();
  }
}

// acc = Q[q0 .. q0+BM) · X[c0 .. c0+256)ᵀ over all F, for the calling block
// (Tile<BM, LQ>::THREADS threads; `smem` holds Tile<BM, LQ>::SMEM_BYTES,
// 16-byte aligned), after tile_prefetch of the same tile. Ends with a
// barrier, so the ring may be refilled at once.
template <int BM, int LQ>
__device__ __forceinline__ void tile_product(const float* __restrict__ Q,
                                             const float* __restrict__ X, int q0, int b,
                                             int64_t c0, int64_t row_limit, int f, bool vec,
                                             float* smem, float (&acc)[8][8]) {
  constexpr int STAGE = Tile<BM, LQ>::STAGE_FLOATS;
  const int tid = threadIdx.x;
  const int tr = Tile<BM, LQ>::query_group(tid), tc = Tile<BM, LQ>::row_group(tid);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (f + BK - 1) / BK;
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();                 // chunk kc has landed (this thread's copies)
    __syncthreads();                             // ... everyone's; and chunk kc-1 is read out
    const int nxt = kc + STAGES - 1;
    if (nxt < nk)
      load_stage<BM, LQ>(smem + (nxt % STAGES) * STAGE, Q, X, q0, b, c0, row_limit, f, nxt * BK, vec, tid);
    cp_async_commit();
    multiply_stage<BM, LQ>(smem + (kc % STAGES) * STAGE, tr, tc, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace f32tile
