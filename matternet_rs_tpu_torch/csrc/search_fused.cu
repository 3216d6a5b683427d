// Kernel G: streamed exact blended top-k — the [B, N] score matrix is
// never written.
//
// Replaces the TPU kernel matternet_rs_tpu/ops/pallas/search_fused.py
// `search_fused_pallas` (_make_kernel). For row-normalised Xn [N, F] and
// Qn [B, F] and normalised λ:
//
//   score[b, j] = α·(Qn[b]·Xn[j]) + β·(1 − min(|λ_j − qλ_b|, 1)),  β = 1 − α
//   (−3e38 where λ_j > 1.5, the reference's padded-row sentinel),
//
// and per query the best k ≤ 16 under the total order (score descending,
// id ascending).
//
//   What bounds it on the H100: operations. 2·B·N·F f32 FFMA (65.5 GFLOP,
//   0.98 ms at 67 TFLOP/s for B = 256, N = 1M, F = 128) against
//   (N·F + B·F)·4 bytes read (0.15 ms at 3.35 TB/s); the output is B·16
//   pairs.
//
//   Design. The TPU kernel walks one sequential grid over N and carries one
//   running top-16 per query in VMEM, merging a tile whenever any query of
//   the batch beats its threshold. Blocks on this card run in any order and
//   carry nothing, so the work is cut twice: a block owns 64 queries and
//   one contiguous range of N (grid = query blocks × splits), streams its
//   range in 256-row tiles through the full-f32 tile product of
//   csrc/f32_tile_product.cuh, shared with kernel B (8 queries × 8 rows of
//   accumulators per thread, Q and X brought 32 features at a time by
//   16-byte cp.async into a 3-stage ring, exact FFMA, no TF32), and keeps
//   each query's running top-16 in registers: warp w owns
//   queries 8w..8w+7 — the same queries whose accumulators its lanes hold —
//   and lane l < 16 holds entry l of each list. After a tile's product a
//   lane tests its 64 scores against its queries' own thresholds θ_b (the
//   k-th entry, broadcast by shuffle); a passing score is inserted by one
//   ballot (its position = the number of entries that rank before it) and
//   one shuffle (entries behind it move down a lane). Once the lists have
//   warmed up almost nothing passes, so the selection costs a compare per
//   score. Each block writes its lists as a partial [B, splits, 16]; a
//   second kernel (one warp per query) merges the partials with the same
//   insertion. The order is total, so the answer does not depend on the
//   number of splits nor on the order in which candidates arrive. The blend
//   uses rounded multiplies and adds (no contraction), as the plain version
//   rounds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "f32_tile_product.cuh"

namespace {

constexpr int BM = 64;                               // queries per block
constexpr int BN = f32tile::BN;                      // corpus rows per tile
constexpr int THREADS = f32tile::Tile<BM, 1>::THREADS;  // 8 warps; warp w owns queries w*8 .. w*8+7
constexpr int SMEM_BYTES = f32tile::Tile<BM, 1>::SMEM_BYTES;
constexpr int KP = 16;        // list width (the reference's K_PAD)
constexpr float MASKED = -3.0e38f;
constexpr float PAD_LAMBDA_CUT = 1.5f;
constexpr int EMPTY_ID = 0x7fffffff;

// Does (s, id) rank before (v, vid) under (score descending, id ascending)?
__device__ __forceinline__ bool before(float s, int id, float v, int vid) {
  return s > v || (s == v && id < vid);
}

// Insert (s, id) into the warp's sorted list (lane l < KP holds entry l).
// Warp-synchronous: every lane calls it with the same (s, id).
__device__ __forceinline__ void insert(float& lv, int& li, float s, int id, int lane) {
  const unsigned ahead = __ballot_sync(0xffffffffu, lane < KP && before(lv, li, s, id));
  const int pos = __popc(ahead);          // the list is sorted: a prefix is ahead
  const float uv = __shfl_up_sync(0xffffffffu, lv, 1);
  const int ui = __shfl_up_sync(0xffffffffu, li, 1);
  if (lane == pos) { lv = s; li = id; }
  else if (lane > pos) { lv = uv; li = ui; }
}

__global__ void __launch_bounds__(THREADS)
search_fused_scan_kernel(const float* __restrict__ X, const float* __restrict__ lams,
                         const float* __restrict__ Q, const float* __restrict__ ql,
                         float alpha, float beta, int64_t n, int f, int b, int k,
                         int splits, int64_t tiles_per_split, int vec,
                         float* __restrict__ pvals, int* __restrict__ pids) {
  extern __shared__ __align__(16) float ring[];

  const int split = blockIdx.x % splits;
  const int q0 = (blockIdx.x / splits) * BM;
  const int tid = threadIdx.x;
  const int tr = tid >> 5;          // query group: q0 + tr*8 + i
  const int tc = tid & 31;          // lane; columns tc*4 + j and 128 + tc*4 + j
  const int64_t ntiles = (n + BN - 1) / BN;
  const int64_t t_begin = (int64_t)split * tiles_per_split;
  const int64_t t_end = min(ntiles, t_begin + tiles_per_split);

  float lv[8];                      // entry `lane` of the list of query i
  int li[8];
  float qlb[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    lv[i] = -INFINITY;
    li[i] = EMPTY_ID;
    const int bq = q0 + tr * 8 + i;
    qlb[i] = bq < b ? ql[bq] : 0.f;
  }

  if (t_begin < t_end)
    f32tile::tile_prefetch<BM, 1>(Q, X, q0, b, t_begin * BN, n, f, vec != 0, ring);
  for (int64_t tile = t_begin; tile < t_end; ++tile) {
    const int64_t c0 = tile * BN;
    float acc[8][8];
    f32tile::tile_product<BM, 1>(Q, X, q0, b, c0, n, f, vec != 0, ring, acc);
    if (tile + 1 < t_end)                       // its first chunks fly during the selection
      f32tile::tile_prefetch<BM, 1>(Q, X, q0, b, c0 + BN, n, f, vec != 0, ring);

    float lm[8];                              // λ of this lane's 8 columns
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t col = c0 + (j < 4 ? tc * 4 + j : 128 + tc * 4 + (j - 4));
      lm[j] = col < n ? lams[col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {             // query q0 + tr*8 + i, warp-uniform
      float th = __shfl_sync(0xffffffffu, lv[i], k - 1);
      int thid = __shfl_sync(0xffffffffu, li[i], k - 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t col = c0 + (j < 4 ? tc * 4 + j : 128 + tc * 4 + (j - 4));
        const float lsim = __fsub_rn(1.f, fminf(fabsf(__fsub_rn(lm[j], qlb[i])), 1.f));
        float s = __fadd_rn(__fmul_rn(alpha, acc[i][j]), __fmul_rn(beta, lsim));
        if (lm[j] > PAD_LAMBDA_CUT) s = MASKED;
        const int id = (int)col;
        unsigned pass = __ballot_sync(0xffffffffu, col < n && before(s, id, th, thid));
        while (pass) {
          const int src = __ffs(pass) - 1;
          pass &= pass - 1;
          const float cs = __shfl_sync(0xffffffffu, s, src);
          const int cid = __shfl_sync(0xffffffffu, id, src);
          if (before(cs, cid, th, thid)) {      // θ may have risen since the ballot
            insert(lv[i], li[i], cs, cid, tc);
            th = __shfl_sync(0xffffffffu, lv[i], k - 1);
            thid = __shfl_sync(0xffffffffu, li[i], k - 1);
          }
        }
      }
    }
  }

  if (tc < KP) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int bq = q0 + tr * 8 + i;
      if (bq < b) {
        const int64_t o = ((int64_t)bq * splits + split) * KP + tc;
        pvals[o] = lv[i];
        pids[o] = li[i];
      }
    }
  }
}

// One warp per query: merge `cand` (value, id) pairs into the best k.
__global__ void __launch_bounds__(THREADS)
search_fused_merge_kernel(const float* __restrict__ pvals, const int* __restrict__ pids,
                          int b, int cand, int k, float* __restrict__ vals,
                          int* __restrict__ ids) {
  const int bq = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (bq >= b) return;                         // warp-uniform
  const int lane = threadIdx.x & 31;
  float lv = -INFINITY;
  int li = EMPTY_ID;
  float th = -INFINITY;
  int thid = EMPTY_ID;
  const float* pv = pvals + (int64_t)bq * cand;
  const int* pi = pids + (int64_t)bq * cand;
  for (int c0 = 0; c0 < cand; c0 += 32) {
    const int c = c0 + lane;
    const float s = c < cand ? pv[c] : -INFINITY;
    const int id = c < cand ? pi[c] : EMPTY_ID;
    unsigned pass = __ballot_sync(0xffffffffu, c < cand && before(s, id, th, thid));
    while (pass) {
      const int src = __ffs(pass) - 1;
      pass &= pass - 1;
      const float cs = __shfl_sync(0xffffffffu, s, src);
      const int cid = __shfl_sync(0xffffffffu, id, src);
      if (before(cs, cid, th, thid)) {
        insert(lv, li, cs, cid, lane);
        th = __shfl_sync(0xffffffffu, lv, k - 1);
        thid = __shfl_sync(0xffffffffu, li, k - 1);
      }
    }
  }
  if (lane < k) {
    vals[(int64_t)bq * k + lane] = lv;
    ids[(int64_t)bq * k + lane] = li;
  }
}

}  // namespace

extern "C" {

const char* mrs_cuda_strerror(int rc) { return cudaGetErrorString((cudaError_t)rc); }

// X [n, f], lams [n], Q [b, f], ql [b] float32 contiguous; 1 ≤ k ≤ 16;
// n < 2^31. 16-byte copies when f is a multiple of 4 and X and Q are
// 16-byte aligned, the element-wise loader otherwise. Writes each block's
// lists to pvals/pids [b, splits, 16]
// (unfilled entries: −inf, id 2^31−1). Returns cudaGetLastError().
int mrs_search_fused_scan(const float* X, const float* lams, const float* Q,
                          const float* ql, float alpha, float beta, int64_t n, int f,
                          int b, int k, int splits, float* pvals, int* pids,
                          void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || f <= 0 || b <= 0 || k < 1 || k > KP || splits < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t ntiles = (n + BN - 1) / BN;
  const int64_t tiles_per_split = (ntiles + splits - 1) / splits;
  const int64_t blocks = (int64_t)((b + BM - 1) / BM) * splits;
  const int vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(Q) % 16 == 0;
  cudaError_t rc = cudaFuncSetAttribute(search_fused_scan_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  search_fused_scan_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      X, lams, Q, ql, alpha, beta, n, f, b, k, splits, tiles_per_split, vec, pvals, pids);
  return (int)cudaGetLastError();
}

// pvals/pids [b, cand] → vals/ids [b, k]: per query the best k under
// (score descending, id ascending). Returns cudaGetLastError().
int mrs_search_fused_merge(const float* pvals, const int* pids, int b, int cand, int k,
                           float* vals, int* ids, void* stream) {
  if (b <= 0 || cand <= 0 || k < 1 || k > KP) return (int)cudaErrorInvalidValue;
  const int blocks = (b + (THREADS / 32) - 1) / (THREADS / 32);
  search_fused_merge_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      pvals, pids, b, cand, k, vals, ids);
  return (int)cudaGetLastError();
}

}  // extern "C"
