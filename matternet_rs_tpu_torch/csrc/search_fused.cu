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
//   one contiguous range of N (grid = query blocks × splits, two blocks an
//   SM), streams its range in 256-row tiles through the full-f32 tile
//   product of csrc/f32_tile_product.cuh, shared with kernel B (128
//   threads, 8 queries × 16 rows of accumulators a thread, Q and X brought
//   32 features at a time by 16-byte cp.async into a 2-stage ring, exact
//   FFMA, no TF32), stages each tile's dots in the ring, and keeps each
//   query's running top-16 in shared memory: warp w owns queries
//   16w .. 16w + 15 and takes their rows of dots one query at a time, lane
//   l the columns l + 32m. A lane tests its 8 scores against the query's
//   threshold θ (the k-th entry); a passing score is inserted by one ballot
//   (its position = the number of entries that rank before it, lane e < 16
//   holding entry e) and one shuffle (entries behind it move down a lane).
//   Once the lists have warmed up almost nothing passes, so the selection
//   costs a compare per score. Each block writes its lists as a partial
//   [B, splits, 16]. The order is total, so the first k entries of a partial
//   and the merged answer depend neither on the number of splits nor on the
//   order in which candidates arrive. The blend uses rounded multiplies and
//   adds (no contraction), as the plain version rounds.
//
//   The energy scan (energy_scan_kernel) is the same scan with another
//   epilogue, instantiated apart so that the blended code stays as it is.
//   For raw rows X, their norms ‖X_j‖ and λ_j, raw queries Q, ‖Q_b‖ and
//   qλ_b, in the plain version's order (energymaps' full scan), each step
//   rounded and nothing contracted:
//
//     d = |qλ_b − λ_j|;   s = d + (1 − cos)·1e-9 where d < 1e-9, else s = d,
//     cos = (Q_b·X_j) / (‖Q_b‖·‖X_j‖ + 1e-9)
//
//   (the division counts only inside the tie band: csrc/div_rn.cuh's five FFMAs
//   for every pair, __fdiv_rn itself for a row of the warp where a band
//   pair's operands leave their range). The lists keep −s, so
//   the order above (largest first, lowest id on ties) is ascending s,
//   lowest id first: the plain version's stable ascending top-k. The
//   merge below takes the lists unchanged.
//
//   The merge (search_fused_merge_kernel) takes the partials — or any
//   [B, cand] lists, sorted or not — to each query's best k. What bounds it:
//   bytes, 8·B·cand read (4.3 MB at B = 256, cand = 2,112: 1.3 µs), below
//   the cost of one launch; so the aim is latency. One block per query: all
//   its candidates (up to 4,096 at a time, 32 KB) are brought into shared
//   memory by 16-byte cp.async copies, all in flight before any selection;
//   each warp then keeps a sorted list of 32 in registers (one entry per
//   lane) whose first k are the best k it has seen, and takes its batches
//   of 32 candidates: the few that beat its k-th (and, after the first
//   batches, the block's k-th so far) are inserted one by one (a ballot
//   and a shuffle each), a batch with more is sorted and merged by bitonic
//   networks over shuffles (21 steps, whatever the data); the eight lists
//   then merge pairwise through shared memory. The serial chain is a
//   warp's share of batches, each bounded, not the query's candidates one
//   by one. The selection is csrc/warp_topk.cuh, shared with the exact
//   tier's candidate stage (csrc/tilemax.cu).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "div_rn.cuh"
#include "f32_tile_product.cuh"
#include "warp_topk.cuh"

namespace {

constexpr int BM = f32tile::BM;                      // queries per block
constexpr int BN = f32tile::BN;                      // corpus rows per tile
constexpr int THREADS = f32tile::THREADS;            // 4 warps; warp w keeps the lists of queries 16w ..
constexpr int SMEM_BYTES = f32tile::SMEM_BYTES;
constexpr int QW = BM / (THREADS / 32);              // queries a warp keeps lists for
constexpr int KP = 16;        // list width (the reference's K_PAD)
constexpr float MASKED = -3.0e38f;
constexpr float PAD_LAMBDA_CUT = 1.5f;
constexpr float TIE_EPS = 1e-9f;     // energy: the cosine breaks ties below this |Δλ|
constexpr int EMPTY_ID = 0x7fffffff;

// The scan's epilogue: the list value of a (query, row) pair.
enum class Score { Blended, Energy };

// Does (s, id) rank before (v, vid) under (score descending, id ascending)?
__device__ __forceinline__ bool before(float s, int id, float v, int vid) {
  return s > v || (s == v && id < vid);
}

// Insert (s, id) into the sorted list lv/li in shared memory (lane l < KP
// reads and writes entry l). Warp-synchronous: every lane calls it with the
// same (s, id).
__device__ __forceinline__ void insert(float* lv, int* li, float s, int id, int lane) {
  const float v = lane < KP ? lv[lane] : -INFINITY;
  const int vi = lane < KP ? li[lane] : EMPTY_ID;
  const unsigned ahead = __ballot_sync(0xffffffffu, lane < KP && before(v, vi, s, id));
  const int pos = __popc(ahead);          // the list is sorted: a prefix is ahead
  const float uv = __shfl_up_sync(0xffffffffu, v, 1);
  const int ui = __shfl_up_sync(0xffffffffu, vi, 1);
  if (lane < KP) {
    if (lane == pos) { lv[lane] = s; li[lane] = id; }
    else if (lane > pos) { lv[lane] = uv; li[lane] = ui; }
  }
  __syncwarp();
}

// Blended: norms and qn are unused. Energy: alpha and beta are unused.
template <Score S>
__device__ __forceinline__ void scan(const float* __restrict__ X, const float* __restrict__ lams,
                                     const float* __restrict__ norms,
                                     const float* __restrict__ Q, const float* __restrict__ ql,
                                     const float* __restrict__ qn, float alpha, float beta,
                                     int64_t n, int f, int b, int k, int splits,
                                     int64_t tiles_per_split, int vec,
                                     float* __restrict__ pvals, int* __restrict__ pids) {
  extern __shared__ __align__(16) float ring[];
  __shared__ float list_v[BM][KP];
  __shared__ int list_i[BM][KP];

  const int split = blockIdx.x % splits;
  const int q0 = (blockIdx.x / splits) * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t ntiles = (n + BN - 1) / BN;
  const int64_t t_begin = (int64_t)split * tiles_per_split;
  const int64_t t_end = min(ntiles, t_begin + tiles_per_split);

  for (int e = tid; e < BM * KP; e += THREADS) {
    list_v[e / KP][e % KP] = -INFINITY;
    list_i[e / KP][e % KP] = EMPTY_ID;
  }
  __syncthreads();
  // Lane j < QW holds query warp·QW + j's λ (and norm); the loop takes them by shuffle.
  const int qj = q0 + warp * QW + lane % QW;
  const float ql_l = qj < b ? ql[qj] : 0.f;
  float qn_l = 0.f;
  if constexpr (S == Score::Energy) qn_l = qj < b ? qn[qj] : 0.f;

  if (t_begin < t_end) f32tile::tile_prefetch(Q, X, q0, b, t_begin * BN, n, f, vec != 0, ring);
  for (int64_t tile = t_begin; tile < t_end; ++tile) {
    const int64_t c0 = tile * BN;
    float acc[f32tile::TQ][f32tile::TR];
    f32tile::tile_product(Q, X, q0, b, c0, n, f, vec != 0, ring, acc);
    f32tile::store_dots(ring, acc);

    float lm[8];                                 // λ of this lane's columns lane + 32m
    float nm[8];                                 // energy: their norms
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int64_t col = c0 + lane + 32 * m;
      lm[m] = col < n ? lams[col] : 0.f;
      if constexpr (S == Score::Energy) nm[m] = col < n ? norms[col] : 0.f;
    }
#pragma unroll 1
    for (int qq = 0; qq < QW; ++qq) {            // query warp·QW + qq: a whole row of dots
      const int q = warp * QW + qq;
      if (q0 + q >= b) break;
      float* lvq = list_v[q];
      int* liq = list_i[q];
      float th = lvq[k - 1];
      int thid = liq[k - 1];
      const float qlb = __shfl_sync(0xffffffffu, ql_l, qq);
      float sc[8];
      if constexpr (S == Score::Blended) {
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float lsim = __fsub_rn(1.f, fminf(fabsf(__fsub_rn(lm[m], qlb)), 1.f));
          sc[m] = __fadd_rn(__fmul_rn(alpha, ring[q * BN + lane + 32 * m]), __fmul_rn(beta, lsim));
          if (lm[m] > PAD_LAMBDA_CUT) sc[m] = MASKED;
        }
      } else {
        const float qnb = __shfl_sync(0xffffffffu, qn_l, qq);
        float dv[8], den[8], cosv[8];
        bool slow = false;
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          dv[m] = ring[q * BN + lane + 32 * m];
          den[m] = __fadd_rn(__fmul_rn(qnb, nm[m]), TIE_EPS);
          cosv[m] = divrn::div_fast(dv[m], den[m]);
          slow |= fabsf(__fsub_rn(qlb, lm[m])) < TIE_EPS && !divrn::div_in_range(dv[m], den[m]);
        }
        if (__any_sync(0xffffffffu, slow)) {     // a band pair out of div_fast's range: exactly
#pragma unroll
          for (int m = 0; m < 8; ++m)
            if (fabsf(__fsub_rn(qlb, lm[m])) < TIE_EPS) cosv[m] = __fdiv_rn(dv[m], den[m]);
        }
#pragma unroll
        for (int m = 0; m < 8; ++m) {          // the cosine counts inside the tie band only
          const float d = fabsf(__fsub_rn(qlb, lm[m]));
          sc[m] = d < TIE_EPS ? -__fadd_rn(d, __fmul_rn(__fsub_rn(1.f, cosv[m]), TIE_EPS)) : -d;
        }
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int64_t col = c0 + lane + 32 * m;
        const int id = (int)col;
        unsigned pass = __ballot_sync(0xffffffffu, col < n && before(sc[m], id, th, thid));
        while (pass) {
          const int src = __ffs(pass) - 1;
          pass &= pass - 1;
          const float cs = __shfl_sync(0xffffffffu, sc[m], src);
          const int cid = __shfl_sync(0xffffffffu, id, src);
          if (before(cs, cid, th, thid)) {      // θ may have risen since the ballot
            insert(lvq, liq, cs, cid, lane);
            th = lvq[k - 1];
            thid = liq[k - 1];
          }
        }
      }
    }
    __syncthreads();                             // the dot tile is read out: the ring is free
    if (tile + 1 < t_end) f32tile::tile_prefetch(Q, X, q0, b, c0 + BN, n, f, vec != 0, ring);
  }

  if (lane < KP) {
#pragma unroll 1
    for (int qq = 0; qq < QW; ++qq) {
      const int q = warp * QW + qq;
      if (q0 + q >= b) break;
      const int64_t o = ((int64_t)(q0 + q) * splits + split) * KP + lane;
      pvals[o] = list_v[q][lane];
      pids[o] = list_i[q][lane];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
search_fused_scan_kernel(const float* __restrict__ X, const float* __restrict__ lams,
                         const float* __restrict__ Q, const float* __restrict__ ql,
                         float alpha, float beta, int64_t n, int f, int b, int k,
                         int splits, int64_t tiles_per_split, int vec,
                         float* __restrict__ pvals, int* __restrict__ pids) {
  scan<Score::Blended>(X, lams, nullptr, Q, ql, nullptr, alpha, beta, n, f, b, k, splits,
                       tiles_per_split, vec, pvals, pids);
}

__global__ void __launch_bounds__(THREADS, 2)
energy_scan_kernel(const float* __restrict__ X, const float* __restrict__ norms,
                   const float* __restrict__ lams, const float* __restrict__ Q,
                   const float* __restrict__ qn, const float* __restrict__ ql, int64_t n, int f,
                   int b, int k, int splits, int64_t tiles_per_split, int vec,
                   float* __restrict__ pvals, int* __restrict__ pids) {
  scan<Score::Energy>(X, lams, norms, Q, ql, qn, 0.f, 0.f, n, f, b, k, splits, tiles_per_split,
                      vec, pvals, pids);
}

// The merge. One block per query; its 8 warps share the query's candidates,
// ranked by csrc/warp_topk.cuh: a 64-bit key that orders as before() does
// (−0.0 as +0.0, every NaN above +inf), equal keys by position, so the
// result is the plain version's bit for bit (read back by position).
using warptopk::Cand;
using warptopk::nothing;

constexpr int MERGE_THREADS = 32 * warptopk::WARPS;  // 8 warps, one query per block
constexpr int MERGE_CHUNK = 4096;                    // candidates staged at a time

__global__ void __launch_bounds__(MERGE_THREADS)
search_fused_merge_kernel(const float* __restrict__ pvals, const int* __restrict__ pids,
                          int cand, int k, int vec, float* __restrict__ vals,
                          int* __restrict__ ids) {
  __shared__ __align__(16) float sv[MERGE_CHUNK];
  __shared__ __align__(16) int si[MERGE_CHUNK];
  __shared__ Cand lists[warptopk::WARPS][KP];
  const int64_t bq = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* pv = pvals + bq * cand;
  const int* pi = pids + bq * cand;
  Cand list = nothing();                             // the warp's best 32 so far, best in lane 0
  Cand floor = nothing();                            // the block's k-th so far, or nothing

  for (int c0 = 0; c0 < cand; c0 += MERGE_CHUNK) {
    const int len = min(MERGE_CHUNK, cand - c0);
    // Every load of the chunk is in flight before any selection begins.
    if (vec) {
      for (int u = tid; u < len / 4; u += MERGE_THREADS) {
        f32tile::cp_async16(sv + 4 * u, pv + c0 + 4 * u, true);
        f32tile::cp_async16(reinterpret_cast<float*>(si) + 4 * u,
                            reinterpret_cast<const float*>(pi) + c0 + 4 * u, true);
      }
      f32tile::cp_async_commit();
      f32tile::cp_async_wait<0>();
    } else {
      for (int e = tid; e < len; e += MERGE_THREADS) {
        sv[e] = pv[c0 + e];
        si[e] = pi[c0 + e];
      }
    }
    __syncthreads();
    // After the first round of batches the block's k-th so far becomes
    // every warp's floor.
    warptopk::take_staged(list, floor, lists, c0 == 0 && cand > MERGE_THREADS, len, k, warp, lane,
                          [&](int e) { return Cand{warptopk::order_key(sv[e], si[e]), (uint32_t)(c0 + e)}; });
    __syncthreads();
  }

  warptopk::tree_merge(list, lists, k, warp, lane);
  if (warp == 0 && lane < k) {
    vals[bq * k + lane] = pv[list.pos];
    ids[bq * k + lane] = pi[list.pos];
  }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

const char* mrs_cuda_strerror(int rc) { return cudaGetErrorString((cudaError_t)rc); }

// The plan of either scan (blended or energy): 16-byte copies when f is a
// multiple of 4 and X and Q are 16-byte aligned (the element-wise loader
// otherwise), tiles per range, blocks. Returns cudaErrorInvalidValue for
// what the scans refuse.
int mrs_search_fused_scan_plan(const float* X, const float* Q, int64_t n, int f, int b, int k,
                               int splits, int* vec, int64_t* tiles_per_split,
                               int64_t* blocks) {
  if (n <= 0 || n > 0x7fffffffLL || f <= 0 || b <= 0 || k < 1 || k > KP || splits < 1)
    return (int)cudaErrorInvalidValue;
  *vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(Q) % 16 == 0;
  *tiles_per_split = ((n + BN - 1) / BN + splits - 1) / splits;
  *blocks = (int64_t)((b + BM - 1) / BM) * splits;
  return 0;
}

// X [n, f], lams [n], Q [b, f], ql [b] float32 contiguous; 1 ≤ k ≤ 16;
// n < 2^31. Launched as mrs_search_fused_scan_plan says. Writes each
// block's lists to pvals/pids [b, splits, 16]
// (unfilled entries: −inf, id 2^31−1). Returns cudaGetLastError().
int mrs_search_fused_scan(const float* X, const float* lams, const float* Q,
                          const float* ql, float alpha, float beta, int64_t n, int f,
                          int b, int k, int splits, float* pvals, int* pids,
                          void* stream) {
  int vec;
  int64_t tiles_per_split, blocks;
  const int bad =
      mrs_search_fused_scan_plan(X, Q, n, f, b, k, splits, &vec, &tiles_per_split, &blocks);
  if (bad) return bad;
  cudaError_t rc = cudaFuncSetAttribute(search_fused_scan_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  search_fused_scan_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      X, lams, Q, ql, alpha, beta, n, f, b, k, splits, tiles_per_split, vec, pvals, pids);
  return (int)cudaGetLastError();
}

// X [n, f], norms [n], lams [n], Q [b, f], qn [b], ql [b] float32
// contiguous; 1 ≤ k ≤ 16; n < 2^31. Writes each block's lists of −s to
// pvals/pids [b, splits, 16] (unfilled entries: −inf, id 2^31−1), planned
// and laid out as mrs_search_fused_scan's. Returns cudaGetLastError().
int mrs_energy_scan(const float* X, const float* norms, const float* lams, const float* Q,
                    const float* qn, const float* ql, int64_t n, int f, int b, int k, int splits,
                    float* pvals, int* pids, void* stream) {
  int vec;
  int64_t tiles_per_split, blocks;
  const int bad =
      mrs_search_fused_scan_plan(X, Q, n, f, b, k, splits, &vec, &tiles_per_split, &blocks);
  if (bad) return bad;
  cudaError_t rc = cudaFuncSetAttribute(energy_scan_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  energy_scan_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      X, norms, lams, Q, qn, ql, n, f, b, k, splits, tiles_per_split, vec, pvals, pids);
  return (int)cudaGetLastError();
}

// pvals/pids [b, cand] (any order) → vals/ids [b, k]: per query the best
// k under (score descending, id ascending; equal pairs by position), k ≤
// cand. 16-byte loads when cand % 4 == 0 and both arrays are 16-byte
// aligned. Returns cudaGetLastError().
int mrs_search_fused_merge(const float* pvals, const int* pids, int b, int cand, int k,
                           float* vals, int* ids, void* stream) {
  if (b <= 0 || cand <= 0 || k < 1 || k > KP || k > cand) return (int)cudaErrorInvalidValue;
  const int vec = cand % 4 == 0 && reinterpret_cast<uintptr_t>(pvals) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(pids) % 16 == 0;
  search_fused_merge_kernel<<<b, MERGE_THREADS, 0, (cudaStream_t)stream>>>(pvals, pids, cand, k,
                                                                           vec, vals, ids);
  return (int)cudaGetLastError();
}

// An empty kernel, launched as the merge is: what one launch costs.
int mrs_search_fused_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
