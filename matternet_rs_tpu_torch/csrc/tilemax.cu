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
//   at 3.35 TB/s). The yardstick is cuBLAS's time for the product alone.
//
//   Design. A block of 256 threads owns a [64 × 256] output tile at a
//   time: 64 queries by one sub-tile of ts = tile/SUBS = 2048/8 = 256
//   corpus rows. The grid is persistent (one block per SM); a block walks
//   items blockIdx.x, + grid, ..., an item being (corpus tile, query block)
//   with the query block fastest, so the query blocks of one corpus tile run
//   side by side and its second and later reads come from L2. The product
//   is csrc/f32_tile_product.cuh, shared with kernel G's scan: 32-feature
//   chunks of Q and X arrive by 16-byte cp.async in a 3-stage ring of
//   dynamic shared memory (120 KB, one barrier per chunk), stay
//   untransposed under an XOR swizzle that makes both the copies and the
//   float4 reads conflict-free, and each thread multiplies along K into
//   8 queries × 8 rows of accumulators (exact FFMA, ascending k); the next
//   item's first chunks are started before the epilogue and fly while it
//   runs. A wider block (128 queries, 512 threads at 128 registers, or 16
//   queries a thread) halves the corpus re-read but measured slower: the
//   inner loop is bound by shared-memory reads per FMA, not by L2. The
//   epilogue applies the cosine/blend/mask on the accumulators, stores the
//   scores with 16-byte writes, and reduces the sub-tile's maxima within
//   the thread, across the 8 lanes that share a query (shuffles), and
//   across the 4 warps along the rows through shared memory — one maximum
//   per query and 256 rows, no atomic, so the scores are never read back
//   for the selection. The epilogue uses rounded multiplies and adds (no
//   contraction) so it rounds as the plain version does, leaving only the
//   dot's summation order as a difference.
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
//   for Mosaic's alignment rules and do not carry over; any B works.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "f32_tile_product.cuh"

namespace {

constexpr int BM = 64;                               // queries per block
constexpr int LQ = 4;                                // a warp's lanes: 4 query groups × 8 row groups
using Tile = f32tile::Tile<BM, LQ>;
constexpr int BN = f32tile::BN;                      // corpus rows per block = one sub-tile
constexpr int THREADS = Tile::THREADS;               // 8 warps: 2 along the queries × 4 along the rows
constexpr int SMEM_BYTES = Tile::SMEM_BYTES;

__global__ void __launch_bounds__(THREADS, 1)
scores_tilemax_kernel(const float* __restrict__ X, const float* __restrict__ norms,
                      const float* __restrict__ lams, const float* __restrict__ Q,
                      const float* __restrict__ qn, const float* __restrict__ ql,
                      const float* __restrict__ alpha, int64_t mask_from,
                      int64_t n0, int f, int b, int qblocks, int vec,
                      float* __restrict__ scores, float* __restrict__ submax) {
  extern __shared__ __align__(16) float ring[];
  __shared__ float part[Tile::WR][BM];  // the sub-tile maxima of the warps along the rows

  const int tid = threadIdx.x;
  const int tr = Tile::query_group(tid);  // queries q0 + tr*8 + i
  const int tc = Tile::row_group(tid);    // columns tc*4 + j and 128 + tc*4 + j
  const int wr = (tid >> 5) % Tile::WR;   // this warp's place along the rows
  const int64_t ns = n0 / BN;
  const int64_t items = ns * qblocks;     // item = (corpus tile, query block), query block fastest

  int64_t item = blockIdx.x;
  if (item < items)
    f32tile::tile_prefetch<BM, LQ>(Q, X, (int)(item % qblocks) * BM, b, (item / qblocks) * BN, n0,
                                   f, vec != 0, ring);
  for (; item < items; item += gridDim.x) {
    const int q0 = (int)(item % qblocks) * BM;
    const int64_t tile = item / qblocks;
    const int64_t c0 = tile * BN;

    float acc[8][8];
    f32tile::tile_product<BM, LQ>(Q, X, q0, b, c0, n0, f, vec != 0, ring, acc);
    const int64_t next = item + gridDim.x;  // its first chunks fly during the epilogue
    if (next < items)
      f32tile::tile_prefetch<BM, LQ>(Q, X, (int)(next % qblocks) * BM, b, (next / qblocks) * BN,
                                     n0, f, vec != 0, ring);

    float nrm[8], lm[8];
    int64_t col[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      col[j] = c0 + (j < 4 ? tc * 4 + j : 128 + tc * 4 + (j - 4));
      nrm[j] = norms[col[j]];
      lm[j] = lams[col[j]];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int bq = q0 + tr * 8 + i;
      const bool valid = bq < b;
      const float qnb = valid ? qn[bq] : 0.f;
      const float qlb = valid ? ql[bq] : 0.f;
      const float ab = valid ? alpha[bq] : 0.f;
      float s[8];
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float denom = __fmul_rn(qnb, nrm[j]);
        const float cosv = denom > 1e-12f ? __fdiv_rn(acc[i][j], fmaxf(denom, 1e-12f)) : 0.f;
        const float lsim = __fsub_rn(1.f, fminf(fabsf(__fsub_rn(lm[j], qlb)), 1.f));
        float v = __fadd_rn(__fmul_rn(ab, cosv), __fmul_rn(__fsub_rn(1.f, ab), lsim));
        if (col[j] >= mask_from) v = -INFINITY;
        s[j] = v;
        m = fmaxf(m, v);
      }
      // The 8 lanes along the rows share this query: their 64 columns' maximum.
#pragma unroll
      for (int o = Tile::LR / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if ((tid & 31) % Tile::LR == 0) part[wr][tr * 8 + i] = m;
      if (valid) {
        float* row = scores + (int64_t)bq * n0 + c0;
        *reinterpret_cast<float4*>(row + tc * 4) = make_float4(s[0], s[1], s[2], s[3]);
        *reinterpret_cast<float4*>(row + 128 + tc * 4) = make_float4(s[4], s[5], s[6], s[7]);
      }
    }
    __syncthreads();
    // One maximum per query and 256 rows, across the warps through shared
    // memory (`part` is next written behind the next tile's barriers).
    if (tid < BM && q0 + tid < b) {
      float m = part[0][tid];
#pragma unroll
      for (int r = 1; r < Tile::WR; ++r) m = fmaxf(m, part[r][tid]);
      submax[(int64_t)(q0 + tid) * ns + tile] = m;
    }
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
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return (int)rc;
  if (blocks > sms) blocks = sms;               // persistent: a block walks items blockIdx.x, +grid, ...
  const int vec = vec_copies(X, Q, f);
  rc = cudaFuncSetAttribute(scores_tilemax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
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

}  // extern "C"
