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
//   at 3.35 TB/s).
//
//   Design. A block owns a [BM × 256] output tile: BM queries by one
//   sub-tile of ts = tile/SUBS = 2048/8 = 256 corpus rows. Q and X are
//   staged through shared memory in BK-wide chunks of F (a classic
//   register-tiled SGEMM: each of 256 threads holds 8 queries × 8 rows of
//   accumulators, so every shared-memory value it reads feeds 8 FMAs).
//   The epilogue applies the cosine/blend/mask on the accumulators, stores
//   the scores with 16-byte writes, and reduces the tile's row maxima
//   within the thread and then across the warp (a warp's 32 lanes share
//   their 8 queries and together cover the 256 columns), so the scores
//   are never read back for the selection. Consecutive blocks are the
//   query blocks of one corpus tile, so the tile's second and later reads
//   come from L2. Exact f32 FFMA (no TF32); the epilogue uses rounded
//   multiplies and adds (no contraction) so it rounds as the plain
//   version does, leaving only the dot's summation order as a difference.
//
//   Limits: the sub-tile width is fixed at 256 corpus rows (tile 2048 with
//   SUBS = 8) and n0 must be a multiple of it; any B, any F.
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

namespace {

constexpr int BM = 64;        // queries per block
constexpr int BN = 256;       // corpus rows per block = one sub-tile
constexpr int BK = 16;        // F chunk staged per step
constexpr int THREADS = 256;  // 8 warps; warp w owns queries w*8 .. w*8+7
constexpr int PAD = 4;        // shared-memory row padding (bank spread)

__global__ void __launch_bounds__(THREADS)
scores_tilemax_kernel(const float* __restrict__ X, const float* __restrict__ norms,
                      const float* __restrict__ lams, const float* __restrict__ Q,
                      const float* __restrict__ qn, const float* __restrict__ ql,
                      const float* __restrict__ alpha, int64_t mask_from,
                      int64_t n0, int f, int b, int qblocks,
                      float* __restrict__ scores, float* __restrict__ submax) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int qb = blockIdx.x % qblocks;
  const int64_t tile = blockIdx.x / qblocks;
  const int q0 = qb * BM;
  const int64_t c0 = tile * BN;
  const int tid = threadIdx.x;
  const int tr = tid >> 5;          // query group: q0 + tr*8 + i
  const int tc = tid & 31;          // columns tc*4 + j and 128 + tc*4 + j

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < f; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int m = e / BK, kk = e - m * BK;
      const int gq = q0 + m, gk = k0 + kk;
      As[kk][m] = (gq < b && gk < f) ? Q[(int64_t)gq * f + gk] : 0.f;
    }
    for (int e = tid; e < BN * BK; e += THREADS) {
      const int nn = e / BK, kk = e - nn * BK;
      const int gk = k0 + kk;
      Bs[kk][nn] = gk < f ? X[(c0 + nn) * f + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][tr * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][tr * 8 + 4]);
      const float4 x0 = *reinterpret_cast<const float4*>(&Bs[kk][tc * 4]);
      const float4 x1 = *reinterpret_cast<const float4*>(&Bs[kk][128 + tc * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float nrm[8], lm[8];
  int64_t col[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    col[j] = c0 + (j < 4 ? tc * 4 + j : 128 + tc * 4 + (j - 4));
    nrm[j] = norms[col[j]];
    lm[j] = lams[col[j]];
  }
  const int64_t ns = n0 / BN;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int bq = q0 + tr * 8 + i;       // warp-uniform
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
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (valid) {
      float* row = scores + (int64_t)bq * n0 + c0;
      *reinterpret_cast<float4*>(row + tc * 4) = make_float4(s[0], s[1], s[2], s[3]);
      *reinterpret_cast<float4*>(row + 128 + tc * 4) = make_float4(s[4], s[5], s[6], s[7]);
      if (tc == 0) submax[(int64_t)bq * ns + tile] = m;
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

}  // namespace

extern "C" {

const char* mrs_cuda_strerror(int rc) { return cudaGetErrorString((cudaError_t)rc); }

// X [N, f] (only the first n0 rows are read), norms/lams [N], Q [b, f],
// qn/ql/alpha [b] → scores [b, n0], submax [b, n0/256]; float32, contiguous.
// n0 % 256 == 0. Returns cudaGetLastError() after the launch.
int mrs_scores_tilemax(const float* X, const float* norms, const float* lams,
                       const float* Q, const float* qn, const float* ql,
                       const float* alpha, int64_t mask_from, int64_t n0, int f,
                       int b, float* scores, float* submax, void* stream) {
  if (n0 % BN != 0) return (int)cudaErrorInvalidValue;
  const int qblocks = (b + BM - 1) / BM;
  const int64_t blocks = (n0 / BN) * qblocks;
  scores_tilemax_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      X, norms, lams, Q, qn, ql, alpha, mask_from, n0, f, b, qblocks, scores, submax);
  return (int)cudaGetLastError();
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
