// Kernels D and E of the rescored (maxima-first) search tiers.
//
// Kernel D (tilemax_only_kernel) replaces the TPU kernel
// matternet_rs_tpu/ops/pallas/tilemax_fused.py `tilemax_only`
// (_make_kernel_tilemax_only, _scan_dots_kernel): per-sub-tile maxima of
// the cheap blended score
//     s = (dots·rn)·aqrn + (β − β·min(|λ − λq|, 1)),   aqrn = α/qn, β = 1 − α,
// for a query batch against the first n0 corpus rows, with NO [B, n0]
// score write. The scan precision follows the corpus type, as on the TPU:
//   bf16 rows → one bf16 pass, the query rounded to bf16;
//   int8 rows → one bf16 pass over a lossless upcast (integers in
//               [-127, 127] are exact in bf16), the query rounded to bf16,
//               the per-row dequant multiplier riding in `rn`;
//   f32 rows  → bf16x3: qhi·xhi + qhi·xlo + qlo·xhi with hi = bf16(v),
//               lo = bf16(v − hi) for both operands (lo·lo dropped).
// Every product is a bf16 × bf16 product accumulated in f32 — the TPU's
// own arithmetic (`preferred_element_type=f32`), here on Hopper's tensor
// cores through mma.sync m16n8k16.
//
//   What bounds it on the H100: at B = 256, n0 = 999,424, F = 128 it does
//   2·B·n0·F = 65.5 GFLOP per bf16 pass (0.066 ms at 989 TFLOP/s; three
//   passes for bf16x3, 0.199 ms) against the corpus read once (256 MB
//   bf16: 0.076 ms at 3.35 TB/s; 128 MB int8; 512 MB f32). So bf16 rows
//   are bound by bytes, int8 and f32 rows by operations.
//
//   Design. A block owns BM = 64 queries × one sub-tile of ts rows (ts a
//   multiple of BN = 128), walked in 128-row chunks. Each chunk stages
//   BK = 32 features at a time of the corpus rows and the queries into
//   shared memory as bf16 (the int8 upcast and the f32 hi/lo split happen
//   while staging), then each of the 4 warps runs mma.sync on its 32
//   corpus rows × 64 queries (4 × 4 m16n8 tiles, 64 f32 accumulators a
//   thread). The epilogue applies the blend on the accumulators with
//   rounded multiplies and adds (no contraction, as the plain version
//   rounds), masks rows ≥ mask_from to −inf, and keeps a running maximum
//   per query; a shuffle over the 4 lanes that share a query row and a
//   pass through shared memory over the 4 warps end the sub-tile, and 64
//   maxima are written. Consecutive blocks are the query blocks of one
//   sub-tile, so its second and later reads come from L2. The TPU's
//   transposed (ns, B) output was a Mosaic layout rule; this writes
//   [B, ns] directly. Any B, any F (zero-filled past the edges).
//
// Kernel E (slab_dots_kernel) replaces the TPU kernel tilemax_fused.py
// `slab_dots_ring`: dots of each query against every row of its c
// selected ts-row slabs → [B, c, ts]. f32 rows at full f32 (FFMA); int8
// rows upcast exactly, with the query rounded to bf16 by the caller.
//
//   What bounds it: bytes (the distinct selected slabs read once; at most
//   B·c·ts·F·4 = 235 MB at B = 256, c = 14, ts = 128, F = 128: 0.070 ms).
//   Design. The TPU hid HBM latency with an 8-deep DMA ring; here many
//   blocks in flight hide it. One block per (query, selected slab): the
//   query sits in shared memory, each warp takes one slab row at a time,
//   its lanes read the row with 16-byte loads (4-byte for int8 rows),
//   multiply in f32 and sum with a shuffle tree. An out-of-range slab id
//   yields a NaN slice (the wrapper refuses such ids before the launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // queries per block
constexpr int BN = 128;         // corpus rows per chunk (4 warps × 32)
constexpr int BK = 32;          // features staged per step
constexpr int THREADS = 128;    // 4 warps
constexpr int LD = BK + 8;      // shared row pitch in bf16 (80 B: conflict-free fragments)

enum { SCAN_BF16 = 0, SCAN_INT8 = 1, SCAN_F32 = 2 };

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One corpus element as bf16 hi (and lo for f32 rows); 0 past the edge.
template <int MODE>
__device__ __forceinline__ void stage_x(const void* X, int64_t i, bool ok, __nv_bfloat16& hi,
                                        __nv_bfloat16& lo) {
  if constexpr (MODE == SCAN_BF16) {
    hi = ok ? reinterpret_cast<const __nv_bfloat16*>(X)[i] : __float2bfloat16_rn(0.f);
  } else if constexpr (MODE == SCAN_INT8) {
    hi = __float2bfloat16_rn(ok ? (float)reinterpret_cast<const int8_t*>(X)[i] : 0.f);
  } else {
    const float v = ok ? reinterpret_cast<const float*>(X)[i] : 0.f;
    hi = __float2bfloat16_rn(v);
    lo = __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(hi)));
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
tilemax_only_kernel(const void* __restrict__ X, const float* __restrict__ rn,
                    const float* __restrict__ lams, const __nv_bfloat16* __restrict__ qhi,
                    const __nv_bfloat16* __restrict__ qlo, const float* __restrict__ aqrn,
                    const float* __restrict__ beta, const float* __restrict__ ql,
                    int64_t mask_from, int f, int b, int ts, int64_t ns, int qblocks,
                    float* __restrict__ out) {
  constexpr bool SPLIT = MODE == SCAN_F32;
  __shared__ __align__(16) __nv_bfloat16 Xh[BN][LD];
  __shared__ __align__(16) __nv_bfloat16 Xl[SPLIT ? BN : 1][LD];
  __shared__ __align__(16) __nv_bfloat16 Qh[BM][LD];
  __shared__ __align__(16) __nv_bfloat16 Ql[SPLIT ? BM : 1][LD];
  __shared__ float red[THREADS / 32][BM];

  const int qb = blockIdx.x % qblocks;
  const int64_t sub = blockIdx.x / qblocks;
  const int q0 = qb * BM;
  const int tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;     // mma fragment group / thread-in-group

  // This thread's 8 query rows: mi*16 + g + 8*h, h = 0, 1.
  float aq[4][2], be[4][2], qlb[4][2], run[4][2];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + mi * 16 + g + 8 * h;
      const bool v = q < b;
      aq[mi][h] = v ? aqrn[q] : 0.f;
      be[mi][h] = v ? beta[q] : 0.f;
      qlb[mi][h] = v ? ql[q] : 0.f;
      run[mi][h] = -INFINITY;
    }

  for (int c0 = 0; c0 < ts; c0 += BN) {
    const int64_t row0 = sub * ts + c0;
    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    for (int k0 = 0; k0 < f; k0 += BK) {
      for (int e = tid; e < BN * BK; e += THREADS) {
        const int r = e / BK, kk = e % BK;
        const int gk = k0 + kk;
        __nv_bfloat16 hi, lo;
        stage_x<MODE>(X, (row0 + r) * f + gk, gk < f, hi, lo);
        Xh[r][kk] = hi;
        if constexpr (SPLIT) Xl[r][kk] = lo;
      }
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int m = e / BK, kk = e % BK;
        const int gq = q0 + m, gk = k0 + kk;
        const bool ok = gq < b && gk < f;
        const int64_t i = (int64_t)gq * f + gk;
        Qh[m][kk] = ok ? qhi[i] : __float2bfloat16_rn(0.f);
        if constexpr (SPLIT) Ql[m][kk] = ok ? qlo[i] : __float2bfloat16_rn(0.f);
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = w * 32 + ni * 8 + g;
          bh[ni][0] = ld32(&Xh[n][ks + t * 2]);
          bh[ni][1] = ld32(&Xh[n][ks + t * 2 + 8]);
          if constexpr (SPLIT) {
            bl[ni][0] = ld32(&Xl[n][ks + t * 2]);
            bl[ni][1] = ld32(&Xl[n][ks + t * 2 + 8]);
          }
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const int m = mi * 16 + g;
          const uint32_t a0 = ld32(&Qh[m][ks + t * 2]), a1 = ld32(&Qh[m + 8][ks + t * 2]);
          const uint32_t a2 = ld32(&Qh[m][ks + t * 2 + 8]), a3 = ld32(&Qh[m + 8][ks + t * 2 + 8]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a0, a1, a2, a3, bh[ni][0], bh[ni][1]);
          if constexpr (SPLIT) {
            const uint32_t l0 = ld32(&Ql[m][ks + t * 2]), l1 = ld32(&Ql[m + 8][ks + t * 2]);
            const uint32_t l2 = ld32(&Ql[m][ks + t * 2 + 8]), l3 = ld32(&Ql[m + 8][ks + t * 2 + 8]);
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
              mma_bf16(acc[mi][ni], a0, a1, a2, a3, bl[ni][0], bl[ni][1]);   // qhi·xlo
              mma_bf16(acc[mi][ni], l0, l1, l2, l3, bh[ni][0], bh[ni][1]);   // qlo·xhi
            }
          }
        }
      }
      __syncthreads();
    }

    // Epilogue: accumulator e of tile (mi, ni) is query mi*16 + g + 8*(e/2),
    // corpus row w*32 + ni*8 + t*2 + e%2 of the chunk.
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int64_t col = row0 + w * 32 + ni * 8 + t * 2 + j;
        const float rnc = rn[col], lc = lams[col];
        const bool masked = col >= mask_from;
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float pen = fminf(fabsf(__fsub_rn(lc, qlb[mi][h])), 1.f);
            float s = __fmul_rn(__fmul_rn(acc[mi][ni][2 * h + j], rnc), aq[mi][h]);
            s = __fadd_rn(s, __fsub_rn(be[mi][h], __fmul_rn(be[mi][h], pen)));
            run[mi][h] = fmaxf(run[mi][h], masked ? -INFINITY : s);
          }
      }
  }

  // Max over the 4 lanes sharing a query row, then over the 4 warps.
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = run[mi][h];
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (t == 0) red[w][mi * 16 + g + 8 * h] = m;
    }
  __syncthreads();
  if (tid < BM && q0 + tid < b) {
    float m = red[0][tid];
#pragma unroll
    for (int i = 1; i < THREADS / 32; ++i) m = fmaxf(m, red[i][tid]);
    out[(int64_t)(q0 + tid) * ns + sub] = m;
  }
}

template <bool INT8>
__global__ void slab_dots_kernel(const void* __restrict__ X, const float* __restrict__ Q,
                                 const int64_t* __restrict__ sel, float* __restrict__ out,
                                 int c, int ts, int f, int64_t nslabs, int vec) {
  extern __shared__ __align__(16) float qs[];
  const int64_t bi = blockIdx.x;            // query b = bi / c, slot bi % c
  const int64_t b = bi / c;
  for (int j = threadIdx.x; j < f; j += blockDim.x) qs[j] = Q[b * f + j];
  __syncthreads();
  float* dst = out + bi * ts;
  const int64_t s = sel[bi];
  if (s < 0 || s >= nslabs) {
    for (int r = threadIdx.x; r < ts; r += blockDim.x) dst[r] = NAN;
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int r = warp; r < ts; r += nw) {
    const int64_t row = s * ts + r;
    float acc = 0.f;
    if (INT8) {
      const int8_t* xr = reinterpret_cast<const int8_t*>(X) + row * f;
      if (vec) {
        const char4* x4 = reinterpret_cast<const char4*>(xr);
        for (int j = lane; j < f / 4; j += 32) {
          const char4 v = x4[j];
          const float4 q = reinterpret_cast<const float4*>(qs)[j];
          acc = fmaf(q.x, (float)v.x, acc);
          acc = fmaf(q.y, (float)v.y, acc);
          acc = fmaf(q.z, (float)v.z, acc);
          acc = fmaf(q.w, (float)v.w, acc);
        }
      } else {
        for (int j = lane; j < f; j += 32) acc = fmaf(qs[j], (float)xr[j], acc);
      }
    } else {
      const float* xr = reinterpret_cast<const float*>(X) + row * f;
      if (vec) {
        const float4* x4 = reinterpret_cast<const float4*>(xr);
        for (int j = lane; j < f / 4; j += 32) {
          const float4 v = x4[j];
          const float4 q = reinterpret_cast<const float4*>(qs)[j];
          acc = fmaf(q.x, v.x, acc);
          acc = fmaf(q.y, v.y, acc);
          acc = fmaf(q.z, v.z, acc);
          acc = fmaf(q.w, v.w, acc);
        }
      } else {
        for (int j = lane; j < f; j += 32) acc = fmaf(qs[j], xr[j], acc);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) dst[r] = acc;
  }
}

}  // namespace

extern "C" {

const char* mrs_cuda_strerror(int rc) { return cudaGetErrorString((cudaError_t)rc); }

// X [N, f] (bf16, int8 or f32 by `mode`; the first n0 rows are read),
// rn/lams [N] f32, qhi/qlo [b, f] bf16 (qlo read for f32 rows only),
// aqrn/beta/ql [b] f32 → out [b, n0/ts] f32; contiguous. ts % 128 == 0,
// n0 % ts == 0. Returns cudaGetLastError() after the launch.
int mrs_tilemax_only(const void* X, const float* rn, const float* lams, const void* qhi,
                     const void* qlo, const float* aqrn, const float* beta, const float* ql,
                     int64_t mask_from, int64_t n0, int f, int b, int ts, int mode,
                     float* out, void* stream) {
  if (ts <= 0 || ts % BN != 0 || n0 % ts != 0) return (int)cudaErrorInvalidValue;
  const int qblocks = (b + BM - 1) / BM;
  const int64_t ns = n0 / ts;
  const int64_t blocks = ns * qblocks;
  if (blocks == 0) return 0;
  const auto* qh = reinterpret_cast<const __nv_bfloat16*>(qhi);
  const auto* qo = reinterpret_cast<const __nv_bfloat16*>(qlo);
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == SCAN_BF16) {
    tilemax_only_kernel<SCAN_BF16><<<(unsigned)blocks, THREADS, 0, st>>>(
        X, rn, lams, qh, qo, aqrn, beta, ql, mask_from, f, b, ts, ns, qblocks, out);
  } else if (mode == SCAN_INT8) {
    tilemax_only_kernel<SCAN_INT8><<<(unsigned)blocks, THREADS, 0, st>>>(
        X, rn, lams, qh, qo, aqrn, beta, ql, mask_from, f, b, ts, ns, qblocks, out);
  } else if (mode == SCAN_F32) {
    tilemax_only_kernel<SCAN_F32><<<(unsigned)blocks, THREADS, 0, st>>>(
        X, rn, lams, qh, qo, aqrn, beta, ql, mask_from, f, b, ts, ns, qblocks, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// X [N, f] f32 (int8_rows = 0) or int8 (int8_rows = 1), Q [b, f] f32 (the
// bf16-rounded query for int8 rows), sel [b, c] int64 slab ids in
// [0, nslabs) → out [b, c, ts] f32. Returns cudaGetLastError().
int mrs_slab_dots(const void* X, const float* Q, const int64_t* sel, float* out, int b, int c,
                  int ts, int f, int64_t nslabs, int int8_rows, void* stream) {
  const int64_t blocks = (int64_t)b * c;
  if (blocks == 0) return 0;
  const size_t smem = (size_t)f * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int align = int8_rows ? 4 : 16;
  const int vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(X) % align == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (int8_rows) {
    slab_dots_kernel<true><<<(unsigned)blocks, 256, smem, st>>>(X, Q, sel, out, c, ts, f, nslabs, vec);
  } else {
    slab_dots_kernel<false><<<(unsigned)blocks, 256, smem, st>>>(X, Q, sel, out, c, ts, f, nslabs, vec);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
