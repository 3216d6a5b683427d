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
// cores through wgmma.mma_async m64nNk16.
//
//   What bounds it on the H100: at B = 256, n0 = 999,424, F = 128 it does
//   2·B·n0·F = 65.5 GFLOP per bf16 pass (0.066 ms at 989 TFLOP/s; three
//   passes for bf16x3, 0.199 ms) against the corpus read once (256 MB
//   bf16: 0.076 ms at 3.35 TB/s; 128 MB int8; 512 MB f32). So bf16 rows
//   are bound by bytes, int8 and f32 rows by operations. Beside both
//   stands the epilogue: ≈ 9 f32 operations for each of the B·n0 scores
//   (2.3 G, ≈ 0.08 ms at the card's 128 lanes × 132 SMs), which no tiling
//   removes because the λ penalty depends on the row and the query.
//
//   Design (tilemax_only_kernel). Corpus rows are the M of
//   the product (64 per warpgroup instruction), queries the N (NQ = 256,
//   64 or 16: the narrowest that holds the batch, stepped down until shared
//   memory holds the queries), F the K. This orientation lets one mainloop
//   serve all three corpus types, because the type is converted in
//   registers. The grid is persistent: one block of two warpgroups per SM
//   and query block; warpgroup i of the grid takes sub-tiles i, i + n,
//   i + 2n, ..., so at any moment the grid reads one dense window of the
//   corpus, and with B ≤ 256 the corpus is read once per launch.
//   * The queries are staged once per block, as bf16 hi (and lo for f32
//     rows), in the 128-byte-swizzled K-major layout that the wgmma matrix
//     descriptor reads, and stay there for the block's life.
//   * The corpus arrives through 16-byte cp.async copies in its own type
//     (int8 rows travel as 1 byte, f32 rows as 4) into a ring of 4 stages
//     per warpgroup; a stage is 64 rows × 128 bytes of K, so three stages
//     of loads run ahead of the products. One named barrier per stage and
//     warpgroup; the two warpgroups never wait for each other, so one's
//     epilogue overlaps the other's products.
//   * The corpus is the A operand, in registers. A thread reads 4
//     consecutive features of its two rows from the stage (4, 8 or 16
//     bytes; the stage's 16-byte units are XOR-swizzled by row so that
//     these reads and the copies are conflict-free for each type) and
//     upcasts int8 → bf16 or splits f32 → hi/lo there. Because the
//     fragment wants features (2t, 2t+1, 2t+8, 2t+9) and the thread holds
//     (4t .. 4t+3), the queries are staged with the features of every
//     group of 16 permuted the same way: a dot product does not care.
//     bf16x3 sends hi·qhi, lo·qhi and hi·qlo on one accumulator. Two sets
//     of fragment registers alternate, so a group's fragments are read
//     while the group before multiplies; the stage loop of a tile touches
//     the accumulators with wgmma alone, which lets the compiler keep the
//     products in flight across stages (any other use makes it drain them).
//   * Epilogue on the accumulators with rounded multiplies and adds (no
//     contraction, as the plain version rounds), rows ≥ mask_from to −inf
//     (tiles wholly below mask_from skip the test). The maximum over a
//     tile's rows: within the thread over its two rows, then over the 8
//     lanes that hold a column by three halvings (each lane ends with an
//     eighth of the columns: 56 shuffles a tile instead of 192), kept in
//     NQ/32 registers across the sub-tile's tiles, then over the
//     warpgroup's four warps through shared memory, and [B, ns] written
//     directly (the TPU's transposed (ns, B) output was a Mosaic rule).
//   The loads were measured at ≤ 8% of a warpgroup's cycles, so the ring
//   stayed on cp.async; TMA and a producer warp were not built.
//
//   A row pitch or base address that is not a multiple of 16 bytes cannot
//   be copied in 16-byte units: the kernel's VEC = false instances fill the
//   same stages element by element with plain loads and stores (same layout,
//   same products, no copies in flight: a correctness path, not a fast one).
//   The C entry point chooses from F, the type and the address, never by
//   catching a failure. Any B; F as far as 16 queries' slabs fit beside the
//   rings (2560 features of f32 rows, 5120 of bf16 or int8 rows; the callers'
//   fused range ends at 2048) — a wider F is refused, not streamed.
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

#include "wgmma_bf16_rs.cuh"

namespace {

enum { SCAN_BF16 = 0, SCAN_INT8 = 1, SCAN_F32 = 2 };

constexpr int TS_UNIT = 128;                   // a sub-tile is a multiple of this many rows
constexpr int WG_ROWS = 64;                    // corpus rows per wgmma tile
constexpr int STAGE_BYTES = WG_ROWS * 128;     // a stage: 64 rows × 128 bytes of K
constexpr int RING = 4;                        // stages per warpgroup
constexpr int WGS = 2;                         // warpgroups per block
constexpr int THREADS = WGS * 128;
constexpr int MAX_SMEM = 232448;               // dynamic shared memory a block may ask for
constexpr int SMEM_ALIGN = 1024;               // the swizzled query slabs want it

template <int MODE>
struct Rows {                                  // the corpus type of a scan mode
  static constexpr int ESZ = MODE == SCAN_BF16 ? 2 : MODE == SCAN_INT8 ? 1 : 4;
  static constexpr int KSTAGE = 128 / ESZ;     // features per stage
  static constexpr int KB = KSTAGE / 16;       // 16-feature blocks per stage
};

// Features the staged queries span: whole stages of the corpus type, whole
// 64-feature slabs.
__host__ __device__ inline int query_k(int f, int esz) {
  const int kstage = 128 / esz;
  const int k = (f + kstage - 1) / kstage * kstage;
  return (k + 63) / 64 * 64;
}

// Dynamic shared memory of kernel D: the query slabs (hi, and lo for
// f32 rows), the rings, the warps' partial maxima, the per-query terms.
__host__ __device__ inline int64_t smem_bytes_of(int f, int esz, int nq) {
  const int64_t slabs = (int64_t)(query_k(f, esz) / 64) * nq * 128 * (esz == 4 ? 2 : 1);
  return SMEM_ALIGN + slabs + WGS * RING * STAGE_BYTES + (WGS * 4 + 3) * nq * 4;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;             // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
// One 16-byte unit of a corpus row read element by element (any alignment);
// bytes at or past the row's pitch are zero.
template <int ESZ>
__device__ __forceinline__ uint4 load_unit_elementwise(const unsigned char* row, int64_t kbyte,
                                                       int64_t pitch) {
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16 / ESZ; ++j) {
    const int64_t o = kbyte + j * ESZ;
    if (o < pitch) {
      uint32_t v;
      if constexpr (ESZ == 1) v = row[o];
      else if constexpr (ESZ == 2) v = *reinterpret_cast<const uint16_t*>(row + o);
      else v = *reinterpret_cast<const uint32_t*>(row + o);
      w[(j * ESZ) >> 2] |= v << (8 * ((j * ESZ) & 3));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Row r's 16-byte unit u of a stage sits at unit u ^ key(r): the key makes
// the fragment reads of each type conflict-free (a 4-byte read is served 32
// lanes at a time, an 8-byte read 16, a 16-byte read 8).
template <int MODE>
__device__ __forceinline__ int unit_key(int r) {
  if constexpr (MODE == SCAN_INT8) return r & 7;
  else if constexpr (MODE == SCAN_BF16) return (r & 3) << 1;
  else return (r & 1) << 2;
}

// One 16-feature block of a thread's two rows (stage rows r and r + 8) as A
// fragments: features 4t .. 4t+3 of the block, (a0, a2) from row r, (a1, a3)
// from row r + 8; `lo` only for f32 rows.
template <int MODE>
__device__ __forceinline__ void load_fragments(const unsigned char* stage, int r, int t, int kb,
                                               uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int key = unit_key<MODE>(r);            // rows r and r + 8 share it
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned char* row = stage + (r + 8 * h) * 128;
    if constexpr (MODE == SCAN_BF16) {
      const uint2 v = *reinterpret_cast<const uint2*>(
          row + (((2 * kb + (t >> 1)) ^ key) << 4) + 8 * (t & 1));
      hi[h] = v.x;
      hi[2 + h] = v.y;
    } else if constexpr (MODE == SCAN_INT8) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(row + ((kb ^ key) << 4) + 4 * t);
      hi[h] = pack_bf16((float)(int8_t)(v & 0xff), (float)(int8_t)((v >> 8) & 0xff));
      hi[2 + h] = pack_bf16((float)(int8_t)((v >> 16) & 0xff), (float)(int8_t)(v >> 24));
    } else {
      const float4 v = *reinterpret_cast<const float4*>(row + (((4 * kb + t) ^ key) << 4));
      const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
      hi[h] = *reinterpret_cast<const uint32_t*>(&h01);
      hi[2 + h] = *reinterpret_cast<const uint32_t*>(&h23);
      lo[h] = pack_bf16(__fsub_rn(v.x, __low2float(h01)), __fsub_rn(v.y, __high2float(h01)));
      lo[2 + h] = pack_bf16(__fsub_rn(v.z, __low2float(h23)), __fsub_rn(v.w, __high2float(h23)));
    }
  }
}

// The blend of one 64-row tile's accumulators: m[2j + e] is the larger of
// the thread's two rows' scores for column 8j + 2t + e.
template <int NQ, bool MASK>
__device__ __forceinline__ void blend_tile(const float (&acc)[NQ / 2], float (&m)[NQ / 4],
                                           const float* par, int t, const float (&rnc)[2],
                                           const float (&lc)[2], const bool (&masked)[2]) {
#pragma unroll
  for (int j = 0; j < NQ / 8; ++j) {
    const float2 aq = *reinterpret_cast<const float2*>(par + 8 * j + 2 * t);
    const float2 be = *reinterpret_cast<const float2*>(par + NQ + 8 * j + 2 * t);
    const float2 qlb = *reinterpret_cast<const float2*>(par + 2 * NQ + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float aqe = e ? aq.y : aq.x, bee = e ? be.y : be.x, qle = e ? qlb.y : qlb.x;
      float sh[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float pen = fminf(fabsf(__fsub_rn(lc[h], qle)), 1.f);
        float s = __fmul_rn(__fmul_rn(acc[4 * j + 2 * h + e], rnc[h]), aqe);
        s = __fadd_rn(s, __fsub_rn(bee, __fmul_rn(bee, pen)));
        sh[h] = (MASK && masked[h]) ? -INFINITY : s;
      }
      m[2 * j + e] = fmaxf(sh[0], sh[1]);
    }
  }
}

// One halving of a maximum over lanes: the lane whose `upper` is set keeps
// the upper half of m[0 .. W), its partner (lane ^ mask) the lower half;
// each sends the other half across and both end with W/2 values in m[0 .. W/2).
template <int W>
__device__ __forceinline__ void halve_max(float* m, bool upper, int mask) {
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    const float keep = upper ? m[i + W / 2] : m[i];
    const float send = upper ? m[i] : m[i + W / 2];
    m[i] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, mask));
  }
}

// Values a lane keeps of its NV column maxima once they are reduced over
// the 8 lanes g = 0..7 that hold the same columns.
template <int NV>
struct Fold {
  static constexpr int KEEP = NV >= 8 ? NV / 8 : NV;
  // In: m[i] for column 8(i/2) + 2t + i%2. Out, NV ≥ 8: m[r], r < NV/8, is
  // the maximum over the 8 lanes of original index (NV/8)·g + r (three
  // halvings: 7/8 fewer shuffles than reducing every value on every lane);
  // NV < 8: every lane holds every maximum.
  static __device__ __forceinline__ void lanes(float (&m)[NV], int lane) {
    if constexpr (NV >= 8) {
      halve_max<NV>(m, lane & 16, 16);
      halve_max<NV / 2>(m, lane & 8, 8);
      halve_max<NV / 4>(m, lane & 4, 4);
    } else {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 16));
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 8));
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 4));
      }
    }
  }
  // Column of kept value r of lane (g, t).
  static __device__ __forceinline__ int column(int r, int g, int t) {
    const int i = NV >= 8 ? KEEP * g + r : r;
    return 8 * (i >> 1) + 2 * t + (i & 1);
  }
};

// VEC: the corpus' row pitch and address are multiples of 16 bytes, so a
// stage arrives by 16-byte cp.async; otherwise the same threads read the same
// units element by element and store them into the same layout.
template <int MODE, int NQ, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
tilemax_only_kernel(const unsigned char* __restrict__ X, const float* __restrict__ rn,
                    const float* __restrict__ lams, const __nv_bfloat16* __restrict__ qhi,
                    const __nv_bfloat16* __restrict__ qlo, const float* __restrict__ aqrn,
                    const float* __restrict__ beta, const float* __restrict__ ql,
                    int64_t mask_from, int f, int b, int ts, int64_t ns,
                    float* __restrict__ out) {
  using R = Rows<MODE>;
  constexpr bool SPLIT = MODE == SCAN_F32;
  constexpr int SLAB = NQ * 128;                 // bytes of one 64-feature query slab
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1) / SMEM_ALIGN * SMEM_ALIGN);
  const int kq = query_k(f, R::ESZ);
  const int nslab = kq / 64;
  unsigned char* q_hi = base;
  unsigned char* q_lo = q_hi + (SPLIT ? nslab * SLAB : 0);
  unsigned char* rings = q_lo + nslab * SLAB;
  float* red = reinterpret_cast<float*>(rings + WGS * RING * STAGE_BYTES);
  float* par = red + WGS * 4 * NQ;               // aqrn, beta, ql of the block's queries

  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * NQ;

  // Stage the queries: feature 4u + i of query n goes to position
  // (i < 2 ? 2(u%4) + i : 8 + 2(u%4) + i − 2) of its 16-feature block, in the
  // 128-byte-swizzled K-major slab layout (8 queries × 128 bytes an atom).
  // A thread moves 8 features (two groups of 4) at a time, with one 16-byte
  // load where the query rows allow it.
  const bool q_vec = f % 8 == 0 && reinterpret_cast<uintptr_t>(qhi) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(qlo) % 16 == 0;
  for (int e = tid; e < NQ * (kq / 8); e += THREADS) {
    const int n = e / (kq / 8), k8 = e % (kq / 8);   // features 8·k8 .. 8·k8 + 7
    const bool row_ok = q0 + n < b;
    const int64_t src = (int64_t)(q0 + n) * f + 8 * k8;
    uint32_t h[4] = {0, 0, 0, 0}, l[4] = {0, 0, 0, 0};   // feature pairs
    if (row_ok && 8 * k8 < f) {
      if (q_vec) {
        const uint4 v = *reinterpret_cast<const uint4*>(qhi + src);
        h[0] = v.x; h[1] = v.y; h[2] = v.z; h[3] = v.w;
        if constexpr (SPLIT) {
          const uint4 u = *reinterpret_cast<const uint4*>(qlo + src);
          l[0] = u.x; l[1] = u.y; l[2] = u.z; l[3] = u.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (8 * k8 + i < f) {
            h[i >> 1] |= (uint32_t) reinterpret_cast<const uint16_t*>(qhi)[src + i] << (16 * (i & 1));
            if constexpr (SPLIT)
              l[i >> 1] |= (uint32_t) reinterpret_cast<const uint16_t*>(qlo)[src + i] << (16 * (i & 1));
          }
        }
      }
    }
    const int kblk = k8 >> 1;                        // 16-feature block
    const int unit = (kblk & 3) * 2;                 // unit of positions 0..7 of the block
    const int key = n & 7;
    const int off = (kblk >> 2) * SLAB + (n >> 3) * 1024 + (n & 7) * 128 + 8 * (k8 & 1);
#pragma unroll
    for (int i = 0; i < 2; ++i) {                    // group t = 2(k8 % 2) + i of the block
      *reinterpret_cast<uint32_t*>(q_hi + off + 4 * i + ((unit ^ key) << 4)) = h[2 * i];
      *reinterpret_cast<uint32_t*>(q_hi + off + 4 * i + (((unit + 1) ^ key) << 4)) = h[2 * i + 1];
      if constexpr (SPLIT) {
        *reinterpret_cast<uint32_t*>(q_lo + off + 4 * i + ((unit ^ key) << 4)) = l[2 * i];
        *reinterpret_cast<uint32_t*>(q_lo + off + 4 * i + (((unit + 1) ^ key) << 4)) = l[2 * i + 1];
      }
    }
  }
  for (int n = tid; n < NQ; n += THREADS) {
    const bool ok = q0 + n < b;
    par[n] = ok ? aqrn[q0 + n] : 0.f;
    par[NQ + n] = ok ? beta[q0 + n] : 0.f;
    par[2 * NQ + n] = ok ? ql[q0 + n] : 0.f;
  }
  // wgmma reads the slabs through the asynchronous proxy.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // From here on the two warpgroups run on their own.
  const int wg = tid >> 7, wtid = tid & 127;
  const int w = wtid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int64_t nwg = (int64_t)gridDim.x * WGS, me = (int64_t)blockIdx.x * WGS + wg;
  // Sub-tiles me, me + nwg, me + 2·nwg, ...: at any moment the warpgroups of
  // the grid read one dense window of the corpus, which spreads over all
  // memory channels (contiguous ranges a warpgroup would make every
  // warpgroup hit the same offset of its own range at once).
  const int64_t my_subs = me < ns ? (ns - me + nwg - 1) / nwg : 0;
  const int tiles_per_sub = ts / WG_ROWS;
  const int nst = (f * R::ESZ + 127) / 128;      // stages per tile
  const int64_t total = my_subs * tiles_per_sub * nst;
  const int64_t pitch = (int64_t)f * R::ESZ;
  unsigned char* ring = rings + wg * RING * STAGE_BYTES;
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);
  float* red_wg = red + wg * 4 * NQ;

  // Flat stage i of this warpgroup: K bytes [128·(i % nst), +128) of tile
  // i / nst, the tiles being the 64-row pieces of its sub-tiles in turn.
  int64_t load_row0 = me * ts;
  int load_ks = 0, load_tile = 0;
  auto load_stage = [&](int slot) {
#pragma unroll
    for (int it = 0; it < WG_ROWS * 8 / 128; ++it) {
      const int e = wtid + it * 128;
      const int r = e >> 3, u = e & 7;
      const int64_t kbyte = (int64_t)load_ks * 128 + u * 16;
      const int at = slot * STAGE_BYTES + r * 128 + ((u ^ unit_key<MODE>(r)) << 4);
      const unsigned char* row = X + (load_row0 + r) * pitch;
      if constexpr (VEC) {
        const bool ok = kbyte < pitch;
        cp_async16(ring_s + at, row + (ok ? kbyte : 0), ok);
      } else {
        *reinterpret_cast<uint4*>(ring + at) = load_unit_elementwise<R::ESZ>(row, kbyte, pitch);
      }
    }
    if (++load_ks == nst) {
      load_ks = 0;
      load_row0 += WG_ROWS;
      if (++load_tile == tiles_per_sub) { load_tile = 0; load_row0 += (nwg - 1) * ts; }
    }
  };
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    if (s < total) load_stage(s);
    cp_async_commit();
  }

  const uint64_t desc_base = ((uint64_t)1 << 62) | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 16);
  const uint32_t q_hi_s = (uint32_t)__cvta_generic_to_shared(q_hi);
  const uint32_t q_lo_s = (uint32_t)__cvta_generic_to_shared(q_lo);

  using F = Fold<NQ / 4>;
  constexpr int HALF = R::KB / 2;                // 16-feature blocks per group of products
  float acc[NQ / 2];
  float run[F::KEEP];                            // the sub-tile's maxima so far
#pragma unroll
  for (int i = 0; i < F::KEEP; ++i) run[i] = -INFINITY;
  float rnc[2], lc[2];
  bool masked[2];
  int64_t row0 = me * ts;                        // first row of the tile being multiplied
  int64_t sub = me;
  int tile_in_sub = 0;
  // Two sets of fragment registers: while the products of one group run, the
  // next group's fragments are read and converted into the other set.
  uint32_t hi[2][HALF][4], lo[2][HALF][4];

  int64_t i = 0;                                 // flat stage
  for (int64_t tile = 0; tile < my_subs * tiles_per_sub; ++tile) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = row0 + 16 * w + g + 8 * h;
      rnc[h] = rn[row];
      lc[h] = lams[row];
      masked[h] = row >= mask_from;
    }
    // The tile's stages. Inside this loop the accumulators are touched by
    // the products alone, so they stay in flight from one stage to the next.
    for (int ks = 0; ks < nst; ++ks, ++i) {
      cp_async_wait<RING - 2>();                 // stage i has landed (this thread's copies)
      wg_barrier(wg);                            // ... the warpgroup's (or is stored); and stage i-1 is read out
      if (i + RING - 1 < total) load_stage((int)((i + RING - 1) % RING));
      cp_async_commit();
      const unsigned char* stage = ring + (i % RING) * STAGE_BYTES;
#pragma unroll
      for (int set = 0; set < 2; ++set) {
#pragma unroll
        for (int kb = 0; kb < HALF; ++kb)
          load_fragments<MODE>(stage, 16 * w + g, t, set * HALF + kb, hi[set][kb], lo[set][kb]);
        wgmma::fence();
#pragma unroll
        for (int kb = 0; kb < HALF; ++kb) {
          const int kblk = ks * R::KB + set * HALF + kb;   // 16-feature block of the row
          {                                       // (blocks past F multiply zeros by zeros)
            const uint32_t at = (kblk >> 2) * SLAB + (kblk & 3) * 32;
            const uint64_t d_hi = desc_base | (uint64_t)(((q_hi_s + at) & 0x3FFFF) >> 4);
            wgmma::Mma<NQ>::rs(acc, hi[set][kb][0], hi[set][kb][1], hi[set][kb][2], hi[set][kb][3],
                               d_hi, kblk != 0);
            if constexpr (SPLIT) {
              const uint64_t d_lo = desc_base | (uint64_t)(((q_lo_s + at) & 0x3FFFF) >> 4);
              wgmma::Mma<NQ>::rs(acc, lo[set][kb][0], lo[set][kb][1], lo[set][kb][2], lo[set][kb][3],
                                 d_hi, 1);
              wgmma::Mma<NQ>::rs(acc, hi[set][kb][0], hi[set][kb][1], hi[set][kb][2], hi[set][kb][3],
                                 d_lo, 1);
            }
          }
        }
        wgmma::commit();
        wgmma::wait<1>();                        // the other set's products are done: it is free
      }
    }

    // The tile's products are under way: once done, blend, and fold into the
    // running maxima.
    wgmma::wait<0>();
#pragma unroll
    for (int r = 0; r < NQ / 2; ++r) wgmma::keep(acc[r]);
    float m[NQ / 4];
    if (row0 + WG_ROWS > mask_from) blend_tile<NQ, true>(acc, m, par, t, rnc, lc, masked);
    else blend_tile<NQ, false>(acc, m, par, t, rnc, lc, masked);
    F::lanes(m, lane);
#pragma unroll
    for (int r = 0; r < F::KEEP; ++r) run[r] = fmaxf(run[r], m[r]);
    row0 += WG_ROWS;
    if (++tile_in_sub < tiles_per_sub) continue;
    tile_in_sub = 0;

    // The sub-tile is done: maxima over the 4 warps, and out.
    if (NQ / 4 >= 8 || g == 0) {
#pragma unroll
      for (int r = 0; r < F::KEEP; ++r) red_wg[w * NQ + F::column(r, g, t)] = run[r];
    }
#pragma unroll
    for (int r = 0; r < F::KEEP; ++r) run[r] = -INFINITY;
    wg_barrier(wg);
    for (int c = wtid; c < NQ; c += 128) {
      const float mx = fmaxf(fmaxf(red_wg[c], red_wg[NQ + c]),
                             fmaxf(red_wg[2 * NQ + c], red_wg[3 * NQ + c]));
      if (q0 + c < b) out[(int64_t)(q0 + c) * ns + sub] = mx;
    }
    sub += nwg;                                  // red_wg is rewritten a stage barrier later
    row0 += (nwg - 1) * ts;
  }
}

// What the entry point chooses for a launch: 16-byte copies or the
// element-wise loader, the queries per block (the narrowest of 16, 64, 256
// that holds the batch, 256 for more, stepped down while the slabs do not
// fit; 0 if not even 16 queries fit: the launch is refused), and the dynamic
// shared memory that asks for.
struct Plan {
  int vec, nq, smem;
};

inline Plan plan_of(const void* X, int f, int b, int esz) {
  Plan p = {((int64_t)f * esz) % 16 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0, 0, 0};
  const int widths[3] = {256, 64, 16};
  for (int i = 0; i < 3 && p.nq == 0; ++i) {
    const bool needed = i == 2 || b > widths[i + 1];
    if (needed && smem_bytes_of(f, esz, widths[i]) <= MAX_SMEM) p.nq = widths[i];
  }
  if (p.nq) p.smem = (int)smem_bytes_of(f, esz, p.nq);
  return p;
}

template <int MODE, int NQ, bool VEC>
int launch_kernel(const void* X, const float* rn, const float* lams, const __nv_bfloat16* qhi,
                  const __nv_bfloat16* qlo, const float* aqrn, const float* beta, const float* ql,
                  int64_t mask_from, int f, int b, int ts, int64_t ns, int smem, float* out,
                  cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(tilemax_only_kernel<MODE, NQ, VEC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  const int qblocks = (b + NQ - 1) / NQ;
  int64_t bx = sms / qblocks;                    // about one block per SM over the grid
  if (bx > (ns + WGS - 1) / WGS) bx = (ns + WGS - 1) / WGS;
  if (bx < 1) bx = 1;
  tilemax_only_kernel<MODE, NQ, VEC>
      <<<dim3((unsigned)bx, (unsigned)qblocks), THREADS, smem, st>>>(
          reinterpret_cast<const unsigned char*>(X), rn, lams, qhi, qlo, aqrn, beta, ql, mask_from,
          f, b, ts, ns, out);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_mode(const void* X, const float* rn, const float* lams, const __nv_bfloat16* qhi,
                const __nv_bfloat16* qlo, const float* aqrn, const float* beta, const float* ql,
                int64_t mask_from, int f, int b, int ts, int64_t ns, float* out,
                cudaStream_t st) {
  const Plan p = plan_of(X, f, b, Rows<MODE>::ESZ);
  if (p.nq == 0) return (int)cudaErrorInvalidValue;
#define MRS_LAUNCH(N, V)                                                                       \
  launch_kernel<MODE, N, V>(X, rn, lams, qhi, qlo, aqrn, beta, ql, mask_from, f, b, ts, ns, \
                            p.smem, out, st)
#define MRS_WIDTH(V) (p.nq == 256 ? MRS_LAUNCH(256, V) : p.nq == 64 ? MRS_LAUNCH(64, V) : MRS_LAUNCH(16, V))
  return p.vec ? MRS_WIDTH(true) : MRS_WIDTH(false);
#undef MRS_WIDTH
#undef MRS_LAUNCH
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
// n0 % ts == 0. 16-byte copies when X's row pitch and address are multiples
// of 16 bytes, the element-wise loader otherwise; cudaErrorInvalidValue when
// f is so wide that 16 queries' slabs do not fit in shared memory (past 2560
// features of f32 rows, 5120 of bf16 or int8 rows). Returns
// cudaGetLastError() after the launch.
int mrs_tilemax_only(const void* X, const float* rn, const float* lams, const void* qhi,
                     const void* qlo, const float* aqrn, const float* beta, const float* ql,
                     int64_t mask_from, int64_t n0, int f, int b, int ts, int mode,
                     float* out, void* stream) {
  if (ts <= 0 || ts % TS_UNIT != 0 || n0 % ts != 0 || f <= 0) return (int)cudaErrorInvalidValue;
  const int64_t ns = n0 / ts;
  if (ns == 0 || b <= 0) return 0;
  const auto* qh = reinterpret_cast<const __nv_bfloat16*>(qhi);
  const auto* qo = reinterpret_cast<const __nv_bfloat16*>(qlo);
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == SCAN_BF16)
    return launch_mode<SCAN_BF16>(X, rn, lams, qh, qo, aqrn, beta, ql, mask_from, f, b, ts, ns, out, st);
  if (mode == SCAN_INT8)
    return launch_mode<SCAN_INT8>(X, rn, lams, qh, qo, aqrn, beta, ql, mask_from, f, b, ts, ns, out, st);
  if (mode == SCAN_F32)
    return launch_mode<SCAN_F32>(X, rn, lams, qh, qo, aqrn, beta, ql, mask_from, f, b, ts, ns, out, st);
  return (int)cudaErrorInvalidValue;
}

// What mrs_tilemax_only chooses for corpus address X, f features, b queries
// and scan mode `mode`: *vec 1 for 16-byte copies, 0 for the element-wise
// loader; *nq the queries per block; *smem the dynamic shared memory in
// bytes. cudaErrorInvalidValue where mrs_tilemax_only refuses the launch.
int mrs_tilemax_only_plan(const void* X, int f, int b, int mode, int* vec, int* nq, int* smem) {
  if (mode < SCAN_BF16 || mode > SCAN_F32 || f <= 0 || b <= 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(X, f, b, mode == SCAN_BF16 ? 2 : mode == SCAN_INT8 ? 1 : 4);
  *vec = p.vec;
  *nq = p.nq;
  *smem = p.smem;
  return p.nq ? 0 : (int)cudaErrorInvalidValue;
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
