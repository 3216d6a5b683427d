// Kernel A: raw taumode λ per row of X against the feature-space Laplacian L.
//
// Replaces the TPU kernels matternet_rs_tpu/ops/pallas/taumode_fused.py
// `taumode_lambdas_pallas` (_kernel) and `taumode_lambdas_pallas_bigf`
// (_kernel_bigf): one kernel serves every F <= 2048.
//
// What it computes, per row x (F values), with A = max(-L, 0) off the
// diagonal (zero on it) and deg/deg2 the row sums of A and A∘A:
//   nume  = Σ_i x_i (xL)_i               den  = Σ_i x_i²
//   total = Σ_i x_i² deg_i - 2 x_i (xA)_i + (x²A)_i
//   num4  = Σ_i x_i⁴ deg2_i - 4 x_i³ (xA²)_i + 6 x_i² (x²A²)_i
//                 - 4 x_i (x³A²)_i + (x⁴A²)_i
//   E = max(nume/den, 0), G = clamp(num4/total², 0, 1)
//   λ = τ·E/(E+τ) + (1-τ)·G, and λ = 0 where max|x| <= 1e-10.
// That is seven [N,F]x[F,F] products, 14·N·F² flops.
//
// Arithmetic: 3xTF32 on the tensor cores. Every operand v is split into
// hi = tf32(v) and lo = tf32(v - hi) (nearest, ties away, as cvt.rna), and each
// product is hi·hi + hi·lo + lo·hi summed in the f32 accumulators; the
// dropped lo·lo term is 2^-22 of the product, so λ stays within f32's own
// distance of the exact value. One TF32 pass alone is not f32-accurate and
// is not used.
//
// What bounds it on the H100: operations. 3·14·N·F² TF32 flops at 495
// TFLOP/s (1.39 ms at N = 1M, F = 128; 2.00 ms at N = 40k, F = 768) against
// N·F·4 bytes of X (0.153 ms at N = 1M, F = 128).
//
// Design. The wrapper prepares the B operand once per call: for W = [L |
// A | A²] zero-padded to Fp = F rounded up to 32, the hi and lo parts of W
// in 4 KB tiles of 32 output columns × 32 features, each stored in global
// memory exactly as a stage of the ring holds it (features permuted, rows
// swizzled; below). A block of two warpgroups owns a tile of 128 rows (64
// each) and walks its output columns in tiles of 32; for one column tile it
// streams 32-feature K-chunks through a 5-stage shared-memory ring, three
// chunks ahead of the products. A stage is the six operand tiles (three
// parts × hi/lo), one 4 KB bulk copy each, and the 16 KB X chunk, one
// tensor copy (TMA, through a tensor map the entry point encodes for X),
// all issued by one thread and counted in bytes on the stage's mbarrier:
// the other threads spend no instruction on loads. (16-byte cp.async by
// every thread stalled the warps at issue; one bulk copy per 128-byte X
// row was slower still.) Both warpgroups read every staged tile of Wp, so
// one read of W serves 128 rows.
//   * Products: wgmma.mma_async m64n32k8 tf32, the X powers as the register
//     operand, Wp from shared memory through the 128-byte-swizzled K-major
//     descriptor. All seven accumulators of a column tile are live (7 × 16
//     registers a thread), so the X chunk and each staged Wp tile are used
//     by every product that needs them: L by x, A by x and x², A² by x .. x⁴.
//   * The register operand wants features (t, t+4) of each 8-feature step
//     in lane t; a thread loads features 8t .. 8t+7 of its two rows with two
//     16-byte reads per chunk (row r's units are XOR-ed with r & 7, so these
//     reads are conflict-free), and Wp's features are stored so that slot q
//     of step s holds feature 8(q%4) + 2s + q/4: a dot product does not care
//     about the order of its terms. Each 128-byte row of a Wp tile keeps its
//     16-byte unit u at u ^ (row & 7), the swizzle the descriptor reads.
//     x², x³, x⁴ and the hi/lo splits are formed in registers once per
//     8-feature step; two sets of fragment registers alternate, so one
//     step's products run while the next step's fragments are formed.
//   * Fold: each product is linear in its accumulator, so when the column
//     tile's K-loop ends the seven tiles fold at once into four per-row sums
//     (nume, den, total, num4) and max|x|. The fold needs x at the tile's own
//     columns: the K-loop visits the chunks starting after the tile's own,
//     so that chunk is the last one staged and is read from the ring.
//   * Rows and columns: the grid is persistent over work items (a row tile
//     and a range of its column tiles). Where too few row tiles fill the
//     card's SMs in whole waves, a row tile's columns are split over a few
//     items; each writes its partial sums, and the last item of the row tile
//     to finish (an atomic ticket) adds them in a fixed order and computes λ.
//   * Edges: rows past N, features past F and columns past F are zeros
//     (exact). A row pitch or address off 16 bytes (F % 4 != 0 or an offset
//     view) cannot have a tensor map: the VEC = false instance fills the
//     same X stage element by element with plain loads; Wp is always
//     aligned.
// The C entry point chooses loader and splits (mrs_taumode_plan) and refuses
// a split count other than its own.

#include <cuda.h>            // CUtensorMap and its enums (the encoder comes through the runtime)
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int KCH = 32;                        // features per K-chunk = columns per column tile
constexpr int WG_ROWS = 64;                    // rows per warpgroup
constexpr int WGS = 2;                         // warpgroups per block
constexpr int ROWS = WGS * WG_ROWS;            // rows per row tile
constexpr int THREADS = WGS * 128;
constexpr int STAGES = 5;                      // K-chunks in the ring
constexpr int AHEAD = STAGES - 2;              // chunks in flight ahead of the one multiplied
constexpr int PARTS = 3;                       // L, A, A²
constexpr int PRODUCTS = 7;
constexpr int B_TILE = KCH * KCH * 4;          // 4 KB: 32 columns × 32 features
constexpr int B_STAGE = PARTS * 2 * B_TILE;    // the six operand tiles, first in a stage
constexpr int STAGE_BYTES = B_STAGE + ROWS * KCH * 4;   // and the 16 KB X chunk: 40 KB
constexpr int MAX_SMEM = 232448;               // dynamic shared memory a block may ask for
constexpr int SMEM_ALIGN = 1024;               // the 128-byte swizzle wants 1024-byte atoms
constexpr int MAX_SPLITS = 8;
constexpr int MAX_F = 2048;
constexpr int SUMS = 5;                        // nume, den, total, num4, max|x|

// Product p multiplies power POW(p) of x (0: x .. 3: x⁴) by part PART(p):
// xL, xA, x²A, xA², x²A², x³A², x⁴A².
__host__ __device__ constexpr int pow_of(int p) { return p == 2 || p == 4 ? 1 : p == 5 ? 2 : p == 6 ? 3 : 0; }
__host__ __device__ constexpr int part_of(int p) { return p == 0 ? 0 : p <= 2 ? 1 : 2; }

__host__ __device__ inline int padded_f(int f) { return (f + KCH - 1) / KCH * KCH; }
// The ring, a full-barrier per stage, the last-item flag; the same for every F.
constexpr int SMEM_BYTES = SMEM_ALIGN + STAGES * STAGE_BYTES + STAGES * 8 + 16;
static_assert(STAGE_BYTES % SMEM_ALIGN == 0 && SMEM_BYTES <= MAX_SMEM, "ring layout");

// v as the tensor cores' hi and lo operands. A tf32 operand is read from the
// upper 19 bits of its register (the low 13 are ignored), so adding half a
// unit to the magnitude's bits rounds to nearest, ties away from zero —
// what cvt.rna.tf32.f32 does, in one integer add instead of a conversion
// instruction, which issues at a lower rate; the same add rounds lo.
// hi & 0xFFFFE000 is hi's value; v − hi is exact.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) + 0x1000u;
  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi & 0xFFFFE000u))) + 0x1000u;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d (64 × 32, f32) += a (64 × 8, tf32, registers) · b (8 × 32, tf32, shared
// memory). Fragments (g = lane >> 2, t = lane & 3, warp w of the warpgroup):
//   a0 = row 16w+g, k t    a1 = row 16w+g+8, k t    a2 = row 16w+g, k t+4
//   a3 = row 16w+g+8, k t+4
//   d[4j + 2h + e] = row 16w + g + 8h, column 8j + 2t + e.
__device__ __forceinline__ void mma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// Copies by the Tensor Memory Accelerator, counted in bytes on an mbarrier:
// a contiguous run (bulk_copy) or a box of a 2-D tensor map (tensor_copy).
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(bar), "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tensor_copy(uint32_t dst, const CUtensorMap* map, int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// Where 16-byte unit u of row r of the X chunk sits: u ^ (r & 7), the
// 128-byte swizzle the tensor copy writes; the fragment reads of rows g and
// g + 1 then fall in different banks.
__device__ __forceinline__ int x_at(int r, int u) { return B_STAGE + r * 128 + ((u ^ (r & 7)) << 4); }

// The column tiles [*cb, *ce) of work item `item`.
__device__ __forceinline__ void item_columns(int64_t item, int splits, int cpt, int nct, int* cb,
                                             int* ce) {
  const int cs = (int)(item % splits);
  *cb = cs * cpt;
  *ce = min(nct, *cb + cpt);
}

// Position of a block in its flat sequence of stages: work item, column
// tile c in [c, ce), and step i of the tile's K-loop (chunk (c + 1 + i) % nk).
struct Walk {
  int64_t item;
  int c, ce, i;
};

// One stage, issued by thread 0 and counted in bytes on the stage's
// mbarrier: the six Wp tiles of columns [32 c, 32 c + 32) and features
// [32 kc, 32 kc + 32) (4 KB each, stored in global memory as the stage holds
// them: one bulk copy each), and the X chunk of rows [row0, row0 + 128) and
// the same features (one tensor copy through `xmap`, which zero-fills rows
// past N and features past F: those meet the operand's zero rows and must
// be finite). VEC = false (no tensor map: F % 4 != 0 or X off 16 bytes):
// every thread fills the X chunk element by element instead, in the same
// layout, read after the barriers that separate loading from use.
template <bool VEC>
__device__ __forceinline__ void load_stage(unsigned char* st, uint32_t st_s, uint32_t bar,
                                           const CUtensorMap* xmap, const float* __restrict__ X,
                                           const float* __restrict__ Wp,
                                           int64_t n, int f, int nct, int64_t row0, int c, int kc,
                                           int tid) {
  if (tid == 0) {
    mbar_expect_tx(bar, B_STAGE + (VEC ? ROWS * KCH * 4 : 0));
#pragma unroll
    for (int tile = 0; tile < PARTS * 2; ++tile)
      bulk_copy(st_s + tile * B_TILE, Wp + (((int64_t)tile * nct + c) * nct + kc) * (KCH * KCH), B_TILE, bar);
    if constexpr (VEC) tensor_copy(st_s + B_STAGE, xmap, kc * KCH, (int)row0, bar);
  }
  if constexpr (!VEC) {
#pragma unroll
    for (int it = 0; it < ROWS * 8 / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int r = e >> 3, u = e & 7;
      const int k = kc * KCH + 4 * u;
      const int64_t row = row0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < n) {
        const float* src = X + row * f;
        v.x = k + 0 < f ? src[k + 0] : 0.f;
        v.y = k + 1 < f ? src[k + 1] : 0.f;
        v.z = k + 2 < f ? src[k + 2] : 0.f;
        v.w = k + 3 < f ? src[k + 3] : 0.f;
      }
      *reinterpret_cast<float4*>(st + x_at(r, u)) = v;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
taumode_lambda_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ X,
                      const float* __restrict__ Wp, const float* __restrict__ deg,
                      const float* __restrict__ deg2,
                      const float* __restrict__ tau, float* __restrict__ lam,
                      float* __restrict__ partial, int* __restrict__ tickets, int64_t n, int f,
                      int splits, int64_t items) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1) / SMEM_ALIGN * SMEM_ALIGN);
  const int nct = padded_f(f) / KCH;             // column tiles = K-chunks
  const int cpt = (nct + splits - 1) / splits;   // column tiles per item
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);
  const uint32_t bars_s = ring_s + STAGES * STAGE_BYTES;   // stage s has landed: barrier s
  int* last_flag = reinterpret_cast<int*>(ring + STAGES * STAGE_BYTES + STAGES * 8);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int ra = wg * WG_ROWS + 16 * w + g;      // this thread's rows: ra and ra + 8
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bars_s + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The loader walks the same sequence AHEAD stages in front.
  Walk ld = {(int64_t)blockIdx.x, 0, 0, 0};
  if (ld.item < items) item_columns(ld.item, splits, cpt, nct, &ld.c, &ld.ce);
  // Every call commits one group of copies, empty past the last stage, so
  // that waiting for all but AHEAD - 1 groups always means stage `flat`.
  auto load_next = [&](int slot) {
    if (ld.item < items) {
      const int kc = (ld.c + 1 + ld.i) % nct;
      load_stage<VEC>(ring + slot * STAGE_BYTES, ring_s + slot * STAGE_BYTES, bars_s + 8 * slot, &xmap, X,
                      Wp, n, f, nct, (ld.item / splits) * ROWS, ld.c, kc, tid);
      if (++ld.i == nct) {
        ld.i = 0;
        if (++ld.c == ld.ce) {
          ld.item += gridDim.x;
          if (ld.item < items) item_columns(ld.item, splits, cpt, nct, &ld.c, &ld.ce);
        }
      }
    }
  };
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) load_next(s);

  const uint64_t desc_base = ((uint64_t)1 << 62) | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 16);
  float acc[PRODUCTS][16];
  uint32_t fr[2][4][2][4];                       // [set][power][hi, lo][a0..a3]
  int64_t flat = 0;                              // stages consumed

  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int64_t rt = item / splits;
    const int cs = (int)(item % splits);
    int cb, ce;
    item_columns(item, splits, cpt, nct, &cb, &ce);
    float sum[2][SUMS];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < SUMS; ++q) sum[h][q] = 0.f;

    for (int c = cb; c < ce; ++c) {
      // The K-loop of column tile c: chunks c+1, c+2, ..., c (mod nct).
      // Inside it the accumulators are touched by the products alone.
      for (int i = 0; i < nct; ++i, ++flat) {
        const int slot = (int)(flat % STAGES);
        mbar_wait(bars_s + 8 * slot, (uint32_t)(flat / STAGES) & 1);   // the operand tiles,
        __syncthreads();                         // everyone's units; stage flat-2's slot is read out
        load_next((int)((flat + AHEAD) % STAGES));
        const unsigned char* st = ring + slot * STAGE_BYTES;
        const uint32_t st_s = ring_s + slot * STAGE_BYTES;
        const float4 xa0 = *reinterpret_cast<const float4*>(st + x_at(ra, 2 * t));
        const float4 xa1 = *reinterpret_cast<const float4*>(st + x_at(ra, 2 * t + 1));
        const float4 xb0 = *reinterpret_cast<const float4*>(st + x_at(ra + 8, 2 * t));
        const float4 xb1 = *reinterpret_cast<const float4*>(st + x_at(ra + 8, 2 * t + 1));
        // Step s: a0/a2 = row ra, features 8t+2s, 8t+2s+1; a1/a3 = row ra+8.
        const float va[4][4] = {{xa0.x, xb0.x, xa0.y, xb0.y}, {xa0.z, xb0.z, xa0.w, xb0.w},
                                {xa1.x, xb1.x, xa1.y, xb1.y}, {xa1.z, xb1.z, xa1.w, xb1.w}};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          uint32_t(&set)[4][2][4] = fr[s & 1];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float x1 = va[s][q];
            const float x2 = __fmul_rn(x1, x1);
            split(x1, set[0][0][q], set[0][1][q]);
            split(x2, set[1][0][q], set[1][1][q]);
            split(__fmul_rn(x2, x1), set[2][0][q], set[2][1][q]);
            split(__fmul_rn(x2, x2), set[3][0][q], set[3][1][q]);
          }
          wgmma_fence();
          const int first = (i == 0 && s == 0);
#pragma unroll
          for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
            for (int p = 0; p < PRODUCTS; ++p) {
              // pass 0: hi·Bhi (overwrites on the tile's first step), 1: lo·Bhi, 2: hi·Blo
              const int tile = 2 * part_of(p) + (pass == 2 ? 1 : 0);
              const uint64_t desc =
                  desc_base | (uint64_t)(((st_s + tile * B_TILE + 32 * s) & 0x3FFFF) >> 4);
              mma_tf32(acc[p], set[pow_of(p)][pass == 1 ? 1 : 0], desc, pass == 0 ? !first : 1);
            }
          }
          wgmma_commit();
          wgmma_wait<1>();                       // the other set's products are done: it is free
        }
      }

      // Fold column tile c: its chunk is the stage just multiplied.
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < PRODUCTS; ++p)
#pragma unroll
        for (int r = 0; r < 16; ++r) keep(acc[p][r]);
      const unsigned char* st = ring + (int)((flat - 1) % STAGES) * STAGE_BYTES;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ra + 8 * h;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 xv = *reinterpret_cast<const float2*>(st + x_at(r, 2 * j + (t >> 1)) + 8 * (t & 1));
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int d = 4 * j + 2 * h + e;
            const int col = c * KCH + 8 * j + 2 * t + e;
            const float x = e ? xv.y : xv.x;
            const float x2 = x * x, x3 = x2 * x, x4 = x2 * x2;
            const float dg = col < f ? __ldg(deg + col) : 0.f, dg2 = col < f ? __ldg(deg2 + col) : 0.f;
            sum[h][0] = fmaf(x, acc[0][d], sum[h][0]);
            sum[h][1] = fmaf(x, x, sum[h][1]);
            sum[h][2] += fmaf(x2, dg, fmaf(-2.f * x, acc[1][d], acc[2][d]));
            sum[h][3] += fmaf(x4, dg2,
                              fmaf(-4.f * x3, acc[3][d],
                                   fmaf(6.f * x2, acc[4][d], fmaf(-4.f * x, acc[5][d], acc[6][d]))));
            sum[h][4] = fmaxf(sum[h][4], fabsf(x));
          }
        }
      }
    }

    // Row sums over the four lanes that share a row.
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < SUMS; ++q)
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          const float v = __shfl_xor_sync(0xffffffffu, sum[h][q], o);
          sum[h][q] = q == 4 ? fmaxf(sum[h][q], v) : sum[h][q] + v;
        }

    bool tail = true;
    if (splits > 1) {                            // partial sums out; the row tile's last item adds them
      if (t == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t row = rt * ROWS + ra + 8 * h;
          if (row < n)
#pragma unroll
            for (int q = 0; q < SUMS; ++q) partial[((int64_t)cs * n + row) * SUMS + q] = sum[h][q];
        }
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) {                            // the last item also rearms the ticket for the next launch
        const int last = atomicAdd(tickets + rt, 1) == splits - 1;
        if (last) tickets[rt] = 0;
        *last_flag = last;
      }
      __syncthreads();
      tail = *last_flag != 0;
      if (tail && t == 0) {
        __threadfence();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t row = rt * ROWS + ra + 8 * h;
          if (row >= n) continue;
#pragma unroll
          for (int q = 0; q < SUMS; ++q) sum[h][q] = 0.f;
          for (int k = 0; k < splits; ++k)
#pragma unroll
            for (int q = 0; q < SUMS; ++q) {
              const float v = __ldcg(partial + ((int64_t)k * n + row) * SUMS + q);
              sum[h][q] = q == 4 ? fmaxf(sum[h][q], v) : sum[h][q] + v;
            }
        }
      }
    }
    if (tail && t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = rt * ROWS + ra + 8 * h;
        if (row >= n) continue;
        const float nume = sum[h][0], den = sum[h][1], total = sum[h][2], num4 = sum[h][3];
        const float tv = tau[row];
        float e_raw = den > 1e-12f ? nume / fmaxf(den, 1e-12f) : 0.f;
        e_raw = fmaxf(e_raw, 0.f);
        float gq = total > 1e-12f ? num4 / fmaxf(total * total, 1e-24f) : 0.f;
        gq = fminf(fmaxf(gq, 0.f), 1.f);
        const float eb = (e_raw + tv > 0.f) ? e_raw / fmaxf(e_raw + tv, 1e-10f) : 0.f;
        const float v = tv * eb + (1.f - tv) * gq;
        lam[row] = sum[h][4] <= 1e-10f ? 0.f : v;
      }
    }
  }
}

// What the entry point chooses for a launch: 16-byte copies of X or the
// element-wise loader; the column splits (the smallest count, at most
// MAX_SPLITS and at most the column tiles, whose work items fill the SMs'
// waves to 90% or more, else the count that fills them best); the grid
// (one block per SM, fewer if there are fewer items); the dynamic shared
// memory.
struct Plan {
  int vec, splits, grid, smem;
};

inline Plan plan_of(const void* X, int64_t n, int f, int sms) {
  Plan p = {(f % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0) ? 1 : 0, 1, 0, SMEM_BYTES};
  const int nct = padded_f(f) / KCH;
  const int64_t row_tiles = (n + ROWS - 1) / ROWS;
  int64_t best_items = 0, best_waves = 1;
  for (int s = 1; s <= MAX_SPLITS && s <= nct; ++s) {
    const int cpt = (nct + s - 1) / s;
    if ((nct + cpt - 1) / cpt != s) continue;    // some item would have no columns
    const int64_t items = row_tiles * s;
    const int64_t waves = (items + sms - 1) / sms;
    if (10 * items >= 9 * waves * sms) { p.splits = s; best_items = 0; break; }
    if (items * best_waves > best_items * waves) { best_items = items; best_waves = waves; p.splits = s; }
  }
  const int64_t items = row_tiles * p.splits;
  p.grid = (int)(items < sms ? items : sms);
  return p;
}

// X [n, f] as a 2-D tensor map of 128-row × 32-feature boxes, written with
// the 128-byte swizzle, zeros outside the tensor. cuTensorMapEncodeTiled
// lives in libcuda; the runtime's entry-point query hands it over, so this
// library does not link libcuda.
cudaError_t encode_x_map(CUtensorMap* map, const float* X, int64_t n, int f) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                             const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                             CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                             CUtensorMapFloatOOBfill);
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
  if (rc != cudaSuccess) return rc;
  if (found != cudaDriverEntryPointSuccess || !fn) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)f, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)f * 4};
  const cuuint32_t box[2] = {KCH, ROWS};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = ((Encode)fn)(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)X, dims, strides, box,
                                  elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool VEC>
int launch(const float* X, const float* Wp, const float* deg, const float* deg2, const float* tau,
           float* lam, float* partial, int* tickets, int64_t n, int f, const Plan& p,
           cudaStream_t st) {
  cudaError_t rc = cudaFuncSetAttribute(taumode_lambda_kernel<VEC>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (rc != cudaSuccess) return (int)rc;
  CUtensorMap xmap;
  memset(&xmap, 0, sizeof(xmap));
  if (VEC && (rc = encode_x_map(&xmap, X, n, f)) != cudaSuccess) return (int)rc;
  const int64_t items = (n + ROWS - 1) / ROWS * p.splits;
  taumode_lambda_kernel<VEC><<<p.grid, THREADS, p.smem, st>>>(xmap, X, Wp, deg, deg2, tau, lam, partial,
                                                              tickets, n, f, p.splits, items);
  return (int)cudaGetLastError();
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)rc;
}

// ---------------------------------------------------------------------------
// The query form (mrs_taumode_query): normalised λ of a batch of queries in
// one launch.
//
// Replaces no TPU kernel: the reference computes the query λ below 32,768
// rows as XLA's closed form (matternet_rs_tpu/ops/taumode.py,
// taumode_lambdas_auto) and folds it with min and range in the search.
// As eager torch calls the same closed form is about 75 launches and two
// blocking copies of host floats, and the card waits on the host before
// every scan. This kernel does all of it for F <= 256: τ from the row's own
// values (fixed, mean, or an order statistic: median, percentile), the seven
// products, the λ tail as the kernel above and the plain version write it,
// and clamp((raw - mn) / rng, 0, 1) with mn and rng as launch arguments.
//
// Arithmetic: full f32, no TF32. Each product sums over features in
// ascending order with one FMA a feature; the fold is IEEE (div.rn), so for
// the same raw it is torch's bit for bit. No sum depends on how many rows a
// block holds.
//
// What bounds it on the H100: operations, 7·B·F² FMAs (3.5 µs at B = 1024,
// F = 128 at the f32 CUDA-core peak); the bytes (X once, L once a block)
// are far below. The work is small, so latency weighs: L's copy is in
// flight while τ is taken.
//
// Design. One thread per output column j (T threads: F rounded up to 32),
// R rows a block with their 7·R sums in registers. The block's rows of X
// sit in shared memory; L is staged in chunks of whole rows (all of it at
// F = 128) by async copies, 16 bytes each where F % 4 == 0, beside the
// chunk's powers x, x², x³, x⁴ as one float4 a row and feature, which all
// threads read at once (a broadcast). A = max(-L, 0) off the diagonal and
// A² are formed from the staged L in registers. deg and deg2 (row sums of
// A and A²) are never formed: Σ_i x_i² deg_i = Σ_j (x²A)_j and
// Σ_i x_i⁴ deg2_i = Σ_j (x⁴A²)_j, sums of products the kernel has, so
//   total = Σ_j 2 (x²A)_j - 2 x_j (xA)_j
//   num4  = Σ_j 2 (x⁴A²)_j - 4 x_j³ (xA²)_j + 6 x_j² (x²A²)_j - 4 x_j (x³A²)_j,
// the same sums of the same terms, and no pass over L's rows.
// τ: fixed is a launch argument; the mean by warp sums; an order statistic
// by rank counting: the sorted row's value at rank k is the largest value
// with at most k smaller ones (NaN, which torch.sort puts last, counts as
// larger than every number), so each thread counts the smaller values of a
// few elements of one row, one comparison each, and the qualifying
// elements meet in an atomic max of order-preserving keys. Ties give the
// value torch.sort leaves there (−0 and +0 may trade places, which the τ
// floor makes equal). Per-row sums reduce by warp shuffles, then across
// warps in a fixed order.
constexpr int Q_MAX_F = 256;
constexpr int Q_SMEM_BUDGET = 110 * 1024;      // two blocks an SM
constexpr int Q_SUMS = 5;                      // nume, den, total, num4, max|x|
constexpr int TAU_FIXED = 0, TAU_MEAN = 2;     // ops/taumode.py's modes; 1 and 3 are order statistics
constexpr float Q_TAU_FLOOR = 1e-10f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float a_of(float l, bool diag) { return diag ? 0.f : fmaxf(-l, 0.f); }
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
// Order-preserving keys of floats (NaN above +inf) and back.
__device__ __forceinline__ uint32_t key_of(float v) {
  const uint32_t u = __float_as_uint(v);
  return v != v ? 0xFFFFFFFFu : (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float of_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// Shared memory: the float4 powers [R][chunk], the L chunk [chunk][f], then
// in 4-byte words the rows [R][f], the warps' partial sums [Q_SUMS][R][T/32],
// τ [R], the keys of the selected order statistics [2][R].
inline int query_smem(int rows, int f, int threads, int chunk) {
  return 16 * rows * chunk + 4 * (chunk * f + rows * f + Q_SUMS * rows * (threads / 32) + 3 * rows);
}

// L's rows [i0, i0 + c) into lt, one run of c·f floats, by async copies.
__device__ __forceinline__ void stage_l(float* lt, const float* __restrict__ L, int f, int i0, int c, bool vec,
                                        int T, int tid) {
  const float* src = L + (int64_t)i0 * f;
  if (vec) {
    for (int e = tid; e < c * f / 4; e += T) cp_async16(lt + 4 * e, src + 4 * e);
  } else {
    for (int e = tid; e < c * f; e += T) cp_async4(lt + e, src + e);
  }
}

template <int R>
__global__ void __launch_bounds__(Q_MAX_F)
    taumode_query_kernel(const float* __restrict__ X, const float* __restrict__ L, int64_t b, int f, int chunk,
                         int vec, int mode, float tau_fixed, int k0, int k1, float mn, float rng,
                         float* __restrict__ raw, float* __restrict__ qlam) {
  extern __shared__ float4 qsm[];
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  float4* xp = qsm;
  float* lt = reinterpret_cast<float*>(xp + R * chunk);
  float* xs = lt + chunk * f;
  float* red = xs + R * f;
  float* tau_s = red + Q_SUMS * R * nw;
  uint32_t* sel = reinterpret_cast<uint32_t*>(tau_s + R);
  const int64_t r0 = (int64_t)blockIdx.x * R;

  // The first chunk of L is in flight while the rows arrive and τ is taken.
  stage_l(lt, L, f, 0, min(chunk, f), vec, T, tid);
  for (int e = tid; e < R * f; e += T) {
    const int r = e / f;
    xs[e] = r0 + r < b ? X[(r0 + r) * f + (e - r * f)] : 0.f;
  }
  if (tid < 2 * R) sel[tid] = 0u;               // below every key
  __syncthreads();

  // τ of each row, floored as select_tau floors it (a NaN stays NaN).
  if (mode == TAU_MEAN) {
    for (int r = warp; r < R; r += nw) {
      float s = 0.f;
      for (int i = lane; i < f; i += 32) s += xs[r * f + i];
      s = warp_sum(s);
      if (lane == 0) {
        const float m = s / (float)f;
        tau_s[r] = m < Q_TAU_FLOOR ? Q_TAU_FLOOR : m;
      }
    }
  } else if (mode != TAU_FIXED) {
    // Thread t counts for elements c0, c0 + tpr, ... (at most R) of row r.
    const int tpr = T / R, r = tid / tpr, c0 = tid - r * tpr;
    const float* row = xs + r * f;
    float v[R];
    int less[R];
#pragma unroll
    for (int m = 0; m < R; ++m) {
      v[m] = c0 + m * tpr < f ? row[c0 + m * tpr] : 0.f;
      less[m] = 0;
    }
    if ((f & 3) == 0) {                         // the row's start is 16-byte aligned
      const float4* row4 = reinterpret_cast<const float4*>(row);
#pragma unroll 2
      for (int i = 0; i < f / 4; ++i) {
        const float4 u = row4[i];
#pragma unroll
        for (int m = 0; m < R; ++m) less[m] += (u.x < v[m]) + (u.y < v[m]) + (u.z < v[m]) + (u.w < v[m]);
      }
    } else {
      for (int i = 0; i < f; ++i) {
        const float u = row[i];
#pragma unroll
        for (int m = 0; m < R; ++m) less[m] += u < v[m];
      }
    }
#pragma unroll
    for (int m = 0; m < R; ++m) {
      if (c0 + m * tpr >= f) continue;
      if (v[m] != v[m]) {                       // NaN: after every number
        less[m] = 0;
        for (int i = 0; i < f; ++i) less[m] += row[i] == row[i];
      }
      if (less[m] <= k0) atomicMax(sel + r, key_of(v[m]));
      if (less[m] <= k1) atomicMax(sel + R + r, key_of(v[m]));
    }
    __syncthreads();
    if (tid < R) {
      const float s0 = of_key(sel[tid]), s1 = of_key(sel[R + tid]);
      const float m = k0 == k1 ? s0 : (s0 + s1) * 0.5f;
      tau_s[tid] = m < Q_TAU_FLOOR ? Q_TAU_FLOOR : m;
    }
  } else if (tid < R) {
    tau_s[tid] = tau_fixed;
  }

  const int j = tid;
  const bool on = j < f;
  // xL, xA, x²A, xA², x²A², x³A², x⁴A² at column j.
  float acc[PRODUCTS][R];
#pragma unroll
  for (int p = 0; p < PRODUCTS; ++p)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[p][r] = 0.f;

  for (int i0 = 0; i0 < f; i0 += chunk) {
    const int c = min(chunk, f - i0);
    if (i0 > 0) stage_l(lt, L, f, i0, c, vec, T, tid);
    for (int e = tid; e < R * c; e += T) {
      const int r = e / c, ii = e - r * c;
      const float x = xs[r * f + i0 + ii], x2 = x * x;
      xp[r * chunk + ii] = make_float4(x, x2, x2 * x, x2 * x2);
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 4
    for (int ii = 0; ii < c; ++ii) {
      const float l = on ? lt[ii * f + j] : 0.f;
      const float a = a_of(l, i0 + ii == j), a2 = a * a;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 p = xp[r * chunk + ii];
        acc[0][r] = fmaf(p.x, l, acc[0][r]);
        acc[1][r] = fmaf(p.x, a, acc[1][r]);
        acc[2][r] = fmaf(p.y, a, acc[2][r]);
        acc[3][r] = fmaf(p.x, a2, acc[3][r]);
        acc[4][r] = fmaf(p.y, a2, acc[4][r]);
        acc[5][r] = fmaf(p.z, a2, acc[5][r]);
        acc[6][r] = fmaf(p.w, a2, acc[6][r]);
      }
    }
    __syncthreads();
  }

  // Column j's terms of the four sums and max|x|, then the rows' sums.
  float sums[Q_SUMS][R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float x = on ? xs[r * f + j] : 0.f, x2 = x * x, x3 = x2 * x;
    sums[0][r] = x * acc[0][r];
    sums[1][r] = x * x;
    sums[2][r] = fmaf(-2.f * x, acc[1][r], 2.f * acc[2][r]);
    sums[3][r] = fmaf(-4.f * x3, acc[3][r], fmaf(6.f * x2, acc[4][r], fmaf(-4.f * x, acc[5][r], 2.f * acc[6][r])));
    sums[4][r] = fabsf(x);
  }
#pragma unroll
  for (int q = 0; q < Q_SUMS; ++q)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float v = q == 4 ? warp_max(sums[q][r]) : warp_sum(sums[q][r]);
      if (lane == 0) red[(q * R + r) * nw + warp] = v;
    }
  __syncthreads();
  if (tid < R && r0 + tid < b) {
    float s[Q_SUMS];
#pragma unroll
    for (int q = 0; q < Q_SUMS; ++q) {
      s[q] = red[(q * R + tid) * nw];
      for (int w = 1; w < nw; ++w) {
        const float v = red[(q * R + tid) * nw + w];
        s[q] = q == 4 ? fmaxf(s[q], v) : s[q] + v;
      }
    }
    const float nume = s[0], den = s[1], total = s[2], num4 = s[3], tv = tau_s[tid];
    float e_raw = den > 1e-12f ? nume / fmaxf(den, 1e-12f) : 0.f;
    e_raw = fmaxf(e_raw, 0.f);
    float gq = total > 1e-12f ? num4 / fmaxf(total * total, 1e-24f) : 0.f;
    gq = fminf(fmaxf(gq, 0.f), 1.f);
    const float eb = (e_raw + tv > 0.f) ? e_raw / fmaxf(e_raw + tv, 1e-10f) : 0.f;
    const float v = s[4] <= 1e-10f ? 0.f : tv * eb + (1.f - tv) * gq;
    const float d = __fdiv_rn(__fsub_rn(v, mn), rng);   // torch's (raw - mn) / rng on the card
    raw[r0 + tid] = v;
    qlam[r0 + tid] = isnan(d) ? d : fminf(fmaxf(d, 0.f), 1.f);   // and its clamp(·, 0, 1)
  }
}

// What mrs_taumode_query chooses: R rows a block (the smallest of 1, 2, 4
// whose blocks fit two an SM in one wave, else 8), T threads, the chunk of
// L's rows staged at once, the shared memory, and whether L goes by 16-byte
// copies (F % 4 == 0, L on a 16-byte address).
struct QueryPlan {
  int rows, threads, chunk, smem, vec;
};

inline QueryPlan query_plan_of(const void* L, int64_t b, int f, int sms) {
  QueryPlan p;
  p.threads = (f + 31) / 32 * 32;
  p.rows = 1;
  while (p.rows < 8 && (b + p.rows - 1) / p.rows > 2 * (int64_t)sms) p.rows *= 2;
  const int fixed = query_smem(p.rows, f, p.threads, 0);
  const int per_row = query_smem(p.rows, f, p.threads, 1) - fixed;
  const int fit = (Q_SMEM_BUDGET - fixed) / per_row;
  p.chunk = fit < f ? fit : f;
  p.smem = query_smem(p.rows, f, p.threads, p.chunk);
  p.vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(L) % 16 == 0;
  return p;
}

template <int R>
int launch_query(const float* X, const float* L, int64_t b, int f, int mode, float tau_fixed, int k0, int k1,
                 float mn, float rng, float* raw, float* qlam, const QueryPlan& p, cudaStream_t st) {
  const cudaError_t rc =
      cudaFuncSetAttribute(taumode_query_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (rc != cudaSuccess) return (int)rc;
  const int64_t grid = (b + R - 1) / R;
  taumode_query_kernel<R><<<(unsigned)grid, p.threads, p.smem, st>>>(X, L, b, f, p.chunk, p.vec, mode, tau_fixed,
                                                                     k0, k1, mn, rng, raw, qlam);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mrs_cuda_strerror(int rc) { return cudaGetErrorString((cudaError_t)rc); }

// What mrs_taumode_lambda chooses for X (address), n rows and f features on
// the current device: *vec 1 for 16-byte copies, 0 for the element-wise
// loader; *splits column splits per row tile; *grid blocks; *smem dynamic
// shared memory in bytes. cudaErrorInvalidValue for f outside [1, 2048].
int mrs_taumode_plan(const void* X, int64_t n, int f, int* vec, int* splits, int* grid, int* smem) {
  if (f < 1 || f > MAX_F || n < 1) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  const Plan p = plan_of(X, n, f, sms);
  *vec = p.vec;
  *splits = p.splits;
  *grid = p.grid;
  *smem = p.smem;
  return 0;
}

// X [n, f], tau [n] float32 contiguous; Wp [3, 2, Fp, Fp] the prepared B
// operand (Fp = f rounded up to 32; see the header); deg/deg2 [f] → lam [n].
// `splits` must be what mrs_taumode_plan chooses; for splits > 1, partial
// holds splits·n·5 floats and tickets one zeroed int per 128-row tile (zeroed
// again by the launch, so the same scratch serves the next one).
// Launches on `stream`, does not synchronise; returns cudaGetLastError().
int mrs_taumode_lambda(const float* X, const float* Wp, const float* deg, const float* deg2,
                       const float* tau, float* lam, float* partial, int* tickets, int64_t n,
                       int f, int splits, void* stream) {
  if (f < 1 || f > MAX_F || n < 1) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  const Plan p = plan_of(X, n, f, sms);
  if (p.splits != splits || (splits > 1 && (!partial || !tickets)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return p.vec ? launch<true>(X, Wp, deg, deg2, tau, lam, partial, tickets, n, f, p, st)
               : launch<false>(X, Wp, deg, deg2, tau, lam, partial, tickets, n, f, p, st);
}

// What mrs_taumode_query chooses for b rows of f features: *rows rows a
// block, *threads, *chunk rows of L staged at once, *smem bytes.
// cudaErrorInvalidValue for f outside [1, 256] or b < 1.
int mrs_taumode_query_plan(int64_t b, int f, int* rows, int* threads, int* chunk, int* smem) {
  if (f < 1 || f > Q_MAX_F || b < 1) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  const QueryPlan p = query_plan_of(nullptr, b, f, sms);
  *rows = p.rows;
  *threads = p.threads;
  *chunk = p.chunk;
  *smem = p.smem;
  return 0;
}

// X [b, f], L [f, f] float32 contiguous → raw [b] (λ) and qlam [b]
// (clamp((raw - mn) / rng, 0, 1)). mode: 0 τ = tau_fixed; 2 the row's mean;
// 1 or 3 the sorted row's value at rank k0, or the mean of those at k0 and
// k1 when they differ; τ floored at 1e-10 except when fixed. Launches on
// `stream`, does not synchronise; returns cudaGetLastError().
int mrs_taumode_query(const float* X, const float* L, int64_t b, int f, int mode, float tau_fixed, int k0,
                      int k1, float mn, float rng, float* raw, float* qlam, void* stream) {
  if (f < 1 || f > Q_MAX_F || b < 1 || mode < 0 || mode > 3 || k0 < 0 || k1 < k0 || k1 >= f)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  const QueryPlan p = query_plan_of(L, b, f, sms);
  cudaStream_t st = (cudaStream_t)stream;
  switch (p.rows) {
    case 1: return launch_query<1>(X, L, b, f, mode, tau_fixed, k0, k1, mn, rng, raw, qlam, p, st);
    case 2: return launch_query<2>(X, L, b, f, mode, tau_fixed, k0, k1, mn, rng, raw, qlam, p, st);
    case 4: return launch_query<4>(X, L, b, f, mode, tau_fixed, k0, k1, mn, rng, raw, qlam, p, st);
    default: return launch_query<8>(X, L, b, f, mode, tau_fixed, k0, k1, mn, rng, raw, qlam, p, st);
  }
}

}  // extern "C"
