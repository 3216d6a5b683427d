// Kernel F: ELL sparse product for a skinny right-hand side.
//
// Replaces the TPU kernel matternet_rs_tpu/ops/pallas/spmv_ell.py
// `spmv_ell_pallas` (_kernel) and its wrapper `laplacian_spmv_ell_pallas`:
//
//   out[i, :] = Σ_{s<k} w[i, s] · X[idx[i, s], :]            (d == nullptr)
//   out[i, :] = d[i] · X[i, :] − Σ_{s<k} w[i, s] · X[idx[i, s], :]
//
// for idx [n, k] int32, w [n, k] f32, X [n, m] f32, d [n] f32. The second
// form is the Laplacian applied to a block of vectors (d = row degrees, or
// the stored diagonal of L_sym); LOBPCG calls it once per iteration with
// m = 3·(eigenpairs wanted).
//
// mrs_spmv_ell computes rows row0 .. row0 + n − 1 of an operator that may
// be taller than the rows given: X is [nx, m], the slots name rows of X in
// [0, nx), and the diagonal term reads X[row0 + i, :]. A mesh slot applies
// its rows of the sharded Laplacian to the whole replicated block this way
// (parallel/knn_graph.py); the square product is nx = n, row0 = 0.
//
//   What bounds it on the H100: bytes, and at the LOBPCG shape the latency
//   of dependent loads. idx and w are read once (n·k·8), X once (n·m·4; a
//   neighbour's row is read again by every row that names it, which hits
//   L2 while X fits its 50 MB) and out is written once (n·m·4). At n =
//   16384, k = 14, m = 15 that is 3.5 MB — about 1 µs at 3.35 TB/s. The
//   first design (one warp a row, the slots one after another, each X load
//   waiting on its slot's shuffles and branch) paid about k memory
//   latencies a row end to end, two waves deep: 0.0206 ms against an empty
//   kernel's 0.0049 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py). The
//   launch was not what it paid for; the serial chain was.
//
//   Design. Each output row belongs to a group of G lanes, G the smallest
//   power of two ≥ min(m, 32), so a warp takes 32/G rows (one lane a row at
//   m = 1, two rows a warp at m = 15). A lane covers column g of its group
//   (m ≤ 32) or CPT columns in strides of 32 (G = 32, m > 32; 32·CPT
//   columns a pass, CPT ≤ 8, a wider X takes further passes).
//   * The slots go in chunks of SLOTS (compile time): the group reads the
//     chunk's idx and w once, coalesced, one slot a lane, and shares them
//     by shuffle; then every lane starts the X loads of the whole chunk,
//     predicated on w != 0, with no branch between them, and only then
//     adds. So a chunk costs one latency for its slots and one for its X
//     rows, not one a slot.
//   * A slot's liveness is kept as one bit and its weight shuffled again at
//     the add rather than held: 36 registers instead of 56 at m = 15, so 14
//     blocks an SM instead of 9, and the 2,048 blocks of n = 16384 nearly
//     fit one wave.
//   * A slot with w == 0 never touches X (empty slots carry index −1, and
//     0·inf must not enter the sum) and is skipped by a select on the
//     accumulator. A live slot whose index lies outside [0, nx) is never
//     dereferenced either: it makes the row NaN (the wrapper rejects such a
//     graph on the host before any launch).
//   * The adds run in ascending s with a rounded multiply and a rounded add
//     (no contraction), so the result equals the plain version's
//     slot-by-slot accumulation bit for bit.
//   The TPU's pads (n to 256, k and m to 128) were Mosaic tiling rules and
//   do not carry over: any n, k, m ≥ 1. mrs_spmv_ell_plan reports the
//   choice (G, CPT, rows a block, blocks, passes);
//   ops/kernels/spmv_ell.spmv_ell_plan mirrors it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;      // 4 warps a block
constexpr int MAX_CPT = 8;        // columns a lane takes per pass, at most (32·8 = 256)

// Slots whose X loads are in flight together: SLOTS·CPT values a lane.
template <int CPT>
struct Chunk {
  static constexpr int SLOTS = CPT == 1 ? 16 : CPT == 2 ? 8 : 4;
};

struct Plan {
  int group, cpt, rows_per_block, passes;
  int64_t blocks;
};

Plan plan_of(int64_t n, int m) {
  Plan p;
  p.group = 1;
  while (p.group < m && p.group < 32) p.group *= 2;
  p.cpt = 1;
  while (p.group * p.cpt < m && p.cpt < MAX_CPT) p.cpt *= 2;
  p.passes = (m + p.group * p.cpt - 1) / (p.group * p.cpt);
  p.rows_per_block = THREADS / p.group;
  p.blocks = (n + p.rows_per_block - 1) / p.rows_per_block;
  return p;
}

template <int G, int CPT>
__global__ void __launch_bounds__(THREADS)
spmv_ell_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                const float* __restrict__ X, const float* __restrict__ d,
                float* __restrict__ out, int64_t n, int k, int m, int64_t nx, int64_t row0) {
  constexpr int S = Chunk<CPT>::SLOTS;
  constexpr int PER = S > G ? S / G : 1;        // slots each lane of the group reads per chunk
  const int g = threadIdx.x & (G - 1);          // this lane's place in its group
  const int64_t row = ((int64_t)blockIdx.x * THREADS + threadIdx.x) / G;
  // Every lane stays to the end: the shuffles take the whole warp.
  const bool on = row < n;
  const int* ri = idx + (on ? row : 0) * k;
  const float* rw = w + (on ? row : 0) * k;

  for (int c0 = 0; c0 < m; c0 += G * CPT) {
    float acc[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[c] = 0.f;
    for (int s0 = 0; s0 < k; s0 += S) {
      // The chunk's slots: slot s0 + g + p·G is read by lane g, in register p.
      float wl[PER];
      int il[PER];
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int t = g + p * G;
        const bool has = on && t < S && s0 + t < k;
        wl[p] = has ? __ldg(rw + s0 + t) : 0.f;
        il[p] = has ? __ldg(ri + s0 + t) : 0;
      }
      // Every X load of the chunk before any add; a slot's liveness is kept
      // as one bit, its weight shuffled again at the add.
      float xv[S][CPT];
      unsigned live_bits = 0;
#pragma unroll
      for (int t = 0; t < S; ++t) {
        const float wt = G == 1 ? wl[t] : __shfl_sync(0xffffffffu, wl[t / G], t % G, G);
        const int jt = G == 1 ? il[t] : __shfl_sync(0xffffffffu, il[t / G], t % G, G);
        const bool live = wt != 0.f;
        live_bits |= (unsigned)live << t;
        const bool inside = jt >= 0 && (int64_t)jt < nx;
        const float* xr = X + (int64_t)(inside ? jt : 0) * m;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int col = c0 + c * G + g;
          xv[t][c] = live && col < m ? (inside ? __ldg(xr + col) : NAN) : 0.f;
        }
      }
#pragma unroll
      for (int t = 0; t < S; ++t) {
        float wt = G == 1 ? wl[t] : __shfl_sync(0xffffffffu, wl[t / G], t % G, G);
        asm volatile("" : "+f"(wt));            // not the first shuffle's value kept live
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float sum = __fadd_rn(acc[c], __fmul_rn(wt, xv[t][c]));
          acc[c] = (live_bits >> t) & 1u ? sum : acc[c];
        }
      }
    }
    if (on) {
      const float dv = d != nullptr ? d[row] : 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = c0 + c * G + g;
        if (col < m) {
          const int64_t o = row * m + col;
          out[o] = d != nullptr ? __fsub_rn(__fmul_rn(dv, X[(row0 + row) * m + col]), acc[c])
                                : acc[c];
        }
      }
    }
  }
}

template <int G, int CPT>
int launch(const Plan& p, const int* idx, const float* w, const float* X, const float* d,
           float* out, int64_t n, int k, int m, int64_t nx, int64_t row0, cudaStream_t st) {
  spmv_ell_kernel<G, CPT><<<(unsigned)p.blocks, THREADS, 0, st>>>(idx, w, X, d, out, n, k, m,
                                                                  nx, row0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mrs_cuda_strerror(int rc) { return cudaGetErrorString((cudaError_t)rc); }

// What mrs_spmv_ell chooses for n rows and m columns: *group lanes a row,
// *cpt columns a lane takes per pass, *rows_per_block, *blocks, *passes.
int mrs_spmv_ell_plan(int64_t n, int k, int m, int* group, int* cpt, int* rows_per_block,
                      int64_t* blocks, int* passes) {
  if (n <= 0 || k <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(n, m);
  *group = p.group;
  *cpt = p.cpt;
  *rows_per_block = p.rows_per_block;
  *blocks = p.blocks;
  *passes = p.passes;
  return 0;
}

// idx [n, k] int32, w [n, k], X [nx, m], d [n] or null → out [n, m], rows
// row0 .. row0 + n − 1 of the operator (row0 + n ≤ nx); float32,
// contiguous; out must not alias X. Returns cudaGetLastError().
int mrs_spmv_ell(const int* idx, const float* w, const float* X, const float* d,
                 float* out, int64_t n, int k, int m, int64_t nx, int64_t row0,
                 void* stream) {
  if (n <= 0 || k <= 0 || m <= 0 || row0 < 0 || row0 + n > nx) return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(n, m);
  cudaStream_t st = (cudaStream_t)stream;
  switch (p.group * 16 + p.cpt) {
    case 1 * 16 + 1: return launch<1, 1>(p, idx, w, X, d, out, n, k, m, nx, row0, st);
    case 2 * 16 + 1: return launch<2, 1>(p, idx, w, X, d, out, n, k, m, nx, row0, st);
    case 4 * 16 + 1: return launch<4, 1>(p, idx, w, X, d, out, n, k, m, nx, row0, st);
    case 8 * 16 + 1: return launch<8, 1>(p, idx, w, X, d, out, n, k, m, nx, row0, st);
    case 16 * 16 + 1: return launch<16, 1>(p, idx, w, X, d, out, n, k, m, nx, row0, st);
    case 32 * 16 + 1: return launch<32, 1>(p, idx, w, X, d, out, n, k, m, nx, row0, st);
    case 32 * 16 + 2: return launch<32, 2>(p, idx, w, X, d, out, n, k, m, nx, row0, st);
    case 32 * 16 + 4: return launch<32, 4>(p, idx, w, X, d, out, n, k, m, nx, row0, st);
    case 32 * 16 + 8: return launch<32, 8>(p, idx, w, X, d, out, n, k, m, nx, row0, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
