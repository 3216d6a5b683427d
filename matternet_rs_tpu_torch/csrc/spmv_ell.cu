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
//   What bounds it on the H100: bytes. idx and w are read once (n·k·8),
//   X once (n·m·4; a neighbour's row is read again by every row that names
//   it, which hits L2 while X fits its 50 MB) and out is written once
//   (n·m·4). At n = 16384, k = 12, m = 15 that is 3.5 MB — about 1 µs at
//   3.35 TB/s, far below the cost of a launch, so at the LOBPCG shape the
//   launch itself is what one pays.
//
//   Design. One warp per output row. The row's slots are read 32 at a
//   time, one slot per lane (coalesced), and broadcast by shuffle; lanes
//   cover the m columns in strides of 32 and keep up to 8 partial sums
//   each (256 columns per pass; a wider X takes another pass). A slot with
//   w == 0 is skipped before X is touched: empty slots carry index −1, and
//   0·inf must not enter the sum. A live slot whose index lies outside
//   [0, n) is never dereferenced either: it makes the row NaN (the wrapper
//   rejects such a graph on the host before any launch). Slots are summed
//   in ascending s with a rounded multiply and a rounded add (no
//   contraction), so the result equals the plain version's slot-by-slot
//   accumulation bit for bit. The TPU's pads (n to 256, k and m to 128)
//   were Mosaic tiling rules and do not carry over: any n, k, m ≥ 1.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;      // 8 warps = 8 rows per block
constexpr int CPT = 8;            // columns per lane per pass (32·8 = 256)

__global__ void __launch_bounds__(THREADS)
spmv_ell_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                const float* __restrict__ X, const float* __restrict__ d,
                float* __restrict__ out, int64_t n, int k, int m) {
  const int64_t row = (int64_t)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (row >= n) return;                         // warp-uniform
  const int lane = threadIdx.x & 31;
  const int* ri = idx + row * k;
  const float* rw = w + row * k;

  for (int c0 = 0; c0 < m; c0 += 32 * CPT) {
    float acc[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[c] = 0.f;
    for (int s0 = 0; s0 < k; s0 += 32) {
      const int s = s0 + lane;
      const float wl = s < k ? rw[s] : 0.f;
      const int il = s < k ? ri[s] : 0;
      const int cnt = min(32, k - s0);
      for (int t = 0; t < cnt; ++t) {
        const float ws = __shfl_sync(0xffffffffu, wl, t);
        const int js = __shfl_sync(0xffffffffu, il, t);
        if (ws == 0.f) continue;                // warp-uniform: X untouched
        const bool inside = js >= 0 && (int64_t)js < n;
        const float* xr = X + (int64_t)(inside ? js : 0) * m;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int col = c0 + c * 32 + lane;
          if (col < m) {
            const float xv = inside ? xr[col] : NAN;
            acc[c] = __fadd_rn(acc[c], __fmul_rn(ws, xv));
          }
        }
      }
    }
    const float dv = d != nullptr ? d[row] : 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = c0 + c * 32 + lane;
      if (col < m) {
        const int64_t o = row * m + col;
        out[o] = d != nullptr ? __fsub_rn(__fmul_rn(dv, X[o]), acc[c]) : acc[c];
      }
    }
  }
}

}  // namespace

extern "C" {

const char* mrs_cuda_strerror(int rc) { return cudaGetErrorString((cudaError_t)rc); }

// idx [n, k] int32, w [n, k], X [n, m], d [n] or null → out [n, m]; float32,
// contiguous; out must not alias X. Returns cudaGetLastError().
int mrs_spmv_ell(const int* idx, const float* w, const float* X, const float* d,
                 float* out, int64_t n, int k, int m, void* stream) {
  if (n <= 0 || k <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + (THREADS / 32) - 1) / (THREADS / 32);
  spmv_ell_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      idx, w, X, d, out, n, k, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
