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
// That is seven [T,F]x[F,F] products per row tile, 7·2·N·F² flops.
//
// What bounds it on the H100: operations. At F = 128 it does 14·F = 1792
// flops per byte of X read, far above the f32 FFMA ridge (67 TFLOP/s over
// 3.35 TB/s = 20 flops/byte), so the FMA rate is the limit.
//
// Design. The TPU kernel kept L, A and A² all resident; at F = 128 those
// three f32 operands alone are 192 KB of the 227 KB a block may use, so
// this follows the F-tiled _kernel_bigf layout instead:
//   * a block owns ROWS rows of X, kept in shared memory for the whole run;
//   * it walks the output-feature columns in tiles of COLS, and for each
//     tile streams L through shared memory in K-row chunks; A and A² are
//     formed on the fly from the L element, so only L is read from memory;
//   * x², x³, x⁴ are formed in registers from the resident x;
//   * each thread keeps RM rows × RN columns × 7 accumulators in registers
//     and folds each finished column tile into four per-row sums (nume,
//     total, num4, den); the 32 lanes of a warp share their rows, so one
//     warp reduction gives the row sums and the λ tail runs once per row.
// Exact f32 FFMA throughout; tensor cores are for a later version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 16;               // rows of X per block
constexpr int COLS = 64;               // output columns per column tile
constexpr int KCH = 32;                // rows of L per shared-memory chunk
constexpr int RM = 4;                  // rows per thread
constexpr int RN = COLS / 32;          // columns per thread (lane, lane+32)
constexpr int THREADS = (ROWS / RM) * 32;   // one warp per row group

__global__ void __launch_bounds__(THREADS)
taumode_lambda_kernel(const float* __restrict__ X, const float* __restrict__ L,
                      const float* __restrict__ deg, const float* __restrict__ deg2,
                      const float* __restrict__ tau, float* __restrict__ lam,
                      int64_t n, int f) {
  extern __shared__ float smem[];
  float* xs = smem;                    // [ROWS][f]
  float* ls = smem + ROWS * f;         // [KCH][COLS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rg = tid >> 5;             // row group: rows rg*RM .. rg*RM+RM-1
  const int64_t row0 = (int64_t)blockIdx.x * ROWS;

  for (int e = tid; e < ROWS * f; e += THREADS) {
    const int r = e / f;
    const int64_t gr = row0 + r;
    xs[e] = gr < n ? X[gr * f + (e - r * f)] : 0.f;
  }
  __syncthreads();

  float s_nume[RM], s_total[RM], s_num4[RM], s_den[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) s_nume[r] = s_total[r] = s_num4[r] = s_den[r] = 0.f;

  const float* xrow = xs + (rg * RM) * f;

  for (int c0 = 0; c0 < f; c0 += COLS) {
    float xl[RM][RN], b1[RM][RN], b2[RM][RN], c1[RM][RN], c2[RM][RN],
        c3[RM][RN], c4[RM][RN];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int q = 0; q < RN; ++q)
        xl[r][q] = b1[r][q] = b2[r][q] = c1[r][q] = c2[r][q] = c3[r][q] = c4[r][q] = 0.f;

    for (int k0 = 0; k0 < f; k0 += KCH) {
      for (int e = tid; e < KCH * COLS; e += THREADS) {
        const int kk = e / COLS, cc = e - kk * COLS;
        const int gk = k0 + kk, gc = c0 + cc;
        ls[e] = (gk < f && gc < f) ? L[(int64_t)gk * f + gc] : 0.f;
      }
      __syncthreads();
      const int kmax = min(KCH, f - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        const int j = k0 + kk;
        float lv[RN], av[RN], a2v[RN];
#pragma unroll
        for (int q = 0; q < RN; ++q) {
          lv[q] = ls[kk * COLS + lane + 32 * q];
          const float a = (j == c0 + lane + 32 * q) ? 0.f : fmaxf(-lv[q], 0.f);
          av[q] = a;
          a2v[q] = a * a;
        }
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float x = xrow[r * f + j];
          const float x2 = x * x, x3 = x2 * x, x4 = x2 * x2;
#pragma unroll
          for (int q = 0; q < RN; ++q) {
            xl[r][q] = fmaf(x, lv[q], xl[r][q]);
            b1[r][q] = fmaf(x, av[q], b1[r][q]);
            b2[r][q] = fmaf(x2, av[q], b2[r][q]);
            c1[r][q] = fmaf(x, a2v[q], c1[r][q]);
            c2[r][q] = fmaf(x2, a2v[q], c2[r][q]);
            c3[r][q] = fmaf(x3, a2v[q], c3[r][q]);
            c4[r][q] = fmaf(x4, a2v[q], c4[r][q]);
          }
        }
      }
      __syncthreads();
    }

    // Fold this column tile into the per-row sums.
#pragma unroll
    for (int q = 0; q < RN; ++q) {
      const int col = c0 + lane + 32 * q;
      if (col >= f) continue;
      const float d = deg[col], d2 = deg2[col];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float xi = xrow[r * f + col];
        const float xi2 = xi * xi;
        s_nume[r] += xi * xl[r][q];
        s_den[r] += xi2;
        s_total[r] += xi2 * d - 2.f * xi * b1[r][q] + b2[r][q];
        s_num4[r] += xi2 * xi2 * d2 - 4.f * (xi2 * xi) * c1[r][q] +
                     6.f * xi2 * c2[r][q] - 4.f * xi * c3[r][q] + c4[r][q];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    float amax = 0.f;
    for (int c = lane; c < f; c += 32) amax = fmaxf(amax, fabsf(xrow[r * f + c]));
    float nume = s_nume[r], den = s_den[r], total = s_total[r], num4 = s_num4[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      nume += __shfl_xor_sync(0xffffffffu, nume, o);
      den += __shfl_xor_sync(0xffffffffu, den, o);
      total += __shfl_xor_sync(0xffffffffu, total, o);
      num4 += __shfl_xor_sync(0xffffffffu, num4, o);
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    }
    const int64_t gr = row0 + rg * RM + r;
    if (lane == 0 && gr < n) {
      const float t = tau[gr];
      float e_raw = den > 1e-12f ? nume / fmaxf(den, 1e-12f) : 0.f;
      e_raw = fmaxf(e_raw, 0.f);
      float g = total > 1e-12f ? num4 / fmaxf(total * total, 1e-24f) : 0.f;
      g = fminf(fmaxf(g, 0.f), 1.f);
      const float eb = (e_raw + t > 0.f) ? e_raw / fmaxf(e_raw + t, 1e-10f) : 0.f;
      const float v = t * eb + (1.f - t) * g;
      lam[gr] = amax <= 1e-10f ? 0.f : v;
    }
  }
}

}  // namespace

extern "C" {

const char* mrs_cuda_strerror(int rc) { return cudaGetErrorString((cudaError_t)rc); }

// X [n, f], L [f, f], deg/deg2 [f], tau [n] → lam [n]; all float32,
// contiguous, on the current device. Launches on `stream`, does not
// synchronise. Returns cudaGetLastError() after the launch.
int mrs_taumode_lambda(const float* X, const float* L, const float* deg,
                       const float* deg2, const float* tau, float* lam,
                       int64_t n, int f, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)ROWS * f + KCH * COLS);
  cudaError_t err = cudaFuncSetAttribute(
      taumode_lambda_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (n + ROWS - 1) / ROWS;
  taumode_lambda_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      X, L, deg, deg2, tau, lam, n, f);
  return (int)cudaGetLastError();
}

}  // extern "C"
