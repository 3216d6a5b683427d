// The energy full scan over λ windows: the answer of energy_scan + G's merge
// (csrc/search_fused.cu), bit for bit, with the dots taken only where the
// answer can read them.
//
// The score (energymaps' full scan, every step rounded, nothing contracted):
//
//   d = |qλ_b − λ_j|;   s = d + (1 − cos)·1e-9 where d < 1e-9, else s = d,
//   cos = (Q_b·X_j) / (‖Q_b‖·‖X_j‖ + 1e-9),
//
// and per query the k ≤ 16 least s, lowest id first among equal ones.
//
//   Why most dots can be skipped. The dot counts only inside the tie band
//   d < 1e-9. On an index whose λ take a few hundred values (energymaps:
//   every item carries its sub-centroid's λ) the band of a query is its λ
//   group, a few hundred thousand of 1M rows, and a batch's queries fall
//   into a handful of groups; energy_scan takes all B·N dots.
//
//   Exactness. Let the index's λ be sorted ascending (positions p, the
//   stable torch.sort of DeviceSortedLambdas, NaN last) and
//   d(p) = fabsf(__fsub_rn(qλ, λ_p)). Rounding is monotone and odd, so d is
//   non-increasing while λ_p ≤ qλ and non-decreasing after: for any T the
//   positions with d ≤ T (or d < T) are one run, and the band is one run
//   [lo, hi), the first positions where these predicates hold:
//     lo: λ_p is NaN, or λ_p ≥ qλ, or d(p) < 1e-9,
//     hi: λ_p is NaN, or λ_p > qλ and not d(p) < 1e-9,
//   each false then true along the sorted λ. A row outside the band scores
//   exactly s = d. Both routes keep, of every row whose score is not NaN,
//   the k first under (−s descending, id ascending), a total order, so the
//   answer is the k first of any set of rows that holds them. Take the
//   band's rows, scored as energy_scan scores them (the same FFMA chain:
//   one fmaf per feature, ascending, from 0; the same rounded epilogue), and
//   keep their k first; let θ be the k-th (−inf while fewer than k are
//   held). Then walk out of the band on each side, in order of position,
//   adding each row that ranks before θ (θ rises as rows join). A side
//   stops at a row with −d < θ: every row beyond it has d at least as
//   large, ranks after θ, and θ only rises, so none of them is in the
//   answer; a row with −d = θ may still enter by a lower id, so the walk
//   goes on through a run of equal d (distinct λ can round to one d, their
//   ids in any order). Every row of the answer is thus in the band or on a
//   walk, and every row is taken once: the result is the full scan's for
//   every input. A NaN qλ scores no row on either route; NaN λ sit last,
//   where both searches stop and the right walk ends. With at least k band
//   rows θ is the band's k-th best and the walks take exactly the rows with
//   d ≤ its s; with fewer, they walk out by d until k rows are held and the
//   next d exceeds the k-th.
//
//   What bounds it on the H100: a wide tile (64 query slots × 256 rows) is
//   bound by FFMA issue (csrc/f32_tile_product.cuh: 64 × 256 dots a tile
//   whatever the band's queries, an epilogue that costs about as much as the
//   product); a narrow tile (W query slots) by the bytes of the band's rows,
//   each read once. Bands hold few queries where λ take many values (the
//   1536-wide JL index: ≈ 170 bands a batch of 256, 1–5 queries each, where
//   64-slot tiles were 97.6% empty); one band holds most of a batch where
//   they take few (blobs5: ≈ 110 queries on one band of 458,630 rows).
//
//   Design. Four launches on one stream, no host read between them.
//   (1) energy_window_plan_kernel, one block of 1024 threads (≤ 1024
//   queries a launch): each query's [lo, hi) (a 1024-entry sample of the
//   sorted λ in shared memory, then steps that read seven positions at
//   once, an eighth of the range a round trip), then a bitonic sort of the
//   queries by (lo, hi), so that one band's queries sit together. A band of
//   at most NARROW_W queries is one narrow group; a larger band is cut into
//   wide groups of up to 64 queries, each taking the band's rows. Where
//   bands are many and overlap (each query its own wide band), consecutive
//   64s of the sorted queries take the union of their bands instead, all
//   wide, at most ⌈B/64⌉ passes over N as energy_scan; the plan takes the
//   cut with fewer tiles. The wide groups' 256-row tiles, end to end, are
//   cut into one even range a block of (2)'s wave (two blocks an SM), and
//   the narrow groups' tiles into one even range a block of (3)'s (one
//   block an SM): a wide and a narrow tile cost differently, so each launch
//   balances its own. Measured on the H100 and left out: ranges cut by a
//   tile's cost (two blocks of one-query groups then share an SM and each
//   runs half as fast), and items claimed from a counter (a band's groups
//   then no longer read its rows together, and one λ for all took 5.0 ms
//   against 3.0).
//   (2) energy_window_kernel, the wide groups: each block takes its range
//   group by group (a segment); for a segment it brings the group's query
//   rows and, one tile ahead, each tile's items, λ and norms (through the
//   sorted ids) into shared memory, asks L2 for the first 512 bytes of the
//   next tile's rows, and runs the tile product through row lists
//   (tile_product_rows). The epilogue (score_tile) is energy_scan's (d,
//   div_rn with its slow path, the rounded steps) on the band's pairs only,
//   keeping each query's best 16 of −s with the item id by the same ballot
//   insertion. Two filters, both exact, spare it: while a query's list is
//   not full, the k-th largest of the lanes' best scores bounds the tile's
//   k-th best from below and nothing under it is tried; once it is full, a
//   pair can rank before θ only if fl(dot/den) reaches 1 + θ/1e-9 (with
//   d ≥ 0: s ≥ fl(fl(1 − c)·ε), each step monotone), so a tile whose band
//   dots all lie under (1 + θ·1e9 − 1e-5 − 1e-6·|θ·1e9|)·den is passed over
//   for the query — the margin exceeds the rounding of both sides (about
//   9u·(1 + |θ·1e9|), u = 2⁻²⁴) wherever a cosine is near the bound, and a
//   NaN or an infinity on either side fails the test, so the exact epilogue
//   runs. Each query's first k go to its slot (one slot per block that took
//   a range of the group).
//   (3) energy_window_narrow_kernel, the narrow groups: 256 threads, one
//   block an SM. Its W = NARROW_W queries' dots over a 256-row tile are
//   W/2 queries × 2 rows a thread, the same FFMA chain as the wide tile's
//   (one fmaf a feature, ascending, from 0). The segment's rows stream
//   through a ring of N_STAGES 32-feature chunks by 16-byte cp.async, the
//   loads N_STAGES − 1 chunks ahead of the product and across tile edges
//   (≈ 100 KB in flight an SM, where ≈ 25 KB cover the latency at 3.35
//   TB/s), the tiles' items read N_STAGES − 1 chunks ahead of their first
//   load; the dots go to a tile of their own in shared memory, so the
//   epilogue (score_tile, one warp a query) runs while the next chunks land.
//   The queries come with each chunk (W × 128 bytes beside the rows'
//   32 KB), not resident: F has no bound here. A chunk's product (W/2 × 2
//   × 32 FFMAs and 48 shared reads a thread) issues in about a third of
//   the time its 33 KB take to arrive, so the rows' bytes bound the tile.
//   Why W = 8 (measured on the H100, the 1536-wide JL cell's λ layout,
//   B = 256): W = 4 1.69 ms a batch (its bands of 5–8 queries go to
//   64-slot tiles), W = 8 1.53, W = 16 1.93 (twice the product of mostly
//   empty slots), against 3.83 without narrow tiles; on blobs5's layout
//   the four lie within 3% of each other. Also measured and left out: 3 or
//   5 chunks in the ring, and an L2::256B prefetch hint on the rows'
//   copies, each within 2%.
//   (4) energy_window_walk_kernel, a warp a query: the k first of its
//   slots' lists, then the two walks, 32 rows a step on each side in turn,
//   the list in registers (lane e < k holds entry e).
//   A tally on the card counts band pairs, dot pairs taken (query slots ×
//   rows of every tile, either width), queries whose walk took a row, rows
//   the walks read and the dot pairs of narrow tiles; the search never
//   reads it. WINDOW_NARROW_W=0 at compile time builds the design without
//   narrow groups, for timing one against the other.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "div_rn.cuh"
#include "f32_tile_product.cuh"

namespace {

constexpr int BM = f32tile::BM;              // queries per tile
constexpr int BN = f32tile::BN;              // corpus rows per tile
constexpr int THREADS = f32tile::THREADS;
constexpr int SMEM_BYTES = f32tile::SMEM_BYTES;
constexpr int QW = BM / (THREADS / 32);      // queries a warp keeps lists for
constexpr int KP = 16;                       // list width
constexpr float TIE_EPS = 1e-9f;
constexpr int EMPTY_ID = 0x7fffffff;
constexpr int QMAX = 1024;                   // queries a plan takes: one block sorts them
constexpr int WALK_WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NO_BAND = ~0ull;

#ifndef WINDOW_NARROW_W
#define WINDOW_NARROW_W 8
#endif
constexpr int NARROW_W = WINDOW_NARROW_W;    // a band of at most this many queries is narrow
static_assert(NARROW_W == 0 || (NARROW_W % 2 == 0 && NARROW_W <= 16),
              "a narrow tile holds an even number of queries, at most 16 (two a warp)");
constexpr int N_THREADS = 256;               // the narrow kernel's block, one an SM
constexpr int N_STAGES = 4;                  // K-chunks in its ring
constexpr int N_AHEAD = N_STAGES - 1;        // chunks loading while one is multiplied
constexpr int N_ROWBUF = N_AHEAD + 2;        // tiles whose items it holds at once

// The plan's workspace (int64): per query (index in the launch), per
// group, and the control words.
enum : int {
  W_LO = 0, W_HI = QMAX, W_SLOTS = 2 * QMAX, W_ORDER = 3 * QMAX,
  G_LO = 4 * QMAX, G_HI = 5 * QMAX, G_NQ = 6 * QMAX, G_FIRST = 7 * QMAX,
  G_PREFIX = 8 * QMAX, G_BFIRST = 9 * QMAX, CTRL = 10 * QMAX, WS_LEN = 10 * QMAX + 8
};
// Wide groups are numbered 0 .. C_GROUPS − 1, narrow ones C_GROUPS ..
// C_GROUPS + C_NGROUPS − 1; each kind's tiles and blocks are its launch's.
enum : int { C_GROUPS = 0, C_TILES = 1, C_BLOCKS = 2, C_NGROUPS = 3, C_NTILES = 4, C_NBLOCKS = 5 };
// The tally's words.
enum : int { T_BAND_PAIRS = 0, T_DOT_PAIRS = 1, T_PAST_BAND = 2, T_WALKED = 3, T_NARROW_PAIRS = 4 };

__device__ __forceinline__ float lam_dist(float ql, float l) { return fabsf(__fsub_rn(ql, l)); }

// Does (s, id) rank before (v, vid) under (score descending, id ascending)?
__device__ __forceinline__ bool before(float s, int id, float v, int vid) {
  return s > v || (s == v && id < vid);
}

// Insert (s, id) into the sorted list lv/li in shared memory (lane l < KP
// reads and writes entry l); warp-synchronous, as search_fused.cu's.
__device__ __forceinline__ void insert(float* lv, int* li, float s, int id, int lane) {
  const float v = lane < KP ? lv[lane] : -INFINITY;
  const int vi = lane < KP ? li[lane] : EMPTY_ID;
  const unsigned ahead = __ballot_sync(FULL, lane < KP && before(v, vi, s, id));
  const int pos = __popc(ahead);
  const float uv = __shfl_up_sync(FULL, v, 1);
  const int ui = __shfl_up_sync(FULL, vi, 1);
  if (lane < KP) {
    if (lane == pos) { lv[lane] = s; li[lane] = id; }
    else if (lane > pos) { lv[lane] = uv; li[lane] = ui; }
  }
  __syncwarp();
}

// -- (1) the plan -------------------------------------------------------------

// Inclusive sum over the block's 1024 threads; *total gets the whole sum.
__device__ long long block_scan(long long v, long long* scratch, long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long t = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    long long w = scratch[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long t = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += t;
    }
    scratch[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += scratch[warp - 1];
  if (threadIdx.x == 0) *total = scratch[31];
  __syncthreads();
  return v;
}

// First position of [0, n) where pred holds (n if none), pred false then
// true along the sorted λ: the sample's QMAX positions in shared memory
// narrow the range, then each step in memory reads 7 positions at once
// (one round trip for an eighth of the range) and the last ≤ 8 together.
template <class Pred>
__device__ long long first_true(const float* __restrict__ slam, long long n, const float* sval,
                                const long long* spos, Pred pred) {
  int i = 0, j = QMAX;
  while (i < j) {
    const int m = (i + j) >> 1;
    if (pred(sval[m])) j = m; else i = m + 1;
  }
  long long a = i == 0 ? 0 : spos[i - 1] + 1, z = i == QMAX ? n : spos[i];
  while (z - a > 8) {                         // the answer lies in [a, z]
    const long long step = (z - a) >> 3;
    float v[7];
#pragma unroll
    for (int u = 0; u < 7; ++u) v[u] = slam[a + (u + 1) * step];
    int first = 7;
#pragma unroll
    for (int u = 6; u >= 0; --u)
      if (pred(v[u])) first = u;
    if (first == 7) {
      a += 7 * step + 1;
    } else {
      z = a + (first + 1) * step;
      if (first > 0) a += first * step + 1;
    }
  }
  float v[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) v[u] = a + u < z ? slam[a + u] : 0.f;
  long long r = z;
#pragma unroll
  for (int u = 7; u >= 0; --u)
    if (a + u < z && pred(v[u])) r = a + u;
  return r;
}

// The block of the even cut of `tiles` into `blocks` ranges
// [⌊i·tiles/blocks⌋, ⌊(i+1)·tiles/blocks⌋) whose range holds tile `x`.
__device__ long long block_of(long long x, long long tiles, long long blocks) {
  long long i = x * blocks / tiles;
  while (i + 1 < blocks && (i + 1) * tiles / blocks <= x) ++i;
  while (i > 0 && i * tiles / blocks > x) --i;
  return i;
}

__global__ void __launch_bounds__(QMAX)
energy_window_plan_kernel(const float* __restrict__ slam, int64_t n,
                          const float* __restrict__ ql, int b, int grid, int grid_n,
                          long long* __restrict__ ws, unsigned long long* __restrict__ tally) {
  __shared__ unsigned long long key[QMAX];
  __shared__ int qid[QMAX];
  __shared__ float sval[QMAX];
  __shared__ long long spos[QMAX];
  __shared__ int members[2][QMAX];            // per group, the two cuts: queries
  __shared__ int union_hi[QMAX];              // the consecutive cut's largest hi
  __shared__ int slots[QMAX];                 // per group of the chosen cut: its blocks
  __shared__ long long scratch[32];
  __shared__ long long s_total;
  const int t = threadIdx.x;

  members[0][t] = members[1][t] = union_hi[t] = 0;
  spos[t] = (long long)t * n / QMAX;
  sval[t] = slam[spos[t]];
  __syncthreads();

  // NaN λ sit last and are never in a band: both predicates hold there.
  long long lo = 0, hi = 0;
  unsigned long long kk = NO_BAND;
  if (t < b) {
    const float q = ql[t];
    if (!isnan(q)) {
      lo = first_true(slam, n, sval, spos,
                      [q](float l) { return isnan(l) || l >= q || lam_dist(q, l) < TIE_EPS; });
      hi = first_true(slam, n, sval, spos,
                      [q](float l) { return isnan(l) || (l > q && !(lam_dist(q, l) < TIE_EPS)); });
    }
    ws[W_LO + t] = lo;
    ws[W_HI + t] = hi;
    if (lo < hi) kk = ((unsigned long long)lo << 32) | (unsigned long long)hi;
  }
  key[t] = kk;
  qid[t] = t;
  const long long band_pairs_in = t < b ? hi - lo : 0;
  __syncthreads();
  // Bitonic sort by (band, query): one band's queries together, in order.
  for (int size = 2; size <= QMAX; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int j = t ^ stride;
      if (j > t) {
        const unsigned long long x = key[t], y = key[j];
        const int ix = qid[t], iy = qid[j];
        if ((x > y || (x == y && ix > iy)) == ((t & size) == 0)) {
          key[t] = y; key[j] = x; qid[t] = iy; qid[j] = ix;
        }
      }
      __syncthreads();
    }
  }
  const unsigned long long ki = key[t];
  const int qi = qid[t];
  const bool has = ki != NO_BAND;             // sorted positions [0, banded)
  const long long glo = (long long)(ki >> 32), ghi = (long long)(ki & 0xffffffffull);
  int run0 = 0, run1 = t + 1;                  // this band's positions [run0, run1)
  for (int z = t; run0 < z;) {
    const int m = (run0 + z) >> 1;
    if (key[m] < ki) run0 = m + 1; else z = m;
  }
  for (int z = QMAX; run1 < z;) {
    const int m = (run1 + z) >> 1;
    if (key[m] <= ki) run1 = m + 1; else z = m;
  }
  const bool narrow = NARROW_W > 0 && has && run1 - run0 <= NARROW_W;
  // The two cuts: 64s of one band (a band of at most NARROW_W queries is one
  // narrow group); consecutive 64s (their bands' union, all wide).
  const bool start_b = has && (t - run0) % BM == 0;
  const bool start_u = has && t % BM == 0;
  const int gb = (int)block_scan(start_b, scratch, &s_total) - 1;
  const int gu = (int)block_scan(start_u, scratch, &s_total) - 1;
  if (has) {
    atomicAdd(&members[0][gb], 1);
    atomicAdd(&members[1][gu], 1);
    atomicMax(&union_hi[gu], (int)ghi);
  }
  __syncthreads();
  const long long tiles_b = start_b ? (ghi - glo + BN - 1) / BN : 0;
  const long long tiles_u = start_u ? (union_hi[gu] - glo + BN - 1) / BN : 0;
  long long w_b, w_u, band_pairs;
  block_scan(tiles_b, scratch, &s_total);
  w_b = s_total;
  block_scan(tiles_u, scratch, &s_total);
  w_u = s_total;
  block_scan(band_pairs_in, scratch, &s_total);
  band_pairs = s_total;
  const bool use_u = w_u < w_b;
  const bool start = use_u ? start_u : start_b;
  const bool nar = !use_u && narrow;
  const int g = use_u ? gu : gb;
  // Each kind's groups numbered and their tiles end to end, cut into one
  // even range a block of its launch. Groups of one band sit side by side,
  // so their blocks read the band's rows at about the same time and share
  // them in L2.
  const long long my_tiles = use_u ? tiles_u : tiles_b;
  const long long my_w = nar ? 0 : my_tiles, my_n = nar ? my_tiles : 0;
  long long tiles_w, tiles_n, ngw, ngn;
  const long long prefix_w = block_scan(my_w, scratch, &s_total) - my_w;
  tiles_w = s_total;
  const long long prefix_n = block_scan(my_n, scratch, &s_total) - my_n;
  tiles_n = s_total;
  const int i_w = (int)block_scan(start && !nar, scratch, &s_total) - 1;
  ngw = s_total;
  const int i_n = (int)block_scan(start && nar, scratch, &s_total) - 1;
  ngn = s_total;
  const long long blocks_w = tiles_w < grid ? tiles_w : grid;
  const long long blocks_n = tiles_n < grid_n ? tiles_n : grid_n;
  if (start) {
    const long long prefix = nar ? prefix_n : prefix_w;
    const long long tiles = nar ? tiles_n : tiles_w, blocks = nar ? blocks_n : blocks_w;
    const long long bf = block_of(prefix, tiles, blocks);
    const long long bl = block_of(prefix + my_tiles - 1, tiles, blocks);
    const int gi = nar ? (int)ngw + i_n : i_w;
    ws[G_LO + gi] = glo;
    ws[G_HI + gi] = use_u ? union_hi[g] : ghi;
    ws[G_NQ + gi] = members[use_u][g];
    ws[G_FIRST + gi] = t;
    ws[G_PREFIX + gi] = prefix;
    ws[G_BFIRST + gi] = bf;
    slots[g] = (int)(bl - bf + 1);
  }
  __syncthreads();
  if (has) ws[W_ORDER + t] = qi;
  if (t < b) ws[W_SLOTS + qi] = has ? slots[g] : 0;
  if (t == 0) {
    ws[CTRL + C_GROUPS] = ngw;
    ws[CTRL + C_TILES] = tiles_w;
    ws[CTRL + C_BLOCKS] = blocks_w;
    ws[CTRL + C_NGROUPS] = ngn;
    ws[CTRL + C_NTILES] = tiles_n;
    ws[CTRL + C_NBLOCKS] = blocks_n;
    const unsigned long long narrow_pairs = (unsigned long long)tiles_n * NARROW_W * BN;
    atomicAdd(&tally[T_BAND_PAIRS], (unsigned long long)band_pairs);
    atomicAdd(&tally[T_DOT_PAIRS], (unsigned long long)tiles_w * BM * BN + narrow_pairs);
    atomicAdd(&tally[T_NARROW_PAIRS], narrow_pairs);
  }
}

// -- (2) the band's dots --------------------------------------------------------

constexpr int L2_CHUNKS = 3;                 // K-chunks after the first that a tile's start asks L2 for

// A tile's rows as the epilogue and the loader read them: item (−1 past the
// group's range), λ and norm of each of its 256 positions.
struct TileRows {
  int id[BN];
  float lam[BN];
  float norm[BN];
};

// This thread's two positions c = tid, tid + 128 of the tile at c0: read
// into registers (the norm after its item), written to shared memory later.
struct RowsInFlight {
  int id[2];
  float lam[2], norm[2];
};

__device__ __forceinline__ void read_rows(RowsInFlight& r, const float* __restrict__ slam,
                                          const int64_t* __restrict__ sidx,
                                          const float* __restrict__ norms, long long c0,
                                          long long limit) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const long long pos = c0 + threadIdx.x + THREADS * j;
    r.id[j] = pos < limit ? (int)sidx[pos] : -1;
    r.lam[j] = pos < limit ? slam[pos] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) r.norm[j] = r.id[j] >= 0 ? norms[r.id[j]] : 0.f;
}

__device__ __forceinline__ void write_rows(TileRows& t, const RowsInFlight& r) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = threadIdx.x + THREADS * j;
    t.id[c] = r.id[j];
    t.lam[c] = r.lam[j];
    t.norm[c] = r.norm[j];
  }
}

// Start a tile: its first K-chunk by cp.async, and the lines of the next
// L2_CHUNKS chunks of each row asked of L2, so that a row's first bytes
// come from memory together rather than a chunk at a time.
__device__ __forceinline__ void start_tile(const float* __restrict__ Q, const int* qrows,
                                           const float* __restrict__ X, const TileRows& t, int f,
                                           bool vec, float* ring) {
  f32tile::tile_prefetch_rows(Q, qrows, X, t.id, f, vec, ring);
  const int nk = (f + f32tile::BK - 1) / f32tile::BK;
  const int ahead = nk - 1 < L2_CHUNKS ? nk - 1 : L2_CHUNKS;
  for (int e = threadIdx.x; e < BN * ahead; e += THREADS) {
    const int id = t.id[e / ahead];
    if (id >= 0) {
      const float* line = X + (int64_t)id * f + (1 + e % ahead) * f32tile::BK;
      asm volatile("prefetch.global.L2 [%0];" ::"l"(line));
    }
  }
}

// energy_scan's epilogue for one query over one tile, on the band's pairs
// only: dq its 256 dots (lane reads columns lane + 32m), lm / nm / im the
// columns' λ, norms and items (−1 past the group's range), qlb / qnb the
// query's λ and norm, lvq / liq its list in shared memory (warp-synchronous).
__device__ __forceinline__ void score_tile(const float* dq, const float (&lm)[8],
                                           const float (&nm)[8], const int (&im)[8], float qlb,
                                           float qnb, float* lvq, int* liq, int k, int lane) {
  float th = lvq[k - 1];
  int thid = liq[k - 1];
  float dv[8], den[8], cosv[8];
  bool band[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    dv[m] = dq[lane + 32 * m];
    den[m] = __fadd_rn(__fmul_rn(qnb, nm[m]), TIE_EPS);
    band[m] = im[m] >= 0 && lam_dist(qlb, lm[m]) < TIE_EPS;
  }
  if (th != -INFINITY) {
    // With d ≥ 0 a pair ranks before θ only if its cosine reaches
    // 1 + θ/1e-9; less a margin far above the rounding of either side,
    // a tile whose band dots all lie under that times their denominator
    // holds nothing for this query, and its scores are not formed.
    const float r = th * 1e9f;
    const float c_lo = 1.f + r - (1e-5f + 1e-6f * fabsf(r));
    bool maybe = false;
#pragma unroll
    for (int m = 0; m < 8; ++m) maybe |= band[m] && !(dv[m] < c_lo * den[m]);
    if (!__any_sync(FULL, maybe)) return;
  }
  bool slow = false;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    cosv[m] = divrn::div_fast(dv[m], den[m]);
    slow |= band[m] && !divrn::div_in_range(dv[m], den[m]);
  }
  if (__any_sync(FULL, slow)) {
#pragma unroll
    for (int m = 0; m < 8; ++m)
      if (band[m]) cosv[m] = __fdiv_rn(dv[m], den[m]);
  }
  float sc[8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
    sc[m] = -__fadd_rn(lam_dist(qlb, lm[m]), __fmul_rn(__fsub_rn(1.f, cosv[m]), TIE_EPS));
  float floor_v = -INFINITY;
  if (th == -INFINITY) {
    // The list is not full (a segment's first tile): the k-th largest
    // of the 32 lanes' best band scores has k scores of the tile at or
    // above it, so no score below it is among the tile's k first.
    float best = -INFINITY;
#pragma unroll
    for (int m = 0; m < 8; ++m)
      if (band[m]) best = fmaxf(best, sc[m]);
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const float o = __shfl_xor_sync(FULL, best, stride);
        const bool keep_max = ((lane & stride) == 0) == ((lane & size) == 0);
        best = keep_max ? fmaxf(best, o) : fminf(best, o);
      }
    }
    floor_v = __shfl_sync(FULL, best, k - 1);
  }
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    unsigned pass =
        __ballot_sync(FULL, band[m] && sc[m] >= floor_v && before(sc[m], im[m], th, thid));
    while (pass) {
      const int src = __ffs(pass) - 1;
      pass &= pass - 1;
      const float cs = __shfl_sync(FULL, sc[m], src);
      const int cid = __shfl_sync(FULL, im[m], src);
      if (before(cs, cid, th, thid)) {
        insert(lvq, liq, cs, cid, lane);
        th = lvq[k - 1];
        thid = liq[k - 1];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
energy_window_kernel(const float* __restrict__ X, const float* __restrict__ norms,
                     const float* __restrict__ slam, const int64_t* __restrict__ sidx,
                     const float* __restrict__ Q, const float* __restrict__ qn,
                     const float* __restrict__ ql, int f, int k, int vec,
                     const long long* __restrict__ ws, int slots, float* __restrict__ pvals,
                     int* __restrict__ pids) {
  extern __shared__ __align__(16) float ring[];
  __shared__ float list_v[BM][KP];
  __shared__ int list_i[BM][KP];
  __shared__ int qrows[BM];                  // the group's queries (rows of Q), −1 past nq
  __shared__ TileRows rows[2];               // this tile's and the next one's
  __shared__ int s_g;

  const long long tiles = ws[CTRL + C_TILES], blocks = ws[CTRL + C_BLOCKS];
  const int ng = (int)ws[CTRL + C_GROUPS];
  const long long blk = blockIdx.x;
  if (blk >= blocks) return;
  const long long r_begin = blk * tiles / blocks, r_end = (blk + 1) * tiles / blocks;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {                            // the last group that starts at or before r_begin
    int a = 0, z = ng;
    while (a < z) {
      const int m = (a + z) >> 1;
      if (ws[G_PREFIX + m] <= r_begin) a = m + 1; else z = m;
    }
    s_g = a - 1;
  }
  __syncthreads();

  for (int g = s_g; g < ng; ++g) {           // a segment: the group's tiles in this range
    const long long gp = ws[G_PREFIX + g];
    if (gp >= r_end) break;
    const long long glo = ws[G_LO + g], ghi = ws[G_HI + g];
    const long long t_begin = max(r_begin, gp) - gp;
    const long long t_end = min(r_end, gp + (ghi - glo + BN - 1) / BN) - gp;
    const int nq = (int)ws[G_NQ + g];
    const long long first = ws[G_FIRST + g];
    const int slot = (int)(blk - ws[G_BFIRST + g]);
    if (tid < BM) qrows[tid] = tid < nq ? (int)ws[W_ORDER + first + tid] : -1;
    for (int e = tid; e < BM * KP; e += THREADS) {
      list_v[e / KP][e % KP] = -INFINITY;
      list_i[e / KP][e % KP] = EMPTY_ID;
    }
    RowsInFlight next;
    read_rows(next, slam, sidx, norms, glo + t_begin * BN, ghi);
    write_rows(rows[0], next);
    __syncthreads();
    // Lane j < QW holds query warp·QW + j's λ and norm; the loop takes them by shuffle.
    const int qr = qrows[warp * QW + lane % QW];
    const float ql_l = qr >= 0 ? ql[qr] : 0.f;
    const float qn_l = qr >= 0 ? qn[qr] : 0.f;

    start_tile(Q, qrows, X, rows[0], f, vec != 0, ring);
    for (long long tile = t_begin; tile < t_end; ++tile) {
      const TileRows& cur = rows[(tile - t_begin) & 1];
      const bool more = tile + 1 < t_end;
      float acc[f32tile::TQ][f32tile::TR];
      f32tile::tile_product_rows(Q, qrows, X, cur.id, f, vec != 0, ring, acc);
      f32tile::store_dots(ring, acc);
      if (more) read_rows(next, slam, sidx, norms, glo + (tile + 1) * BN, ghi);

      float lm[8], nm[8];                    // λ and norms of this lane's columns lane + 32m
      int im[8];                             // their items (−1: past the group's range)
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int col = lane + 32 * m;
        im[m] = cur.id[col];
        lm[m] = cur.lam[col];
        nm[m] = cur.norm[col];
      }
#pragma unroll 1
      for (int qq = 0; qq < QW; ++qq) {
        const int q = warp * QW + qq;
        if (q >= nq) break;
        score_tile(ring + q * BN, lm, nm, im, __shfl_sync(FULL, ql_l, qq),
                   __shfl_sync(FULL, qn_l, qq), list_v[q], list_i[q], k, lane);
      }
      if (more) write_rows(rows[(tile + 1 - t_begin) & 1], next);
      __syncthreads();                       // the dots read out, the next rows written
      if (more) start_tile(Q, qrows, X, rows[(tile + 1 - t_begin) & 1], f, vec != 0, ring);
    }

    if (lane < k) {
#pragma unroll 1
      for (int qq = 0; qq < QW; ++qq) {
        const int q = warp * QW + qq;
        if (q >= nq) break;
        const int64_t o = ((int64_t)qrows[q] * slots + slot) * k + lane;
        pvals[o] = list_v[q][lane];
        pids[o] = list_i[q][lane];
      }
    }
    __syncthreads();                         // qrows, the rows and the lists are free
  }
}

// -- (3) the narrow groups' dots ------------------------------------------------

constexpr int N_UNITS = f32tile::UNITS;      // 16-byte units of a row in a chunk
constexpr int N_ROW_UNITS = BN * N_UNITS / N_THREADS;   // row units a thread copies a chunk
static_assert(N_THREADS == BN && BN * N_UNITS % N_THREADS == 0,
              "a thread stages one row's items, multiplies two rows, copies whole units");

template <int W>
struct Narrow {
  static constexpr int STAGE_FLOATS = (W + BN) * f32tile::BK;   // a chunk: W queries, then 256 rows
  static constexpr int SMEM_BYTES = (N_STAGES * STAGE_FLOATS + W * BN) * (int)sizeof(float);
};

// Row n0 of the thread's two (n0 and n0 + 128): the 8 threads that one
// 16-byte shared read serves together take rows 4 apart, so their units,
// swizzled as the wide tile's (f32tile::swizzled), fall into 8 bank groups.
__device__ __forceinline__ int narrow_row(int t) {
  return 32 * ((t >> 5) & 3) + 4 * (t & 7) + ((t >> 3) & 3);
}

// Bring features [k0, k0 + BK) of the group's queries (qrows, −1 a zero
// row) and of the tile's rows (xrows, −1 past the group's range) into one
// chunk of the ring: the queries unswizzled (every lane of a warp reads the
// same unit), the rows in the wide tile's swizzled layout.
template <int W>
__device__ __forceinline__ void narrow_load(float* stage, const float* __restrict__ Q,
                                            const int* qrows, const float* __restrict__ X,
                                            const int* xrows, int f, int k0, bool vec) {
  const int tid = threadIdx.x;
  float* Qs = stage;
  float* Xs = stage + W * f32tile::BK;
  if (tid < W * N_UNITS) {
    const int m = tid / N_UNITS, u = tid % N_UNITS, kq = k0 + 4 * u;
    const int r = qrows[m];
    const float* row = Q + (int64_t)(r >= 0 ? r : 0) * f;
    float* dst = Qs + m * f32tile::BK + 4 * u;
    if (vec) f32tile::cp_async16(dst, row + (kq < f ? kq : 0), r >= 0 && kq < f);
    else f32tile::load_unit_generic(dst, row, r >= 0, kq, f);
  }
#pragma unroll
  for (int it = 0; it < N_ROW_UNITS; ++it) {
    const int e = tid + it * N_THREADS;
    const int n = e / N_UNITS, u = e % N_UNITS, kx = k0 + 4 * u;
    const int r = xrows[n];
    const float* row = X + (int64_t)(r >= 0 ? r : 0) * f;
    float* dst = Xs + f32tile::swizzled(n, u);
    if (vec) f32tile::cp_async16(dst, row + (kx < f ? kx : 0), r >= 0 && kx < f);
    else f32tile::load_unit_generic(dst, row, r >= 0, kx, f);
  }
}

// acc[i][j] += Σ_k Q[q0 + i][k] · X[n0 + 128j][k] over one staged chunk, q0
// = (tid >> 7)·W/2: one fmaf a feature, ascending, as the wide tile's.
template <int W>
__device__ __forceinline__ void narrow_multiply(const float* stage, float (&acc)[W / 2][2]) {
  const float* Qs = stage + (threadIdx.x >> 7) * (W / 2) * f32tile::BK;
  const float* Xs = stage + W * f32tile::BK;
  const int n0 = narrow_row(threadIdx.x & 127);
  const int key = (n0 >> 2) & 7;               // the same for n0 + 128
#pragma unroll
  for (int u = 0; u < N_UNITS; ++u) {
    float4 a[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i)
      a[i] = *reinterpret_cast<const float4*>(Qs + i * f32tile::BK + 4 * u);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float4 x =
          *reinterpret_cast<const float4*>(Xs + (n0 + 128 * j) * f32tile::BK + ((u ^ key) << 2));
#pragma unroll
      for (int i = 0; i < W / 2; ++i) acc[i][j] = fmaf(a[i].x, x.x, acc[i][j]);
#pragma unroll
      for (int i = 0; i < W / 2; ++i) acc[i][j] = fmaf(a[i].y, x.y, acc[i][j]);
#pragma unroll
      for (int i = 0; i < W / 2; ++i) acc[i][j] = fmaf(a[i].z, x.z, acc[i][j]);
#pragma unroll
      for (int i = 0; i < W / 2; ++i) acc[i][j] = fmaf(a[i].w, x.w, acc[i][j]);
    }
  }
}

template <int W>
__global__ void __launch_bounds__(N_THREADS, 1)
energy_window_narrow_kernel(const float* __restrict__ X, const float* __restrict__ norms,
                            const float* __restrict__ slam, const int64_t* __restrict__ sidx,
                            const float* __restrict__ Q, const float* __restrict__ qn,
                            const float* __restrict__ ql, int f, int k, int vec,
                            const long long* __restrict__ ws, int slots,
                            float* __restrict__ pvals, int* __restrict__ pids) {
  extern __shared__ __align__(16) float ring[];   // N_STAGES chunks, then the dot tile [W][BN]
  __shared__ float list_v[W][KP];
  __shared__ int list_i[W][KP];
  __shared__ int qrows[W];                   // the group's queries (rows of Q), −1 past nq
  __shared__ float q_lam[W], q_norm[W];
  __shared__ TileRows rows[N_ROWBUF];        // tile j's items, λ and norms in rows[j % N_ROWBUF]
  __shared__ int s_g;
  float* dots = ring + N_STAGES * Narrow<W>::STAGE_FLOATS;

  const int g0 = (int)ws[CTRL + C_GROUPS], ng = (int)ws[CTRL + C_NGROUPS];
  const long long tiles = ws[CTRL + C_NTILES], blocks = ws[CTRL + C_NBLOCKS];
  const long long blk = blockIdx.x;
  if (blk >= blocks) return;
  const long long r_begin = blk * tiles / blocks, r_end = (blk + 1) * tiles / blocks;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nk = (f + f32tile::BK - 1) / f32tile::BK;
  const int n0 = narrow_row(tid & 127), q0 = (tid >> 7) * (W / 2);
  if (tid == 0) {                            // the last group that starts at or before r_begin
    int a = g0, z = g0 + ng;
    while (a < z) {
      const int m = (a + z) >> 1;
      if (ws[G_PREFIX + m] <= r_begin) a = m + 1; else z = m;
    }
    s_g = a - 1;
  }
  __syncthreads();

  for (int g = s_g; g < g0 + ng; ++g) {      // a segment: the group's tiles in this range
    const long long gp = ws[G_PREFIX + g];
    if (gp >= r_end) break;
    const long long glo = ws[G_LO + g], ghi = ws[G_HI + g];
    const long long t_begin = max(r_begin, gp) - gp;
    const long long total = (min(r_end, gp + (ghi - glo + BN - 1) / BN) - gp - t_begin) * nk;
    const int nq = (int)ws[G_NQ + g];
    const int slot = (int)(blk - ws[G_BFIRST + g]);
    if (tid < W) {
      const int r = tid < nq ? (int)ws[W_ORDER + ws[G_FIRST + g] + tid] : -1;
      qrows[tid] = r;
      q_lam[tid] = r >= 0 ? ql[r] : 0.f;
      q_norm[tid] = r >= 0 ? qn[r] : 0.f;
    }
    for (int e = tid; e < W * KP; e += N_THREADS) {
      list_v[e / KP][e % KP] = -INFINITY;
      list_i[e / KP][e % KP] = EMPTY_ID;
    }
    float acc[W / 2][2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) acc[i][0] = acc[i][1] = 0.f;

    // Step s multiplies chunk s (of tile s / nk), after starting the copy of
    // chunk s + N_AHEAD; the items of the tile whose first chunk is
    // s + N_AHEAD + 1 are read during the step and written at its end. A
    // tile's items are thus written N_AHEAD + 1 steps before its epilogue at
    // the earliest, into a buffer whose last reader (the epilogue of the
    // tile N_ROWBUF before) finished at least a step earlier.
    for (long long s = -N_AHEAD - 1; s < total; ++s) {
      const long long nx = s + N_AHEAD + 1;
      const bool stage = nx < total && nx % nk == 0;
      int r_id = -1;
      float r_lam = 0.f, r_norm = 0.f;
      if (stage) {
        const long long pos = glo + (t_begin + nx / nk) * BN + tid;
        r_id = pos < ghi ? (int)sidx[pos] : -1;
        r_lam = pos < ghi ? slam[pos] : 0.f;
        r_norm = r_id >= 0 ? norms[r_id] : 0.f;
      }
      if (s >= 0) f32tile::cp_async_wait<N_AHEAD - 1>();   // chunk s has landed (this thread's)
      __syncthreads();                       // ... everyone's; chunk s − 1 is read out
      const long long ld = s + N_AHEAD;
      if (ld >= 0 && ld < total)
        narrow_load<W>(ring + (ld % N_STAGES) * Narrow<W>::STAGE_FLOATS, Q, qrows, X,
                       rows[(ld / nk) % N_ROWBUF].id, f, (int)(ld % nk) * f32tile::BK, vec != 0);
      f32tile::cp_async_commit();
      if (s >= 0) {
        narrow_multiply<W>(ring + (s % N_STAGES) * Narrow<W>::STAGE_FLOATS, acc);
        if (s % nk == nk - 1) {              // the tile's last chunk: its epilogue
#pragma unroll
          for (int i = 0; i < W / 2; ++i) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              dots[(q0 + i) * BN + n0 + 128 * j] = acc[i][j];
              acc[i][j] = 0.f;
            }
          }
          __syncthreads();
          const TileRows& cur = rows[(s / nk) % N_ROWBUF];
          float lm[8], nm[8];
          int im[8];
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            const int col = lane + 32 * m;
            im[m] = cur.id[col];
            lm[m] = cur.lam[col];
            nm[m] = cur.norm[col];
          }
#pragma unroll 1
          for (int q = warp; q < nq; q += N_THREADS / 32)
            score_tile(dots + q * BN, lm, nm, im, q_lam[q], q_norm[q], list_v[q], list_i[q], k,
                       lane);
        }
      }
      if (stage) {
        TileRows& t = rows[(nx / nk) % N_ROWBUF];
        t.id[tid] = r_id;
        t.lam[tid] = r_lam;
        t.norm[tid] = r_norm;
      }
    }
    f32tile::cp_async_wait<0>();

    if (lane < k) {
#pragma unroll 1
      for (int q = warp; q < nq; q += N_THREADS / 32) {
        const int64_t o = ((int64_t)qrows[q] * slots + slot) * k + lane;
        pvals[o] = list_v[q][lane];
        pids[o] = list_i[q][lane];
      }
    }
    __syncthreads();                         // qrows, the rows and the lists are free
  }
}

// -- (4) the slots' lists, then the walks ----------------------------------------

constexpr int WALK_UNROLL = 4;               // 32-candidate batches read at once

__global__ void __launch_bounds__(32 * WALK_WARPS)
energy_window_walk_kernel(const float* __restrict__ pvals, const int* __restrict__ pids,
                          int slots, const long long* __restrict__ ws, int64_t n,
                          const float* __restrict__ slam, const int64_t* __restrict__ sidx,
                          const float* __restrict__ ql, int b, int k, float* __restrict__ vals,
                          int* __restrict__ ids, unsigned long long* __restrict__ tally) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * WALK_WARPS + (threadIdx.x >> 5);
  if (q >= b) return;
  // Lane e < k holds entry e of the list, best first; θ is entry k − 1.
  float v = -INFINITY, th = -INFINITY;
  int vi = EMPTY_ID, thid = EMPTY_ID;
  auto take = [&](float s, int id, bool ok) -> bool {
    unsigned pass = __ballot_sync(FULL, ok && before(s, id, th, thid));
    const bool any = pass != 0;
    while (pass) {
      const int src = __ffs(pass) - 1;
      pass &= pass - 1;
      const float cs = __shfl_sync(FULL, s, src);
      const int cid = __shfl_sync(FULL, id, src);
      if (before(cs, cid, th, thid)) {
        const int pos = __popc(__ballot_sync(FULL, lane < k && before(v, vi, cs, cid)));
        const float uv = __shfl_up_sync(FULL, v, 1);
        const int ui = __shfl_up_sync(FULL, vi, 1);
        if (lane < k) {
          if (lane == pos) { v = cs; vi = cid; }
          else if (lane > pos) { v = uv; vi = ui; }
        }
        th = __shfl_sync(FULL, v, k - 1);
        thid = __shfl_sync(FULL, vi, k - 1);
      }
    }
    return any;
  };

  const long long cand = ws[W_SLOTS + q] * k;
  const float* pv = pvals + (int64_t)q * slots * k;
  const int* pi = pids + (int64_t)q * slots * k;
  for (long long c = 0; c < cand; c += 32 * WALK_UNROLL) {
    float cv[WALK_UNROLL];
    int ci[WALK_UNROLL];
#pragma unroll
    for (int u = 0; u < WALK_UNROLL; ++u) {
      const long long e = c + 32 * u + lane;
      cv[u] = e < cand ? pv[e] : -INFINITY;
      ci[u] = e < cand ? pi[e] : EMPTY_ID;
    }
#pragma unroll
    for (int u = 0; u < WALK_UNROLL; ++u) take(cv[u], ci[u], c + 32 * u + lane < cand);
  }

  const float qlb = ql[q];
  if (!isnan(qlb)) {                          // a NaN qλ scores no row
    long long left = ws[W_LO + q] - 1, right = ws[W_HI + q];
    bool done_l = left < 0, done_r = right >= n;
    bool past = false;
    long long walked = 0;
    while (!done_l || !done_r) {
      if (!done_l) {                          // positions left, left − 1, ... nearest first
        const long long p = left - lane;
        const bool ok = p >= 0;
        const float s = ok ? -lam_dist(qlb, slam[p]) : -INFINITY;
        past |= take(s, ok ? (int)sidx[p] : EMPTY_ID, ok);
        const int far = (int)(left < 31 ? left : 31);
        const float s_far = __shfl_sync(FULL, s, far);
        walked += far + 1;
        left -= 32;
        done_l = left < 0 || s_far < th;
      }
      if (!done_r) {                          // right, right + 1, ...: NaN λ (last) end it
        const long long p = right + lane;
        const float l = p < n ? slam[p] : 0.f;
        const bool ok = p < n && !isnan(l);
        const float s = ok ? -lam_dist(qlb, l) : -INFINITY;
        past |= take(s, ok ? (int)sidx[p] : EMPTY_ID, ok);
        const int far = (int)(n - 1 - right < 31 ? n - 1 - right : 31);
        const float s_far = __shfl_sync(FULL, s, far);
        const bool nan_seen = __any_sync(FULL, p < n && isnan(l));
        walked += far + 1;
        right += 32;
        done_r = right >= n || nan_seen || s_far < th;
      }
    }
    if (lane == 0) {
      if (past) atomicAdd(&tally[T_PAST_BAND], 1ull);
      atomicAdd(&tally[T_WALKED], (unsigned long long)walked);
    }
  }
  if (lane < k) {
    vals[(int64_t)q * k + lane] = v;
    ids[(int64_t)q * k + lane] = vi;
  }
}

}  // namespace

extern "C" {

const char* mrs_cuda_strerror(int rc) { return cudaGetErrorString((cudaError_t)rc); }

// The sizes a caller allocates: queries a launch takes, int64 words of the
// plan's workspace; and the queries a narrow tile holds (0: none).
int mrs_energy_window_sizes(int* qmax, int* ws_len, int* narrow_w) {
  *qmax = QMAX;
  *ws_len = WS_LEN;
  *narrow_w = NARROW_W;
  return 0;
}

// X [n, f], norms [n] float32; slam [n] the ascending λ (NaN last) and
// sidx [n] int64 the item at each position; Q [b, f], qn [b], ql [b]
// float32; all contiguous. 1 ≤ b ≤ 1024, 1 ≤ k ≤ 16 (k ≤ n), n < 2^31,
// grid ≥ 1 the blocks of the wide band kernel (its lists' slots; the narrow
// kernel takes one block an SM, at most grid). ws: WS_LEN int64;
// pvals/pids [b, grid, k]; vals/ids [b, k] get each query's best k of −s
// (id 2^31 − 1 with −inf where fewer than k rows have a score); tally [5]
// uint64 is added to. Returns cudaGetLastError().
int mrs_energy_window(const float* X, const float* norms, const float* slam, const int64_t* sidx,
                      const float* Q, const float* qn, const float* ql, int64_t n, int f, int b,
                      int k, int grid, long long* ws, float* pvals, int* pids, float* vals,
                      int* ids, unsigned long long* tally, void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || f <= 0 || b < 1 || b > QMAX || k < 1 || k > KP || k > n ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  const int vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(Q) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  int grid_n = 0;
  cudaError_t rc;
  if (NARROW_W > 0) {
    int dev = 0, sms = 0;
    if ((rc = cudaGetDevice(&dev)) != cudaSuccess ||
        (rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)rc;
    grid_n = sms < grid ? sms : grid;
  }
  energy_window_plan_kernel<<<1, QMAX, 0, s>>>(slam, n, ql, b, grid, grid_n, ws, tally);
  rc = cudaFuncSetAttribute(energy_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  energy_window_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(X, norms, slam, sidx, Q, qn, ql, f, k,
                                                          vec, ws, grid, pvals, pids);
#if WINDOW_NARROW_W > 0
  rc = cudaFuncSetAttribute(energy_window_narrow_kernel<NARROW_W>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            Narrow<NARROW_W>::SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  energy_window_narrow_kernel<NARROW_W><<<grid_n, N_THREADS, Narrow<NARROW_W>::SMEM_BYTES, s>>>(
      X, norms, slam, sidx, Q, qn, ql, f, k, vec, ws, grid, pvals, pids);
#endif
  energy_window_walk_kernel<<<(b + WALK_WARPS - 1) / WALK_WARPS, 32 * WALK_WARPS, 0, s>>>(
      pvals, pids, grid, ws, n, slam, sidx, ql, b, k, vals, ids, tally);
  return (int)cudaGetLastError();
}

}  // extern "C"
