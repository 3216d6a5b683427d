// Exact block-wide top-k under a total order, for kernel G's merge
// (csrc/search_fused.cu) and the exact tier's candidate stage
// (csrc/tilemax.cu). A block of WARPS warps shares one row of candidates.
//
// Each candidate becomes a 64-bit key that orders as (score descending, id
// ascending): the f32 score mapped to an unsigned integer that grows with
// the score (−0.0 taken as +0.0, since the plain versions' sorts hold them
// equal; every NaN above +inf, as a descending sort puts them), then the id,
// flipped so that a smaller id gives a larger key. Equal keys (the same
// score and id twice) fall to the candidate's position, as a stable sort
// does, so the order is total on any input and a result read back by
// position is the plain version's bit for bit.
//
// Each warp keeps a sorted list of 32 in registers (one entry per lane, best
// in lane 0) whose first k are the best k it has seen, and takes batches of
// 32 candidates: the few that beat its k-th (and, after the first batches,
// the block's k-th so far) are inserted one by one (a ballot and a shuffle
// each), a batch with more is sorted and merged by bitonic networks over
// shuffles (21 steps, whatever the data); the warps' lists then merge
// pairwise through shared memory. For a row much longer than the block,
// take_filtered first sets a bar from each thread's best candidate, so that
// only the few candidates that reach it are ranked, by one warp. Every
// function here is warp-synchronous: all 32 lanes of a warp call it
// together.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace warptopk {

constexpr int WARPS = 8;                             // a block's warps
constexpr int INSERT_MAX = 4;                        // passing candidates a batch inserts one by one

struct Cand {
  uint64_t key;
  uint32_t pos;
};

// The key's halves: the score's bits, which alone order distinct scores,
// and the id's.
__device__ __forceinline__ uint32_t score_bits(float v) {
  uint32_t u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;                 // −0.0 → +0.0
  if (isnan(v)) u = 0x7fffffffu;                // every NaN → above +inf
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ uint32_t id_bits(int id) { return ~((uint32_t)id ^ 0x80000000u); }
__device__ __forceinline__ int key_id(uint64_t key) { return (int)(~(uint32_t)key ^ 0x80000000u); }
__device__ __forceinline__ uint64_t order_key(float v, int id) {
  return ((uint64_t)score_bits(v) << 32) | (uint64_t)id_bits(id);
}
__device__ __forceinline__ bool ranks_before(const Cand& a, const Cand& b) {
  return a.key > b.key || (a.key == b.key && a.pos < b.pos);
}
// Below every candidate: (−inf, 2^31 − 1) has key 0x007fffff'00000000.
__device__ __forceinline__ Cand nothing() { return Cand{0ull, 0xffffffffu}; }

__device__ __forceinline__ Cand shfl_cand(const Cand& c, int src) {
  return Cand{__shfl_sync(0xffffffffu, c.key, src), __shfl_sync(0xffffffffu, c.pos, src)};
}
// Lane keeps the better (or, !take_better, the worse) of its candidate and
// that of lane ^ m.
__device__ __forceinline__ void exchange(Cand& c, int m, bool take_better) {
  const Cand o = Cand{__shfl_xor_sync(0xffffffffu, c.key, m), __shfl_xor_sync(0xffffffffu, c.pos, m)};
  if (ranks_before(o, c) == take_better) c = o;
}
// Bitonic sort of the warp's 32 candidates, best in lane 0.
__device__ __forceinline__ void sort32(Cand& c, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int m = size >> 1; m > 0; m >>= 1) exchange(c, m, ((lane & m) == 0) == ((lane & size) == 0));
}
// Insert c (the same on every lane) into the sorted list: the entries that
// rank before it are a prefix; those behind it move down a lane.
__device__ __forceinline__ void insert_one(Cand& list, const Cand& c, int lane) {
  const int at = __popc(__ballot_sync(0xffffffffu, ranks_before(list, c)));
  const Cand up = shfl_cand(list, lane > 0 ? lane - 1 : 0);
  if (lane == at) list = c;
  else if (lane > at) list = up;
}
// list := the best 32 of list ∪ x, both sorted best first: the better of
// list[l] and x[31 − l] is a bitonic sequence holding them; sort it.
__device__ __forceinline__ void merge32(Cand& list, const Cand& x, int lane) {
  const Cand r = shfl_cand(x, 31 - lane);
  if (ranks_before(r, list)) list = r;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) exchange(list, m, (lane & m) == 0);
}

// The warps' lists (each sorted) meet pairwise through shared memory
// (W ≥ k entries a warp), log2(WARPS) rounds of one bitonic merge;
// lists[0] and warp 0's list end with the block's best k.
template <int W>
__device__ __forceinline__ void tree_merge(Cand& list, Cand (*lists)[W], int k, int warp, int lane) {
  if (lane < k) lists[warp][lane] = list;
#pragma unroll 1
  for (int half = WARPS / 2; half >= 1; half >>= 1) {
    __syncthreads();
    if (warp < half) {
      merge32(list, lane < k ? lists[warp + half][lane] : nothing(), lane);
      if (lane < k) lists[warp][lane] = list;
    }
  }
  __syncthreads();
}

// The k-th best of what the warps' lists hold now (every warp calls it;
// the lists themselves are kept): a candidate that does not beat it is
// beaten by k others and cannot be among the best k.
template <int W>
__device__ __forceinline__ Cand block_kth(const Cand& list, Cand (*lists)[W], int k, int warp,
                                          int lane) {
  Cand copy = list;
  tree_merge(copy, lists, k, warp, lane);
  const Cand kth = lists[0][k - 1];
  __syncthreads();                                   // lists is rewritten later
  return kth;
}

// One batch of 32 candidates x (one a lane, nothing() past the end) into
// the warp's list. A candidate can enter the best k only if it beats both
// the list's k-th entry and `floor` (the block's k-th at some earlier
// point, or nothing), so the better of the two is the bar; once the lists
// have filled, few pass it: up to INSERT_MAX of a batch are inserted one by
// one; more, and the batch is sorted and merged into the list.
__device__ __forceinline__ void take_batch(Cand& list, const Cand& floor, Cand x, int k, int lane) {
  const Cand own = shfl_cand(list, k - 1);
  unsigned pass = __ballot_sync(0xffffffffu, ranks_before(x, ranks_before(own, floor) ? own : floor));
  if (__popc(pass) > INSERT_MAX) {
    sort32(x, lane);
    merge32(list, x, lane);
    return;
  }
  while (pass) {                // one that no longer beats the risen k-th lands behind it: harmless
    const int src = __ffs(pass) - 1;
    pass &= pass - 1;
    insert_one(list, shfl_cand(x, src), lane);
  }
}

// Candidates 0 .. len − 1 of what the block has staged (cand(e) gives
// candidate e's Cand) into the warps' lists: warp w takes batches w,
// w + WARPS, ... of 32. With `first` (block-uniform: the first stage of a
// row longer than one round), the block's k-th after the first round
// becomes every warp's floor.
template <int W, class CandOf>
__device__ __forceinline__ void take_staged(Cand& list, Cand& floor, Cand (*lists)[W], bool first,
                                            int len, int k, int warp, int lane, CandOf cand) {
  int b0 = warp * 32;
  if (first) {
    take_batch(list, floor, b0 + lane < len ? cand(b0 + lane) : nothing(), k, lane);
    b0 += WARPS * 32;
    floor = block_kth(list, lists, k, warp, lane);
  }
  for (; b0 < len; b0 += WARPS * 32)
    take_batch(list, floor, b0 + lane < len ? cand(b0 + lane) : nothing(), k, lane);
}

// The best k of a row of len staged candidates, for a row much longer than
// the block whose ids ascend with the candidates' positions (score(e) and
// id(e) give candidate e), merged into warp 0's sorted `list`, which may
// hold the best of earlier rows; `floor` is its k-th (or nothing). Thread
// t's best of e = t, t + 32·WARPS, ... comes first (the first of equal
// scores: the lowest id); the k-th best of those thread bests is a bar that
// at least k candidates reach and every one of the row's best k reaches.
// Only the candidates that reach it (or `floor`, where that is better) are
// collected, in `picked` (room for len positions), and warp 0 takes them in
// batches; a Cand's pos is its position in its own row (key_id gives its
// id). Warp 0 may still read the row on return.
template <int W, class ScoreOf, class IdOf>
__device__ __forceinline__ void take_filtered(Cand& list, const Cand& floor, Cand (*lists)[W],
                                              uint16_t* picked, int* count, int len, int k, int tid,
                                              ScoreOf score, IdOf id) {
  const int warp = tid >> 5, lane = tid & 31;
  uint32_t best_s = 0;                               // below every score's bits (−inf's: 0x007fffff)
  int best_e = -1;
  for (int e = tid; e < len; e += 32 * WARPS) {
    const uint32_t s = score_bits(score(e));
    if (s > best_s) {
      best_s = s;
      best_e = e;
    }
  }
  Cand best = best_e < 0 ? nothing()
                         : Cand{((uint64_t)best_s << 32) | id_bits(id(best_e)), (uint32_t)best_e};
  sort32(best, lane);
  Cand bar = block_kth(best, lists, k, warp, lane);
  if (ranks_before(floor, bar)) bar = floor;
  if (tid == 0) *count = 0;
  __syncthreads();
  const uint32_t bar_s = (uint32_t)(bar.key >> 32), bar_i = (uint32_t)bar.key;
  for (int e = tid; e < len; e += 32 * WARPS) {
    const uint32_t s = score_bits(score(e));
    if (s > bar_s || (s == bar_s && id_bits(id(e)) >= bar_i)) picked[atomicAdd(count, 1)] = (uint16_t)e;
  }
  __syncthreads();
  if (warp == 0) {
    const int m = *count;
    for (int i0 = 0; i0 < m; i0 += 32) {
      const int e = i0 + lane < m ? picked[i0 + lane] : -1;
      take_batch(list, nothing(), e < 0 ? nothing() : Cand{order_key(score(e), id(e)), (uint32_t)e}, k,
                 lane);
    }
  }
}

}  // namespace warptopk
