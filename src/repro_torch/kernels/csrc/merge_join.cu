// merge_join_counts and merge_join_pairs: the local sorted join's probe and
// range expansion, batched over segments.
//
// merge_join_counts replaces the TPU kernel `_kernel` /
// `merge_join_counts_pallas` in src/repro/kernels/merge_join.py.  The TPU
// version is a dense compare-reduce of every A tile against every B block,
// O(N·M) vector work with no data-dependent control flow, which its vector
// unit needs.  The result equals searchsorted on the sentinel-padded B,
// which is what the reference computes after clamping.
// Bound: bytes, 4 read per key of A and of B and 8 written per key of A.
// Both rows are sorted, so the bounds of all of A come out of one merge of
// the two rows (a sorted search): lower[i] is the number of B keys before
// a_i in the merge when ties put A first (B < a_i), upper[i] the same when
// ties put B first (B <= a_i).  Design:
//   - each block owns one 2816-element stretch of the merge of one segment
//     (where keys tie, its ends on A and on B differ between the two tie
//     rules);
//   - four warps find where the stretch starts and ends on A and on B, for
//     both tie rules at once, by merge-path searches along its two
//     diagonals, 32-ary (a warp probes 32 points per step: 4-5 dependent
//     steps for 2^20 keys, not 20).  A stretch thus holds 2816 keys of A
//     and B together whatever N : M is (a hub key repeated across all of B,
//     N = 1 or M = 1);
//   - for lower, then for upper, the block stages its A and B slices in
//     shared memory with coalesced loads (the second time mostly from L2);
//     each thread finds its 11-element substretch by a binary search in
//     shared memory, merges it serially and writes each A key's B co-rank
//     to shared memory; the block stores those coalesced.  An odd count of
//     steps keeps the threads' positions off a power-of-two stride, so
//     fewer of their shared-memory reads collide in a bank (a sweep of 7-13
//     on the card chose 11).
// What the kernel waits on is latency, not bytes: each block waits on its
// searches' dependent loads, then on its loads, so one search serves both
// merges.  One launch: a grid of S × ceil((N + M) / 2816) blocks.  Each
// key is read about twice (once per tie rule), against the log2(M)
// dependent reads per key of a binary search.
//
// merge_join_pairs replaces `_pairs_kernel` / `merge_join_pairs_pallas` in
// the same file.  The TPU version telescopes a compare-reduce over every
// key block for every 256-slot output block (O(cap_out·N)).  The function is
// the inverse of an exclusive prefix sum: a_idx[t] = max{i : starts[i] <= t},
// which is the merge of `starts` with the slots 0, 1, ..., cap_out - 1, ties
// putting the key first (moderngpu's load-balancing search).  Bound: bytes,
// 8 written per slot plus lower and starts at the selected keys; a design
// that reads `starts` once over the slots' range reads every key before the
// last slot, most of them keys with no match.  A binary search per slot
// would wait on ~20 dependent loads per slot over a row far past the L2,
// repeated by neighbouring slots.  Design:
//   - the keys whose start equals the last one, starts[N-1] (the sentinels
//     and the last key), select every slot t >= starts[N-1]: "tail" blocks
//     write those slots as key N-1 directly and never read that run.  The
//     rest is the merge of `starts` with the slots [0, c), c =
//     clamp(starts[N-1], 0, cap_out), in which the run lies past every slot;
//   - each "merge" block owns one 2816-element stretch of that merge, found
//     by the same 32-ary merge-path search as mj_counts, with the slots as an
//     implicit B side that is never loaded.  A block whose first element is
//     a key past every slot (one load tells) exits at once, so the run and,
//     where total > cap_out, the keys after the last slot cost no staging;
//   - the block stages its keys' starts in shared memory (each thread's 11
//     loads in flight at once).  The last key of each start value marks the
//     slot at its start, and a block-wide running maximum over the slots
//     (serial over 11 slots a thread, then a warp scan and the warps'
//     carries) gives every slot its key, with no data-dependent branch (a
//     serial walk of the merge, as mj_counts does, branches at every step,
//     and here, with few slots among many keys, its instructions are what
//     the block waits on).  The block then stores a_idx and b_idx
//     = lower[k] + (t - starts[k]) coalesced, gathering lower at the
//     selected keys; b_idx wraps to int32 as the plain version's int64 sum
//     does (unsigned arithmetic, no signed overflow).  A stretch holds at
//     most 2816 keys and slots whatever their ratio: a hub key owning all
//     cap_out slots spans many stretches, and a run of zero-count keys is
//     one of keys only.
// What the kernel waits on is the latency of each block's chain (the last
// start, the exit test, 4 search steps, the staging, the gather), not bytes,
// so the block is held to 32 registers and 11 KB of shared memory: 8 blocks,
// 2048 threads, fill an SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMergeThreads = 256;
constexpr int kItems = 11;                            // merge elements per thread
constexpr int kStretch = kMergeThreads * kItems;      // merge elements per block

// does a come before b in the merge?  Ties put A first for lower, B first
// for upper
template <bool kUpper, class T>
__device__ __forceinline__ bool a_first(T a, T b) {
  return kUpper ? a < b : a <= b;
}

// The B side of a merge: a sorted row in memory, or the counting sequence
// 0, 1, 2, ... (the output slots of merge_join_pairs), which needs no load.
struct RowB {
  const int* b;
  __device__ __forceinline__ int operator()(int64_t j) const { return b[j]; }
};
struct CountB {
  __device__ __forceinline__ int64_t operator()(int64_t j) const { return j; }
};

// The number of A keys among the first `diag` elements of the merge of a
// (n) and b (m): the first i in [max(0, diag - m), min(diag, n)) with
// !a_first(a[i], b[diag - 1 - i]), else the interval's end.  The predicate
// is true on a prefix, so each step probes 32 evenly spaced points, one per
// lane, and keeps the gap after the last true one.  Called by a whole warp.
template <bool kUpper, class B>
__device__ int merge_path(const int* __restrict__ a, int n, B b, int64_t m, int64_t diag,
                          int lane) {
  using T = decltype(b(0));
  int64_t lo = diag > m ? diag - m : 0;
  int64_t hi = diag < n ? diag : n;
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t x = lo + lane * step;
    const bool t = x < hi && a_first<kUpper>(static_cast<T>(a[x]), b(diag - 1 - x));
    const int trues = __popc(__ballot_sync(0xffffffffu, t));
    if (trues == 0) break;
    const int64_t last = lo + (trues - 1) * step;
    lo = last + 1;
    hi = min(last + step, hi);
  }
  return static_cast<int>(lo);
}

// One tie rule's merge of the stretch [d0, d1), which starts at a[i0] and
// ends before a[i1] (the split found by merge_path): stage the A and B
// slices in keys_s, merge 11 steps per thread, store the A keys' B co-ranks
// (staged in rank_s) to co_rank[i0, i1).  Called by the whole block.
template <bool kUpper>
__device__ void merge_stretch(const int* __restrict__ a, const int* __restrict__ b,
                              int64_t d0, int64_t d1, int i0, int i1,
                              int* __restrict__ co_rank, int* keys_s, int* rank_s) {
  const int tid = threadIdx.x;
  const int na = i1 - i0;
  const int j0 = static_cast<int>(d0 - i0), nb = static_cast<int>(d1 - d0) - na;
  for (int x = tid; x < na; x += kMergeThreads) keys_s[x] = a[i0 + x];
  for (int x = tid; x < nb; x += kMergeThreads) keys_s[na + x] = b[j0 + x];
  __syncthreads();

  const int* a_s = keys_s;
  const int* b_s = keys_s + na;
  const int diag = min(tid * kItems, na + nb);
  int lo = max(0, diag - nb), hi = min(diag, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a_first<kUpper>(a_s[mid], b_s[diag - 1 - mid])) lo = mid + 1; else hi = mid;
  }
  int i = lo, j = diag - lo;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    if (i + j >= na + nb) break;
    if (j >= nb || (i < na && a_first<kUpper>(a_s[i], b_s[j]))) {
      rank_s[i++] = j0 + j;
    } else {
      ++j;
    }
  }
  __syncthreads();                    // keys_s is free again; rank_s is complete
  for (int x = tid; x < na; x += kMergeThreads) co_rank[i0 + x] = rank_s[x];
}

// One block per stretch: warps 0-3 find the stretch's splits on both of its
// diagonals under both tie rules at once, then the block merges it for
// lower and then for upper.  (The upper staging may overwrite keys_s while
// slower threads still store lower's co-ranks: those read rank_s only, and
// the upper merge writes rank_s after the next barrier.)
__global__ void __launch_bounds__(kMergeThreads)
mj_counts(const int* __restrict__ a, const int* __restrict__ b, int n, int m,
          int64_t stretches, int* __restrict__ lower, int* __restrict__ upper) {
  __shared__ int keys_s[kStretch], rank_s[kStretch], split_s[4];
  const int64_t seg = blockIdx.x / stretches;
  const int64_t d0 = (blockIdx.x % stretches) * kStretch;
  const int64_t d1 = min(d0 + kStretch, static_cast<int64_t>(n) + m);
  a += seg * n;
  b += seg * m;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 4) {
    const int64_t diag = (warp & 1) ? d1 : d0;
    const int i = (warp & 2) ? merge_path<true>(a, n, RowB{b}, m, diag, lane)
                             : merge_path<false>(a, n, RowB{b}, m, diag, lane);
    if (lane == 0) split_s[warp] = i;
  }
  __syncthreads();
  merge_stretch<false>(a, b, d0, d1, split_s[0], split_s[1], lower + seg * n, keys_s, rank_s);
  merge_stretch<true>(a, b, d0, d1, split_s[2], split_s[3], upper + seg * n, keys_s, rank_s);
}

// One block per stretch of the merge of one segment's starts with its slots
// [0, c) ("merge" blocks, the first `merge_blocks` of each segment), or per
// kStretch slots from c on ("tail" blocks, the rest): see the note above.
__global__ void __launch_bounds__(kMergeThreads, 2048 / kMergeThreads)
mj_pairs(const int* __restrict__ lower, const int* __restrict__ starts, int n, int cap_out,
         int64_t merge_blocks, int64_t seg_blocks, int* __restrict__ a_idx,
         int* __restrict__ b_idx) {
  // the stretch's na keys' starts, then its ns slots' keys (na + ns <= kStretch)
  __shared__ int stage_s[kStretch];
  __shared__ int split_s[2], carry_s[kMergeThreads / 32], prev_start_s;
  const int64_t seg = blockIdx.x / seg_blocks;
  const int64_t blk = blockIdx.x % seg_blocks;
  const int tid = threadIdx.x;
  lower += seg * n;
  starts += seg * n;
  a_idx += seg * cap_out;
  b_idx += seg * cap_out;
  const int last = starts[n - 1];
  const int c = last <= 0 ? 0 : min(last, cap_out);

  if (blk >= merge_blocks) {                  // slots t >= c select key n - 1
    const int64_t t0 = (blk - merge_blocks) * kStretch;
    const int64_t t1 = min(t0 + kStretch, static_cast<int64_t>(cap_out));
    if (t1 <= c) return;
    const unsigned base = static_cast<unsigned>(lower[n - 1]) - static_cast<unsigned>(last);
    for (int64_t t = max(t0, static_cast<int64_t>(c)) + tid; t < t1; t += kMergeThreads) {
      a_idx[t] = n - 1;
      b_idx[t] = static_cast<int>(base + static_cast<unsigned>(t));
    }
    return;
  }

  const int64_t total = static_cast<int64_t>(n) + c;
  const int64_t d0 = blk * kStretch;
  if (d0 >= total) return;
  // key d0 - c sits at merge position d0 exactly when it precedes no slot
  // (starts >= c): then so does every later key, and the stretch holds none
  if (d0 >= c && starts[d0 - c] >= c) return;
  const int64_t d1 = min(d0 + kStretch, total);
  const int warp = tid >> 5, lane = tid & 31;
  if (warp < 2) {
    const int i = merge_path<false>(starts, n, CountB{}, c, warp ? d1 : d0, lane);
    if (lane == 0) split_s[warp] = i;
  }
  __syncthreads();
  const int i0 = split_s[0], i1 = split_s[1];
  const int na = i1 - i0;
  const int ns = static_cast<int>(d1 - d0) - na;
  const int64_t j0 = d0 - i0;                // the stretch's first slot
  int* keys_s = stage_s;
  int* key_of_s = stage_s + na;
  {                                          // all of a thread's loads in flight at once
    int v[kItems];
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int x = tid + q * kMergeThreads;
      if (x < na) v[q] = starts[i0 + x];
    }
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int x = tid + q * kMergeThreads;
      if (x < na) keys_s[x] = v[q];
      if (x < ns) key_of_s[x] = -1;
    }
  }
  if (tid == 0) prev_start_s = starts[max(i0 - 1, 0)];
  __syncthreads();

  // Slot t belongs to the last key whose start is <= t.  The last key of
  // each start value in the stretch marks the slot at its start (every key
  // here has clamp(start, 0, c) in [j0, j0 + ns]); a running maximum over
  // the slots then gives each slot its key, the key before the stretch
  // where no mark precedes it (-1, clipped to key 0, where there is none).
  for (int x = tid; x < na; x += kMergeThreads) {
    const int st = keys_s[x];
    if (x + 1 < na && keys_s[x + 1] == st) continue;
    const int64_t at =
        min(max(static_cast<int64_t>(st), int64_t{0}), static_cast<int64_t>(c)) - j0;
    if (at < ns) atomicMax(&key_of_s[at], i0 + x);
  }
  __syncthreads();
  const int x0 = tid * kItems;           // this thread's slots, consecutive
  int m = -1;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    if (x0 + q < ns) m = max(m, key_of_s[x0 + q]);
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, m, o);
    if (lane >= o) m = max(m, up);
  }
  if (lane == 31) carry_s[warp] = m;
  const int lane_before = __shfl_up_sync(0xffffffffu, m, 1);
  __syncthreads();
  int run = max(i0 - 1, lane > 0 ? lane_before : -1);
  for (int w = 0; w < warp; ++w) run = max(run, carry_s[w]);
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    if (x0 + q < ns) {
      run = max(run, key_of_s[x0 + q]);
      key_of_s[x0 + q] = max(run, 0);
    }
  }
  __syncthreads();

  int k[kItems], lo_k[kItems];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int x = tid + q * kMergeThreads;
    if (x < ns) {
      k[q] = key_of_s[x];
      lo_k[q] = lower[k[q]];
    }
  }
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int x = tid + q * kMergeThreads;
    if (x < ns) {
      const int st = k[q] >= i0 && k[q] < i1 ? keys_s[k[q] - i0] : prev_start_s;
      a_idx[j0 + x] = k[q];
      b_idx[j0 + x] = static_cast<int>(static_cast<unsigned>(lo_k[q]) +
                                       static_cast<unsigned>(j0 + x) - static_cast<unsigned>(st));
    }
  }
}

}  // namespace

// a (n_segs, n), b (n_segs, m) int32, each row sorted ascending;
// lower/upper (n_segs, n) int32.  Returns cudaGetLastError() (or
// cudaErrorInvalidValue when the grid would pass 2^31 - 1 blocks).
extern "C" int merge_join_counts_launch(const int* a, const int* b, int n_segs,
                                        int n, int m, int* lower, int* upper,
                                        void* stream) {
  const int64_t stretches = (static_cast<int64_t>(n) + m + kStretch - 1) / kStretch;
  const int64_t blocks = stretches * n_segs;
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(n_segs) * n > 0) {
    mj_counts<<<static_cast<unsigned>(blocks), kMergeThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(a, b, n, m, stretches, lower, upper);
  }
  return static_cast<int>(cudaGetLastError());
}

// lower, starts (n_segs, n) int32 with n >= 1, each starts row sorted
// ascending; a_idx/b_idx (n_segs, cap_out) int32.  Returns
// cudaGetLastError() (or cudaErrorInvalidValue when the grid would pass
// 2^31 - 1 blocks).
extern "C" int merge_join_pairs_launch(const int* lower, const int* starts,
                                       int n_segs, int n, int cap_out,
                                       int* a_idx, int* b_idx, void* stream) {
  const int64_t merge_blocks =
      (static_cast<int64_t>(n) + cap_out + kStretch - 1) / kStretch;
  const int64_t seg_blocks =
      merge_blocks + (static_cast<int64_t>(cap_out) + kStretch - 1) / kStretch;
  const int64_t blocks = seg_blocks * n_segs;
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(n_segs) * cap_out > 0) {
    mj_pairs<<<static_cast<unsigned>(blocks), kMergeThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(lower, starts, n, cap_out, merge_blocks,
                                                     seg_blocks, a_idx, b_idx);
  }
  return static_cast<int>(cudaGetLastError());
}
