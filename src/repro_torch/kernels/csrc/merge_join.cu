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
// key block for every 256-slot output block (O(cap_out·N)).  Here each
// thread owns one output slot t and binary-searches its segment's `starts`
// for max{i : starts[i] <= t}, then reads lower and starts at that key.
// Bound: 8 bytes written per slot; the dependent loads of the search make
// it latency-bound in practice.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// first index in [0, m) with b[i] > key
__device__ __forceinline__ int upper_bound(const int* __restrict__ b, int m, int key) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (b[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

constexpr int kMergeThreads = 256;
constexpr int kItems = 11;                            // merge steps per thread
constexpr int kStretch = kMergeThreads * kItems;      // merge elements per block

// does a come before b in the merge?  Ties put A first for lower, B first
// for upper
template <bool kUpper>
__device__ __forceinline__ bool a_first(int a, int b) {
  return kUpper ? a < b : a <= b;
}

// The number of A keys among the first `diag` elements of the merge of a
// (n) and b (m): the first i in [max(0, diag - m), min(diag, n)) with
// !a_first(a[i], b[diag - 1 - i]), else the interval's end.  The predicate
// is true on a prefix, so each step probes 32 evenly spaced points, one per
// lane, and keeps the gap after the last true one.  Called by a whole warp.
template <bool kUpper>
__device__ int merge_path(const int* __restrict__ a, int n, const int* __restrict__ b, int m,
                          int64_t diag, int lane) {
  int64_t lo = diag > m ? diag - m : 0;
  int64_t hi = diag < n ? diag : n;
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t x = lo + lane * step;
    const bool t = x < hi && a_first<kUpper>(a[x], b[diag - 1 - x]);
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
    const int i = (warp & 2) ? merge_path<true>(a, n, b, m, diag, lane)
                             : merge_path<false>(a, n, b, m, diag, lane);
    if (lane == 0) split_s[warp] = i;
  }
  __syncthreads();
  merge_stretch<false>(a, b, d0, d1, split_s[0], split_s[1], lower + seg * n, keys_s, rank_s);
  merge_stretch<true>(a, b, d0, d1, split_s[2], split_s[3], upper + seg * n, keys_s, rank_s);
}

__global__ void mj_pairs(const int* __restrict__ lower, const int* __restrict__ starts,
                         int64_t n_segs, int n, int cap_out,
                         int* __restrict__ a_idx, int* __restrict__ b_idx) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_segs * cap_out) return;
  const int64_t seg = idx / cap_out;
  const int t = static_cast<int>(idx % cap_out);
  const int* st = starts + seg * n;
  int k = upper_bound(st, n, t) - 1;
  k = min(max(k, 0), n - 1);
  a_idx[idx] = k;
  b_idx[idx] = lower[seg * n + k] + (t - st[k]);
}

constexpr int kThreads = 256;

unsigned blocks_for(int64_t work) {
  return static_cast<unsigned>((work + kThreads - 1) / kThreads);
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

// lower, starts (n_segs, n) int32 with n >= 1; a_idx/b_idx (n_segs, cap_out)
// int32.  Returns cudaGetLastError().
extern "C" int merge_join_pairs_launch(const int* lower, const int* starts,
                                       int n_segs, int n, int cap_out,
                                       int* a_idx, int* b_idx, void* stream) {
  const int64_t work = static_cast<int64_t>(n_segs) * cap_out;
  if (work > 0) {
    mj_pairs<<<blocks_for(work), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        lower, starts, n_segs, n, cap_out, a_idx, b_idx);
  }
  return static_cast<int>(cudaGetLastError());
}
