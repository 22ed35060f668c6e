// merge_join_counts and merge_join_pairs: the local sorted join's probe and
// range expansion, batched over segments.
//
// merge_join_counts replaces the TPU kernel `_kernel` /
// `merge_join_counts_pallas` in src/repro/kernels/merge_join.py.  The TPU
// version is a dense compare-reduce of every A tile against every B block,
// O(N·M) vector work with no data-dependent control flow, which its vector
// unit needs.  Threads on this card branch freely, so each thread takes one
// key of A and binary-searches its segment of B twice (lower and upper
// bound): O(N log M) work.  The result equals searchsorted on the
// sentinel-padded B, which is what the reference computes after clamping.
// Bound: memory at 4 bytes read and 8 written per A key plus B's reads, but
// the dependent loads of the search make it latency-bound in practice; B's
// top levels stay in L1/L2 across the threads of a segment.
//
// merge_join_pairs replaces `_pairs_kernel` / `merge_join_pairs_pallas` in
// the same file.  The TPU version telescopes a compare-reduce over every
// key block for every 256-slot output block (O(cap_out·N)).  Here each
// thread owns one output slot t and binary-searches its segment's `starts`
// for max{i : starts[i] <= t}, then reads lower and starts at that key.
// Bound: 8 bytes written per slot; the search reads are latency-bound as
// above.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// first index in [0, m) with b[i] >= key (left) or b[i] > key (right)
template <bool kRight>
__device__ __forceinline__ int bound(const int* __restrict__ b, int m, int key) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const int v = b[mid];
    if (kRight ? (v <= key) : (v < key)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void mj_counts(const int* __restrict__ a, const int* __restrict__ b,
                          int64_t n_segs, int n, int m,
                          int* __restrict__ lower, int* __restrict__ upper) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_segs * n) return;
  const int64_t seg = idx / n;
  const int* bs = b + seg * m;
  const int key = a[idx];
  lower[idx] = bound<false>(bs, m, key);
  upper[idx] = bound<true>(bs, m, key);
}

__global__ void mj_pairs(const int* __restrict__ lower, const int* __restrict__ starts,
                         int64_t n_segs, int n, int cap_out,
                         int* __restrict__ a_idx, int* __restrict__ b_idx) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_segs * cap_out) return;
  const int64_t seg = idx / cap_out;
  const int t = static_cast<int>(idx % cap_out);
  const int* st = starts + seg * n;
  int k = bound<true>(st, n, t) - 1;
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
// lower/upper (n_segs, n) int32.  Returns cudaGetLastError().
extern "C" int merge_join_counts_launch(const int* a, const int* b, int n_segs,
                                        int n, int m, int* lower, int* upper,
                                        void* stream) {
  const int64_t work = static_cast<int64_t>(n_segs) * n;
  if (work > 0) {
    mj_counts<<<blocks_for(work), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        a, b, n_segs, n, m, lower, upper);
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
