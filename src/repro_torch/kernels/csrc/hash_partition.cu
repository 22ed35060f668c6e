// hash_partition_pack: the hash exchange's send side, batched over segments;
// hash_partition: partition id per key plus the global histogram.
//
// hash_partition_pack replaces the TPU kernel `_pack_kernel` /
// `hash_partition_pack_pallas` in src/repro/kernels/hash_partition.py.  For
// every row of every segment it computes the partition id under the uint32
// multiplicative mix (rows at or past the segment's valid count go to the
// ghost partition P), the row's stable rank among the rows of the same
// partition (its send slot), and the per-segment send counts.
//
// The TPU kernel carries a running per-partition base from one 1024-row tile
// to the next through its sequential grid.  Blocks on this card run in no
// fixed order, so the carry becomes a single-pass scan across each segment's
// tiles by decoupled look-back (Merrill & Garland): one kernel after one
// memset of its status words, one block per tile.
//   - Tiles follow blockIdx, tile-major across the segments (block b takes
//     tile b / S of segment b % S), as CUB's single-pass scan does: a tile
//     waits only on blocks of lower index, which the card dispatches first.
//     An atomic ticket would not depend on that, at the price of a
//     same-address atomic and its round trip at the head of every block.
//     Tile-major order spreads the blocks in flight over the segments, so
//     each looks back over few tiles still running.
//   - 256 threads load 4 rows each, coalesced; each warp ranks its 128
//     consecutive rows in 4 rounds of 32.  A lane sets its bit in a
//     per-(warp, bin) lane mask with a shared-memory atomicOr; the mask
//     gives the lane's peers, its rank is the popcount of the lower ones
//     plus the warp's running count of the bin (__match_any_sync would
//     find the peers too, but it is slow enough on this card to be what a
//     ranking built on it waits on).
//   - Partition ids are stored at once; one thread per bin sums the warps'
//     counts, publishes them as the tile's aggregate, looks back over the
//     earlier tiles of its segment (adding aggregates until it meets an
//     inclusive prefix), publishes its own inclusive prefix and turns the
//     warps' counts into bases; the segment's last tile writes the send
//     counts.  A status word packs its flag and value (0: not yet; bit 31
//     clear: aggregate + 1; bit 31 set: inclusive prefix), so one load reads
//     both.  slot = base + rank, stored coalesced.
// Stability (row order within a partition) is what keeps the exchanged rows
// byte-identical to the reference.
//
// Bound: memory.  A row costs 4 bytes of key read and 8 bytes of part + slot
// written (12 bytes); every row is read and written once, and the status
// words add (P+1)·4 bytes per 1024 rows.  At the join path's sizes (1-16
// tiles a segment, one wave of blocks) what remains is one block's latency:
// load, rank, look back, store.

// hash_partition replaces the TPU kernel `_kernel` / `hash_partition_pallas`
// in the same file.  The TPU kernel writes a (N/1024, P) per-tile histogram
// (a one-hot sum, since the TPU has no atomics) and the public op pads N to a
// multiple of 1024 with zero keys, sums the tiles and subtracts the padding's
// share.  Here one pass after a memset of the (P,) histogram does it all,
// over a grid that fills every SM (8 blocks of 256 threads on each):
//   - each thread reads 4 keys in one 16-byte load and writes their 4
//     partition ids in one 16-byte store, in a grid-stride loop; a scalar
//     head and tail take the elements before the first 16-byte boundary of
//     the keys and after the last whole group of 4 (the wrapper places the
//     ids at the keys' offset modulo 16 bytes, so one boundary serves both);
//   - ids are counted in shared memory by atomicAdd into per-warp private
//     bins (one set per block where 8 sets of P bins would not fit), not by
//     ranking lanes with __match_any_sync, which is slow on this card;
//   - each block adds every non-empty bin to the global histogram with one
//     integer atomicAdd; integer atomics commute, so the histogram is exact
//     whatever the order.
// Bound: memory, 4 bytes of key read and 4 bytes of id written per key
// (8·N + 4·P bytes).  At 2M keys the 16 MB fit in the 50 MB L2, and what is
// left is the launch, the memset and the flush.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;     // rows per tile of hash_partition_pack

__device__ __forceinline__ uint32_t mix_u32(uint32_t k) {
  uint32_t h = (k ^ (k >> 16)) * 2654435761u;
  h = (h ^ (h >> 13)) * 0x9E3779B9u;
  return h ^ (h >> 16);
}

constexpr int kPackThreads = 256;
constexpr int kPackWarps = kPackThreads / 32;
constexpr int kRowsPerThread = kTile / kPackThreads;
constexpr unsigned kPrefix = 0x80000000u;     // status flag: inclusive prefix
constexpr size_t kDefaultSmem = 48 * 1024;    // dynamic shared memory without the opt-in
constexpr size_t kPackSmemMax = 232448;       // a block's most after the opt-in (227 KB)

__device__ __forceinline__ unsigned load_status(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

// One block per 1024-row tile; block b takes tile b / n_segs of segment
// b % n_segs, so a tile waits only on blocks of lower index.  status:
// (n_segs, n_tiles, n_parts + 1) words, zeroed.
__global__ void __launch_bounds__(kPackThreads, 2048 / kPackThreads)
hp_pack(const int* __restrict__ keys, const int* __restrict__ counts, int n_segs, int n,
        int n_parts, int n_tiles, unsigned* __restrict__ status, int* __restrict__ part_out,
        int* __restrict__ slot_out, int* __restrict__ send_counts) {
  // warp_cnt (kPackWarps, nb): each warp's running count per bin, then the
  // bases of its rows; lane_mask (2, kPackWarps, nb): the lanes of each bin
  // in the current round, alternate rounds alternating
  extern __shared__ int warp_cnt[];
  const int nb = n_parts + 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = static_cast<int>(blockIdx.x / n_segs);
  const int seg = static_cast<int>(blockIdx.x % n_segs);
  unsigned* lane_mask = reinterpret_cast<unsigned*>(warp_cnt + kPackWarps * nb);
  for (int i = tid; i < 3 * kPackWarps * nb; i += kPackThreads) warp_cnt[i] = 0;
  const int count = counts[seg];
  const int64_t base = static_cast<int64_t>(seg) * n;
  // each warp ranks 128 consecutive rows, 32 at a time (coalesced loads)
  const int64_t row0 = static_cast<int64_t>(tile) * kTile + warp * 32 * kRowsPerThread + lane;
  int key[kRowsPerThread], part_rank[kRowsPerThread];   // part | rank << 16
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int64_t row = row0 + r * 32;
    key[r] = row < n ? keys[base + row] : 0;
  }
  __syncthreads();
  int* cnt = warp_cnt + warp * nb;         // this warp's running count per bin
  const unsigned lower_lanes = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int64_t row = row0 + r * 32;
    // rows past the array end form their own group (id nb) and write nothing
    const int p = row >= n ? nb
                : row >= count ? n_parts
                : static_cast<int>(mix_u32(static_cast<uint32_t>(key[r])) %
                                   static_cast<uint32_t>(n_parts));
    // this round's lanes of each bin: each lane sets its bit; the leader
    // clears the mask, which the round after next reuses
    unsigned* mask = lane_mask + (r & 1) * kPackWarps * nb + warp * nb;
    if (p < nb) atomicOr(&mask[p], 1u << lane);
    __syncwarp();
    const unsigned peers = p < nb ? mask[p] : 0u;
    const int before = p < nb ? cnt[p] : 0;
    __syncwarp();
    if (p < nb && lane == __ffs(peers) - 1) {
      cnt[p] = before + __popc(peers);
      mask[p] = 0u;
    }
    part_rank[r] = p | (before + __popc(peers & lower_lanes)) << 16;
    if (row < n) part_out[base + row] = p;   // slots wait for the look-back
  }
  __syncthreads();

  for (int b = tid; b < nb; b += kPackThreads) {
    int agg = 0;
#pragma unroll
    for (int w = 0; w < kPackWarps; ++w) agg += warp_cnt[w * nb + b];
    unsigned* mine = status + (static_cast<int64_t>(seg) * n_tiles + tile) * nb + b;
    int run = 0;                           // rows of bin b in the segment's earlier tiles
    if (tile > 0) {
      store_status(mine, static_cast<unsigned>(agg) + 1u);
      for (const unsigned* prev = mine - nb;; prev -= nb) {
        unsigned w;
        while ((w = load_status(prev)) == 0u) {
        }
        if (w & kPrefix) {
          run += static_cast<int>(w & ~kPrefix);
          break;
        }
        run += static_cast<int>(w - 1u);
      }
    }
    store_status(mine, kPrefix | static_cast<unsigned>(run + agg));
    if (tile == n_tiles - 1 && b < n_parts) send_counts[seg * n_parts + b] = run + agg;
#pragma unroll
    for (int w = 0; w < kPackWarps; ++w) {
      const int c = warp_cnt[w * nb + b];
      warp_cnt[w * nb + b] = run;
      run += c;
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int64_t row = row0 + r * 32;
    if (row < n) slot_out[base + row] = cnt[part_rank[r] & 0xffff] + (part_rank[r] >> 16);
  }
}

// hash_partition_pack for any P (the wide path).  Per-warp bins of P + 1
// counters stop fitting a block's 227 KB of shared memory at P = 2421, so
// above that the per-tile histograms live in global memory:
//   1. hp_wide_rank, one block per (segment, tile): each row's partition id
//      (stored), then a bitonic sort of the tile's 1024 (part, row) pairs in
//      shared memory; a row's rank in its tile is its sorted position less
//      the start of its part's run (a binary search of the sorted pairs),
//      stored in slot; the last row of each run writes the run's length to
//      the tile's histogram entry of that part;
//   2. hp_wide_scan, one thread per (segment, part), turns the tile counts
//      into exclusive bases over the segment's tiles in place and writes
//      the send counts;
//   3. hp_wide_slot adds each row's tile base to its rank.
// Rows are sorted with their index, so the rank is stable and the slots are
// the single-block path's (and the reference's).  Bound: memory, as the
// single-block path, plus the (S, tiles, P + 1) histogram read and written
// twice.
constexpr int kWideThreads = 256;
constexpr int kWideRows = kTile / kWideThreads;

__global__ void __launch_bounds__(kWideThreads)
hp_wide_rank(const int* __restrict__ keys, const int* __restrict__ counts, int n_segs, int n,
             int n_parts, int n_tiles, int* __restrict__ tile_hist, int* __restrict__ part_out,
             int* __restrict__ slot_out) {
  __shared__ unsigned long long pairs[kTile];   // part << 32 | row in the tile
  const int tid = threadIdx.x;
  const int seg = static_cast<int>(blockIdx.x % n_segs);
  const int tile = static_cast<int>(blockIdx.x / n_segs);
  const int count = counts[seg];
  const int64_t base = static_cast<int64_t>(seg) * n;
  const int64_t row0 = static_cast<int64_t>(tile) * kTile;
  const unsigned long long past_end = static_cast<unsigned long long>(n_parts) + 1;
#pragma unroll
  for (int r = 0; r < kWideRows; ++r) {
    const int loc = tid + r * kWideThreads;
    const int64_t row = row0 + loc;
    unsigned long long p = past_end;     // rows past the array end sort last, write nothing
    if (row < n) {
      p = row >= count ? static_cast<unsigned long long>(n_parts)
                       : mix_u32(static_cast<uint32_t>(keys[base + row])) %
                             static_cast<uint32_t>(n_parts);
      part_out[base + row] = static_cast<int>(p);
    }
    pairs[loc] = p << 32 | static_cast<unsigned>(loc);
  }
  __syncthreads();
  for (int k = 2; k <= kTile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int r = 0; r < kWideRows; ++r) {
        const int i = tid + r * kWideThreads, ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = pairs[i], b = pairs[ixj];
          if ((a > b) == ((i & k) == 0)) {
            pairs[i] = b;
            pairs[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  int* hist = tile_hist + (static_cast<int64_t>(seg) * n_tiles + tile) * (n_parts + 1LL);
#pragma unroll
  for (int r = 0; r < kWideRows; ++r) {
    const int i = tid + r * kWideThreads;
    const unsigned long long pr = pairs[i];
    const unsigned long long p = pr >> 32;
    if (p == past_end) continue;
    int lo = 0, hi = i;                  // first sorted position of part p
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((pairs[mid] >> 32) < p) lo = mid + 1; else hi = mid;
    }
    const int loc = static_cast<int>(pr & 0xffffffffu);
    slot_out[base + row0 + loc] = i - lo;
    if (i == kTile - 1 || (pairs[i + 1] >> 32) != p) hist[p] = i - lo + 1;
  }
}

__global__ void __launch_bounds__(kWideThreads)
hp_wide_scan(int n_segs, int n_parts, int n_tiles, int* __restrict__ tile_hist,
             int* __restrict__ send_counts) {
  const int64_t nb = static_cast<int64_t>(n_parts) + 1;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWideThreads + threadIdx.x;
  if (i >= n_segs * nb) return;
  const int64_t seg = i / nb, b = i % nb;
  int* h = tile_hist + seg * n_tiles * nb + b;
  int run = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int c = h[t * nb];
    h[t * nb] = run;
    run += c;
  }
  if (b < n_parts) send_counts[seg * n_parts + b] = run;
}

__global__ void __launch_bounds__(kWideThreads)
hp_wide_slot(int n_segs, int n, int n_parts, int n_tiles, const int* __restrict__ tile_hist,
             const int* __restrict__ part_out, int* __restrict__ slot_out) {
  const int seg = static_cast<int>(blockIdx.x % n_segs);
  const int tile = static_cast<int>(blockIdx.x / n_segs);
  const int64_t base = static_cast<int64_t>(seg) * n;
  const int* bases = tile_hist + (static_cast<int64_t>(seg) * n_tiles + tile) * (n_parts + 1LL);
#pragma unroll
  for (int r = 0; r < kWideRows; ++r) {
    const int64_t row = static_cast<int64_t>(tile) * kTile + threadIdx.x + r * kWideThreads;
    if (row < n) slot_out[base + row] += bases[part_out[base + row]];
  }
}

constexpr int kHistThreads = 256;
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kHistBlocksPerSm = 2048 / kHistThreads;
constexpr int kHistSmem = 48 * 1024;      // the default dynamic shared memory of a block

// keys [0, head) and [body_end, n) one at a time, [head, body_end) 4 at a
// time (keys + head and part_out + head 16-byte aligned).  bins: per_warp ?
// (kHistWarps, n_parts) : (n_parts,).
__global__ void __launch_bounds__(kHistThreads)
hp_partition_hist(const int* __restrict__ keys, int n, int n_parts, int head, int body_end,
                  int per_warp, int* __restrict__ part_out, int* __restrict__ hist) {
  extern __shared__ int bins[];
  const int sets = per_warp ? kHistWarps : 1;
  for (int b = threadIdx.x; b < sets * n_parts; b += kHistThreads) bins[b] = 0;
  __syncthreads();
  int* mine = bins + (per_warp ? (threadIdx.x >> 5) * n_parts : 0);
  const uint32_t parts = static_cast<uint32_t>(n_parts);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kHistThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kHistThreads;
  auto one = [&](int64_t i) {
    const int p = static_cast<int>(mix_u32(static_cast<uint32_t>(keys[i])) % parts);
    part_out[i] = p;
    atomicAdd(&mine[p], 1);
  };
  for (int64_t i = first; i < head; i += stride) one(i);
  const int4* k4 = reinterpret_cast<const int4*>(keys + head);
  int4* p4 = reinterpret_cast<int4*>(part_out + head);
  const int64_t n4 = (body_end - head) / 4;
  for (int64_t v = first; v < n4; v += stride) {
    const int4 k = __ldg(k4 + v);
    int4 p;
    p.x = static_cast<int>(mix_u32(static_cast<uint32_t>(k.x)) % parts);
    p.y = static_cast<int>(mix_u32(static_cast<uint32_t>(k.y)) % parts);
    p.z = static_cast<int>(mix_u32(static_cast<uint32_t>(k.z)) % parts);
    p.w = static_cast<int>(mix_u32(static_cast<uint32_t>(k.w)) % parts);
    p4[v] = p;
    atomicAdd(&mine[p.x], 1);
    atomicAdd(&mine[p.y], 1);
    atomicAdd(&mine[p.z], 1);
    atomicAdd(&mine[p.w], 1);
  }
  for (int64_t i = body_end + first; i < n; i += stride) one(i);
  __syncthreads();
  for (int b = threadIdx.x; b < n_parts; b += kHistThreads) {
    int c = 0;
    for (int w = 0; w < sets; ++w) c += bins[w * n_parts + b];
    if (c != 0) atomicAdd(&hist[b], c);
  }
}

}  // namespace

// keys (n,) int32 → part (n,) int32 and hist (n_parts,) int32, which this
// call zeroes before the kernel adds into it; n_parts bins must fit 48 KB of
// shared memory.  Where keys and part lie at the same offset modulo 16 bytes
// the body goes 4 keys at a time, else one at a time.  Returns
// cudaGetLastError().
extern "C" int hash_partition_launch(const int* keys, int n, int n_parts, int* part,
                                     int* hist, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(hist, 0, sizeof(int) * n_parts, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const uintptr_t kp = reinterpret_cast<uintptr_t>(keys);
    int head = 0, body_end = 0;             // all one at a time
    if (((kp ^ reinterpret_cast<uintptr_t>(part)) & 15) == 0) {
      head = std::min<int>(n, static_cast<int>((16 - (kp & 15)) & 15) / 4);
      body_end = head + (n - head) / 4 * 4;
    }
    const int per_warp = kHistWarps * n_parts * static_cast<int>(sizeof(int)) <= kHistSmem;
    const size_t smem = sizeof(int) * (per_warp ? kHistWarps : 1) * n_parts;
    const int blocks = static_cast<int>(std::min<int64_t>(
        (static_cast<int64_t>(n) + 4 * kHistThreads - 1) / (4 * kHistThreads),
        static_cast<int64_t>(std::max(sms, 1)) * kHistBlocksPerSm));
    hp_partition_hist<<<blocks, kHistThreads, smem, st>>>(keys, n, n_parts, head, body_end,
                                                           per_warp, part, hist);
  }
  return static_cast<int>(cudaGetLastError());
}

// keys (n_segs, n) int32; counts (n_segs,) int32; outputs part, slot
// (n_segs, n) and send_counts (n_segs, n_parts) int32; scratch
// n_segs · max(1, ceil(n / 1024)) · (n_parts + 1) int32 status words, zeroed
// here; 96 · (n_parts + 1) bytes of shared memory a block, at most
// kPackSmemMax (n_parts <= 2420).  N = 0 still launches, one empty tile per
// segment, which writes zero send counts.  Returns cudaGetLastError().
extern "C" int hash_partition_pack_launch(const int* keys, const int* counts,
                                          int n_segs, int n, int n_parts,
                                          int* part, int* slot, int* send_counts,
                                          int* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = std::max(1, (n + kTile - 1) / kTile);
  const int nb = n_parts + 1;
  const int64_t blocks = static_cast<int64_t>(n_segs) * n_tiles;
  if (blocks > 0) {
    const size_t smem = sizeof(int) * 3 * kPackWarps * nb;
    if (smem > kPackSmemMax) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > kDefaultSmem) {
      cudaError_t err = cudaFuncSetAttribute(hp_pack, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
      if (err != cudaSuccess) {
        cudaGetLastError();   // clear it, so that the next launch reports its own
        return static_cast<int>(err);
      }
    }
    cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(int) * blocks * nb, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    hp_pack<<<static_cast<unsigned>(blocks), kPackThreads, smem, st>>>(
        keys, counts, n_segs, n, n_parts, n_tiles, reinterpret_cast<unsigned*>(scratch), part,
        slot, send_counts);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same contract as hash_partition_pack_launch, for any n_parts >= 1:
// the scratch holds the (n_segs, n_tiles, n_parts + 1) tile histograms.
// Three launches after one memset (hp_wide_rank, hp_wide_scan,
// hp_wide_slot).  Returns cudaGetLastError().
extern "C" int hash_partition_pack_wide_launch(const int* keys, const int* counts,
                                               int n_segs, int n, int n_parts,
                                               int* part, int* slot, int* send_counts,
                                               int* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = std::max(1, (n + kTile - 1) / kTile);
  const int64_t nb = static_cast<int64_t>(n_parts) + 1;
  const int64_t blocks = static_cast<int64_t>(n_segs) * n_tiles;
  if (blocks > 0) {
    cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(int) * blocks * nb, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    hp_wide_rank<<<static_cast<unsigned>(blocks), kWideThreads, 0, st>>>(
        keys, counts, n_segs, n, n_parts, n_tiles, scratch, part, slot);
    const int64_t scan_blocks = (static_cast<int64_t>(n_segs) * nb + kWideThreads - 1) /
                                kWideThreads;
    hp_wide_scan<<<static_cast<unsigned>(scan_blocks), kWideThreads, 0, st>>>(
        n_segs, n_parts, n_tiles, scratch, send_counts);
    if (n > 0) {
      hp_wide_slot<<<static_cast<unsigned>(blocks), kWideThreads, 0, st>>>(
          n_segs, n, n_parts, n_tiles, scratch, part, slot);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
