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
// order, so the carry becomes three passes:
//   1. hp_tile_hist  — per (segment, tile) a (P+1)-bin histogram in shared
//                      memory (shared-memory atomics);
//   2. hp_tile_scan  — per (segment, bin) an exclusive scan over the tiles,
//                      in place, plus the segment's send counts;
//   3. hp_tile_rank  — per tile a stable rank: every warp ranks its lanes
//                      with __match_any_sync and a popcount of the lower-lane
//                      mask, the per-warp bin counts are scanned across the
//                      block's warps in shared memory, and
//                      slot = tile base + warp base + lane rank.
// Stability (row order within a partition) is what keeps the exchanged rows
// byte-identical to the reference.
//
// Bound: memory.  A row costs 4 bytes of key read and 8 bytes of part + slot
// written (12 bytes); pass 3 reads the key a second time and the tile
// histograms are (P+1)·4 bytes per 1024 rows.  The design keeps every
// per-row access coalesced and all ranking in registers and shared memory.
//
// hash_partition replaces the TPU kernel `_kernel` / `hash_partition_pallas`
// in the same file.  The TPU kernel writes a (N/1024, P) per-tile histogram
// (a one-hot sum, since the TPU has no atomics) and the public op pads N to a
// multiple of 1024 with zero keys, sums the tiles and subtracts the padding's
// share.  Here one pass does it all: each thread hashes keys in a grid-stride
// loop and writes their partition ids; every warp aggregates its lanes'
// equal ids (__match_any_sync) into one shared-memory add per distinct id;
// each block then adds its P bins into the zeroed (P,) global histogram with
// one integer atomicAdd per bin.  Integer atomics commute, so the histogram
// is exact whatever the order.  Keys at or past N are masked off, not hashed.
// Bound: memory, 4 bytes of key read and 4 bytes of id written per key.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;     // rows per tile == threads per block in pass 3
constexpr int kWarps = kTile / 32;

__device__ __forceinline__ uint32_t mix_u32(uint32_t k) {
  uint32_t h = (k ^ (k >> 16)) * 2654435761u;
  h = (h ^ (h >> 13)) * 0x9E3779B9u;
  return h ^ (h >> 16);
}

__device__ __forceinline__ int part_of(const int* keys, int count, int64_t base,
                                       int row, int n_parts) {
  if (row >= count) return n_parts;
  return static_cast<int>(mix_u32(static_cast<uint32_t>(keys[base + row])) %
                          static_cast<uint32_t>(n_parts));
}

__global__ void hp_tile_hist(const int* __restrict__ keys,
                             const int* __restrict__ counts, int n, int n_parts,
                             int n_tiles, int* __restrict__ tile_hist) {
  extern __shared__ int bins[];
  const int64_t block = blockIdx.x;
  const int seg = static_cast<int>(block / n_tiles);
  const int tile = static_cast<int>(block % n_tiles);
  const int nb = n_parts + 1;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) bins[b] = 0;
  __syncthreads();
  const int count = counts[seg];
  const int64_t base = static_cast<int64_t>(seg) * n;
  const int end = min(n, (tile + 1) * kTile);
  for (int row = tile * kTile + threadIdx.x; row < end; row += blockDim.x) {
    atomicAdd(&bins[part_of(keys, count, base, row, n_parts)], 1);
  }
  __syncthreads();
  int* out = tile_hist + block * nb;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) out[b] = bins[b];
}

__global__ void hp_tile_scan(int n_segs, int n_parts, int n_tiles,
                             int* __restrict__ tile_hist,
                             int* __restrict__ send_counts) {
  const int nb = n_parts + 1;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(n_segs) * nb) return;
  const int64_t seg = idx / nb;
  const int b = static_cast<int>(idx % nb);
  int* h = tile_hist + seg * n_tiles * nb + b;
  int run = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int c = h[static_cast<int64_t>(t) * nb];
    h[static_cast<int64_t>(t) * nb] = run;
    run += c;
  }
  if (b < n_parts) send_counts[seg * n_parts + b] = run;
}

__global__ void __launch_bounds__(kTile)
hp_tile_rank(const int* __restrict__ keys, const int* __restrict__ counts,
             int n, int n_parts, int n_tiles,
             const int* __restrict__ tile_base, int* __restrict__ part_out,
             int* __restrict__ slot_out) {
  extern __shared__ int warp_cnt[];        // (kWarps, n_parts + 1)
  const int64_t block = blockIdx.x;
  const int seg = static_cast<int>(block / n_tiles);
  const int tile = static_cast<int>(block % n_tiles);
  const int nb = n_parts + 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kWarps * nb; i += blockDim.x) warp_cnt[i] = 0;
  __syncthreads();

  const int count = counts[seg];
  const int64_t base = static_cast<int64_t>(seg) * n;
  const int row = tile * kTile + threadIdx.x;
  const bool in_range = row < n;
  // rows past the array end form their own group (id nb) and write nothing
  const int part = in_range ? part_of(keys, count, base, row, n_parts) : nb;
  const unsigned peers = __match_any_sync(0xffffffffu, part);
  const unsigned lower_lanes = (1u << lane) - 1u;
  const int lane_rank = __popc(peers & lower_lanes);
  if (in_range && lane == __ffs(peers) - 1) warp_cnt[warp * nb + part] = __popc(peers);
  __syncthreads();

  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_cnt[w * nb + b];
      warp_cnt[w * nb + b] = run;
      run += c;
    }
  }
  __syncthreads();

  if (in_range) {
    const int tb = tile_base[block * nb + part];
    part_out[base + row] = part;
    slot_out[base + row] = tb + warp_cnt[warp * nb + part] + lane_rank;
  }
}

constexpr int kHistThreads = 256;
constexpr int kHistMaxBlocks = 1056;      // 8 blocks on each of 132 SMs

__global__ void __launch_bounds__(kHistThreads)
hp_partition_hist(const int* __restrict__ keys, int n, int n_parts,
                  int* __restrict__ part_out, int* __restrict__ hist) {
  extern __shared__ int bins[];            // n_parts + 1: bin n_parts is the mask
  for (int b = threadIdx.x; b <= n_parts; b += blockDim.x) bins[b] = 0;
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int lane = threadIdx.x & 31;
  // every lane runs the same number of rounds, so the warp-wide match
  // sees all 32 lanes; rows past n join the masked bin and write nothing
  const int64_t rounds = (n + stride - 1) / stride;
  for (int64_t r = 0; r < rounds; ++r) {
    const int64_t row = r * stride + blockIdx.x * blockDim.x + threadIdx.x;
    const bool in_range = row < n;
    const int part = in_range ? static_cast<int>(mix_u32(static_cast<uint32_t>(keys[row])) %
                                                 static_cast<uint32_t>(n_parts))
                              : n_parts;
    if (in_range) part_out[row] = part;
    const unsigned peers = __match_any_sync(0xffffffffu, part);
    if (lane == __ffs(peers) - 1) atomicAdd(&bins[part], __popc(peers));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_parts; b += blockDim.x) {
    if (bins[b] != 0) atomicAdd(&hist[b], bins[b]);
  }
}

}  // namespace

// keys (n,) int32 → part (n,) int32 and hist (n_parts,) int32, which this
// call zeroes before the kernel adds into it.  Returns cudaGetLastError().
extern "C" int hash_partition_launch(const int* keys, int n, int n_parts, int* part,
                                     int* hist, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(hist, 0, sizeof(int) * n_parts, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int blocks = static_cast<int>(
        std::min<int64_t>((static_cast<int64_t>(n) + kHistThreads - 1) / kHistThreads,
                          kHistMaxBlocks));
    hp_partition_hist<<<blocks, kHistThreads, (n_parts + 1) * sizeof(int), st>>>(
        keys, n, n_parts, part, hist);
  }
  return static_cast<int>(cudaGetLastError());
}

// keys (n_segs, n) int32; counts (n_segs,) int32; outputs part, slot
// (n_segs, n) and send_counts (n_segs, n_parts) int32; scratch
// (n_segs, ceil(n / 1024), n_parts + 1) int32.  Returns cudaGetLastError().
extern "C" int hash_partition_pack_launch(const int* keys, const int* counts,
                                          int n_segs, int n, int n_parts,
                                          int* part, int* slot, int* send_counts,
                                          int* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n + kTile - 1) / kTile;
  const int nb = n_parts + 1;
  const int64_t blocks = static_cast<int64_t>(n_segs) * n_tiles;
  if (blocks > 0) {
    hp_tile_hist<<<static_cast<unsigned>(blocks), 256, nb * sizeof(int), st>>>(
        keys, counts, n, n_parts, n_tiles, scratch);
  }
  const int64_t scan_threads = static_cast<int64_t>(n_segs) * nb;
  if (scan_threads > 0) {
    hp_tile_scan<<<static_cast<unsigned>((scan_threads + 255) / 256), 256, 0, st>>>(
        n_segs, n_parts, n_tiles, scratch, send_counts);
  }
  if (blocks > 0) {
    hp_tile_rank<<<static_cast<unsigned>(blocks), kTile, kWarps * nb * sizeof(int), st>>>(
        keys, counts, n, n_parts, n_tiles, scratch, part, slot);
  }
  return static_cast<int>(cudaGetLastError());
}
