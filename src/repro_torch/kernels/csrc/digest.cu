// blake2b_chunks: the BLAKE2b-256 digest of every fixed-size chunk of a byte
// array, one chunk per thread.
//
// It replaces no TPU kernel: the JAX package hashes its tables on the host.
// It was added for the join service's content digest of the bound tables
// (`table_digest` in src/repro_torch/core/query.py), which every submit takes
// over every byte of every bound table (192 MB for SSB's lineorder at scale
// factor 1) to key the statistics memo and the learned capacities.  The
// table's digest is a Merkle tree of BLAKE2b: each chunk's digest here is
// exactly `hashlib.blake2b(chunk, digest_size=32)` (no key, no salt, default
// parameters), and the host combines the chunk digests.  The chunks are
// independent, so they hash in parallel where one host thread hashes them in
// turn.
//
// Bound.  Compute: one 128-byte message block costs 12 rounds of 8 G
// functions on 64-bit words, ~2.7k 32-bit integer instructions; 196 MB is
// 1.53M blocks, ~0.3 ms at 64 integer lanes per SM on 132 SMs.  Memory: every
// byte is read once (196 MB at 3.35 TB/s, ~0.06 ms) and 32 bytes are written
// per chunk.  Both lie far under the host-to-card copy that brings the bytes
// (tens of ms), which the wrapper overlaps with the kernel slice by slice.
//
// Design:
//   - a thread owns one chunk and keeps the chaining value, the 16-word
//     working state and the 16 message words in registers; the rounds are
//     unrolled with the message schedule as literal indices, so no message
//     word is indexed at run time;
//   - a thread's own reads would be strided by the chunk size (a warp would
//     touch 32 lines per load), so a block of 32 threads stages each message
//     block of its 32 chunks through shared memory: 8 neighbouring threads
//     load one chunk's 128-byte block in 16-byte loads (one whole line a
//     segment, four a warp instruction), and each thread then reads its own
//     row.  Rows are 17 words apart, so neither the 8-byte stores nor the
//     row reads of a half-warp fall twice into one bank;
//   - the next block's loads are issued into registers before the current
//     block is compressed, so their latency hides behind the rounds;
//   - bytes past the end of the array are zeros (BLAKE2b's padding of the
//     last block); only the array's last chunk can be short.
// One launch: ceil(chunks / 32) blocks of 32 threads.  One warp a block keeps
// the blocks spread over the SMs when a slice holds only ~2k chunks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;      // chunks (threads) per block
constexpr int kBlockBytes = 128;  // one BLAKE2b message block
constexpr int kRow = 17;          // 64-bit words per staged row: 16 and one of padding
constexpr int kDigestBytes = 32;

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

#define B2B_G(a, b, c, d, x, y)      \
  a = a + b + (x);                   \
  d = rotr64(d ^ a, 32);             \
  c = c + d;                         \
  b = rotr64(b ^ c, 24);             \
  a = a + b + (y);                   \
  d = rotr64(d ^ a, 16);             \
  c = c + d;                         \
  b = rotr64(b ^ c, 63);

#define B2B_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  B2B_G(v0, v4, v8, v12, m[s0], m[s1]);                                                  \
  B2B_G(v1, v5, v9, v13, m[s2], m[s3]);                                                  \
  B2B_G(v2, v6, v10, v14, m[s4], m[s5]);                                                 \
  B2B_G(v3, v7, v11, v15, m[s6], m[s7]);                                                 \
  B2B_G(v0, v5, v10, v15, m[s8], m[s9]);                                                 \
  B2B_G(v1, v6, v11, v12, m[s10], m[s11]);                                               \
  B2B_G(v2, v7, v8, v13, m[s12], m[s13]);                                                \
  B2B_G(v3, v4, v9, v14, m[s14], m[s15]);

#define B2B_IV0 0x6a09e667f3bcc908ULL
#define B2B_IV1 0xbb67ae8584caa73bULL
#define B2B_IV2 0x3c6ef372fe94f82bULL
#define B2B_IV3 0xa54ff53a5f1d36f1ULL
#define B2B_IV4 0x510e527fade682d1ULL
#define B2B_IV5 0x9b05688c2b3e6c1fULL
#define B2B_IV6 0x1f83d9abfb41bd6bULL
#define B2B_IV7 0x5be0cd19137e2179ULL

// One BLAKE2b compression of the message block m into the chaining value h;
// t is the count of message bytes up to the end of this block, last marks
// the final block.
__device__ __forceinline__ void compress(uint64_t h[8], const uint64_t m[16], uint64_t t,
                                         bool last) {
  uint64_t v0 = h[0], v1 = h[1], v2 = h[2], v3 = h[3];
  uint64_t v4 = h[4], v5 = h[5], v6 = h[6], v7 = h[7];
  uint64_t v8 = B2B_IV0, v9 = B2B_IV1, v10 = B2B_IV2, v11 = B2B_IV3;
  uint64_t v12 = B2B_IV4 ^ t, v13 = B2B_IV5;   // the counter's high word is 0
  uint64_t v14 = last ? ~B2B_IV6 : B2B_IV6, v15 = B2B_IV7;
  B2B_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
  B2B_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
  B2B_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4)
  B2B_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8)
  B2B_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13)
  B2B_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9)
  B2B_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11)
  B2B_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10)
  B2B_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5)
  B2B_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0)
  B2B_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
  B2B_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
  h[0] ^= v0 ^ v8;
  h[1] ^= v1 ^ v9;
  h[2] ^= v2 ^ v10;
  h[3] ^= v3 ^ v11;
  h[4] ^= v4 ^ v12;
  h[5] ^= v5 ^ v13;
  h[6] ^= v6 ^ v14;
  h[7] ^= v7 ^ v15;
}

// The 16 bytes at byte offset o of the array, zeros past its end n.
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ data, int64_t o, int64_t n) {
  if (o + 16 <= n) return __ldcs(reinterpret_cast<const uint4*>(data + o));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 16 && o + i < n; ++i) w[i >> 2] |= static_cast<uint32_t>(data[o + i]) << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ void __launch_bounds__(kThreads)
blake2b_chunks(const uint8_t* __restrict__ data, int64_t n, int chunk, int64_t n_chunks,
               uint8_t* __restrict__ out) {
  __shared__ uint64_t stage[kThreads * kRow];
  const int tid = threadIdx.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads;  // the block's first chunk
  const int64_t mine = first + tid;
  // this thread's chunk: its length and message blocks (0 past the last chunk)
  const int64_t len = mine < n_chunks ? min(static_cast<int64_t>(chunk), n - mine * chunk) : 0;
  const int my_blocks = static_cast<int>((len + kBlockBytes - 1) / kBlockBytes);
  // the block's first chunk is its longest (only the array's last chunk is
  // short), and sets the block's loop
  const int n_blocks = static_cast<int>(
      (min(static_cast<int64_t>(chunk), n - first * chunk) + kBlockBytes - 1) / kBlockBytes);

  // staging: load i of thread tid is piece tid % 8 of chunk 4 i + tid / 8
  const int piece = tid & 7;
  uint4 next[8];
  auto fetch = [&](int b) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t c = first + 4 * i + (tid >> 3);
      next[i] = load16(data, c * chunk + static_cast<int64_t>(b) * kBlockBytes + 16 * piece, n);
    }
  };

  uint64_t h[8] = {B2B_IV0 ^ 0x01010020ULL, B2B_IV1, B2B_IV2, B2B_IV3,
                   B2B_IV4, B2B_IV5, B2B_IV6, B2B_IV7};   // digest length 32, no key
  uint64_t m[16];
  fetch(0);
  for (int b = 0; b < n_blocks; ++b) {
    __syncthreads();   // every row of the previous block has been read
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint64_t* row = stage + (4 * i + (tid >> 3)) * kRow + 2 * piece;
      row[0] = static_cast<uint64_t>(next[i].x) | (static_cast<uint64_t>(next[i].y) << 32);
      row[1] = static_cast<uint64_t>(next[i].z) | (static_cast<uint64_t>(next[i].w) << 32);
    }
    __syncthreads();
    if (b + 1 < n_blocks) fetch(b + 1);
#pragma unroll
    for (int w = 0; w < 16; ++w) m[w] = stage[tid * kRow + w];
    if (b < my_blocks) {
      const bool last = b + 1 == my_blocks;
      compress(h, m, last ? static_cast<uint64_t>(len) : static_cast<uint64_t>(b + 1) * kBlockBytes,
               last);
    }
  }
  if (len > 0) {
    uint64_t* dst = reinterpret_cast<uint64_t*>(out + mine * kDigestBytes);
#pragma unroll
    for (int w = 0; w < kDigestBytes / 8; ++w) dst[w] = h[w];   // little-endian, as BLAKE2b's output
  }
}

}  // namespace

// data: n bytes on the device, 16-byte aligned; out: ceil(n / chunk) × 32
// bytes, 8-byte aligned; chunk a positive multiple of 128.
extern "C" int blake2b_chunks_launch(const uint8_t* data, int64_t n, int chunk, uint8_t* out,
                                     void* stream) {
  if (chunk <= 0 || chunk % kBlockBytes != 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_chunks = (n + chunk - 1) / chunk;
  const int64_t blocks = (n_chunks + kThreads - 1) / kThreads;
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    blake2b_chunks<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(data, n, chunk, n_chunks, out);
  }
  return static_cast<int>(cudaGetLastError());
}
