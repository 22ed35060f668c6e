// ssd_chunk: the Mamba-2 SSD scan over chunks, x (BH, S, P), dt (BH, S),
// a (BH,), B and C (BH, S, N), fp32 → y (BH, S, P), final state (BH, P, N).
//
// Replaces the TPU kernel `_kernel` / `ssd_chunk_pallas` in
// src/repro/kernels/ssd.py.  Per chunk of Q steps, with cum the running sum
// of dt·a restarted in every chunk and prev the state before the chunk:
//   y    = ((C Bᵀ) ⊙ L ⊙ dtᵀ) x + exp(cum) ⊙ (C prevᵀ),
//          L[i, j] = exp(cum_i - cum_j) for i >= j, else 0
//   next = exp(cum_last) prev + xᵀ (B ⊙ exp(cum_last - cum) dt)
// The decay is masked before exp, never factored into exp(cum_i)·exp(-cum_j):
// for i < j, cum_i - cum_j is positive and may be hundreds, and with a = -2,
// dt = 0.2 exp(-cum_j) alone overflows inside a 256-step chunk; inf·0 is NaN.
//
// The TPU kernel carries the state from chunk to chunk through its sequential
// grid, one (batch·head) at a time.  On this card that is 192 blocks at
// mamba2-780m widths, which leaves SMs idle, so the scan is split as in the
// SSD paper (Dao & Gu 2024, §6) into three launches on one stream:
//   1. ssd_chunk_state, grid (BH·chunks, P/64 · N/128 tiles): the chunk's cum
//      by a block scan (written to a (BH, S) scratch) and its local state
//      xᵀ (B ⊙ exp(cum_last - cum) dt), a 64×128 tile of (P, N) per block,
//      into a (BH, chunks, P, N) scratch;
//   2. ssd_state_pass, one thread per (batch·head, state element): walks the
//      chunks in order, overwriting each local state with the state before
//      its chunk (h ← exp(cum_last) h + local), and writes the final state;
//   3. ssd_chunk_scan, grid (BH·chunks·Q/64 row tiles, P/64): one 64×64 tile
//      of y, the inter-chunk term C prevᵀ scaled by exp(cum_i) plus the
//      intra-chunk term over the 64-column blocks on or below the diagonal
//      (C·Bᵀ tile, masked decay and dt in registers, routed through shared
//      memory into the next product); heaviest row tiles are issued first,
//      the next column block's first slices load while the weights are
//      formed, and on the diagonal block a warp skips what lies above it.
// At mamba2-780m widths (BH = 192, S = 4096, Q = 256, P = 64, N = 128) that
// is 3,072, 6,144 and 12,288 blocks of 128 threads.
//
// Bound: bytes on paper (1.2 GB of inputs and outputs against 6.5e10 FLOPs
// at the TF32 rate), instruction issue in practice.  The reference is fp32
// and the tolerance 1e-4 of the largest magnitude, which plain TF32 (about 3
// digits) does not hold, so every product runs on the tensor cores as
// 3×TF32: mma.sync m16n8k8 tf32 with fp32 accumulation, each operand split
// into hi (its top 19 bits) and lo = v - hi, summing lo·hi + hi·lo + hi·hi
// (about 2^-20 relative per product, three times the tensor-core work).  What
// the card then waits on is the instructions around the products: the split,
// fragment loads, staging and barriers, and one exp per weight.  So warps
// hold 32×32 tiles (32×64 in phase 1) to reuse each fragment, operands whose
// rows run along the reduction come in by ldmatrix, tiles are staged by
// 16-byte cp.async copies double-buffered along the reduction, and row
// strides are padded so fragment loads are free of bank conflicts; a scalar
// copy takes over where a row or a base pointer is not 16-byte aligned.
// The state scratch adds 4 × BH·chunks·P·N·4 bytes of traffic (about 0.4 GB
// at mamba2-780m widths).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;         // a 64×64 output tile: 2 × 2 warps of 32×32
constexpr int kThreads = 32 * kWarps;
constexpr int kT = 64;            // output tile edge
constexpr int kWm = kWarps / 2;   // warps along the rows
constexpr int kMT = kT / 16 / kWm;  // m16 tiles of one warp; each warp spans 32 columns
constexpr int kK = 32;            // depth of one staged slice
constexpr int kLdK = kK + 4;      // row stride ≡ 4 (mod 32): rows read across k
constexpr int kLdT = kT + 8;      // row stride ≡ 8 (mod 32): rows read across k-rows
constexpr int kLdW = kT + 4;      // the weights tile, read as rows
constexpr int kTN = 128;          // state tile width along N (phase 1): 2 × 2 warps of 32×64
constexpr int kLdN = kTN + 8;     // ≡ 8 (mod 32)
constexpr int kNTS = kTN / 16;    // n8 tiles of one warp in phase 1

constexpr int kPassThreads = 256;
constexpr int kMinBlocks = 3;     // blocks an SM holds: 3 × 73.5 KB of phase 3's shared memory

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// dst[r·ld + c] = src[(r0 + r)·stride + c0 + c] for r < R, c < C, zero where
// r0 + r >= rows or c0 + c >= cols.  vec: src, stride and c0 are 16-byte
// aligned and cols % 4 == 0, so whole 16-byte copies go by cp.async (rows
// past the end zero-filled); otherwise scalar loads.
template <int R, int C>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src, int64_t stride,
                                      int r0, int rows, int c0, int cols, bool vec) {
  static_assert(R * C % (4 * kThreads) == 0, "a whole number of copies per thread");
  if (vec) {
#pragma unroll
    for (int k = 0; k < R * C / 4 / kThreads; ++k) {
      const int i = threadIdx.x + k * kThreads, r = i / (C / 4), c = i % (C / 4) * 4;
      const bool ok = r0 + r < rows && c0 + c < cols;
      cp_async16(dst + r * ld + c, ok ? src + (r0 + r) * stride + c0 + c : src, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < R * C / kThreads; ++k) {
      const int i = threadIdx.x + k * kThreads, r = i / C, c = i % C;
      dst[r * ld + c] = (r0 + r < rows && c0 + c < cols) ? src[(r0 + r) * stride + c0 + c]
                                                         : 0.f;
    }
  }
}

// v = hi + lo: hi keeps v's top 19 bits (a TF32 value, truncated), lo = v -
// hi is exact in fp32, and the tensor core reads its top 19 bits.  Two
// instructions; cvt.rna.tf32.f32 for both halves made the whole scan 25%
// slower on an H100 80GB HBM3 at 700 W.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp: acc[mt][nt] (16 × 8 each) += A (16·MT × depth) · B (depth × 8·NT)
// in 3×TF32, with A(r, k) = a[r·A_RS + k·A_KS] (times
// kscale[k] if SCALE) and B(k, c) = b[k·B_KS + c·B_CS] in shared memory.
// Fragments of m16n8k8: A rows g, g+8 and columns t, t+4; B rows t, t+4 and
// column g; the accumulator rows g, g+8 and columns 2t, 2t+1.
template <int MT, int NT, int A_RS, int A_KS, int B_KS, int B_CS, bool SCALE>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], const float* a,
                                         const float* b, int depth, const float* kscale) {
  // an operand whose rows run along k comes in by ldmatrix: 8 rows of 4
  // words per matrix, lane l reading word l % 4 of row l / 4, as the
  // fragments want
  constexpr bool A_LDSM = A_KS == 1 && !SCALE;
  constexpr bool B_LDSM = B_KS == 1 && NT % 2 == 0;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, m = lane >> 3, r = lane & 7;
  const uint32_t a_row = smem_u32(a + (r + 8 * (m & 1)) * A_RS + 4 * (m >> 1));
  const uint32_t b_row = smem_u32(b + (8 * (m >> 1) + r) * B_CS + 4 * (m & 1));
#pragma unroll 2
  for (int k0 = 0; k0 < depth; k0 += 8) {
    uint32_t av[MT][4], bv[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (A_LDSM) {
        ldsm_x4(a_row + 4 * (16 * mt * A_RS + k0), av[mt]);
      } else {
        const float* ap = a + (16 * mt + g) * A_RS + (k0 + t) * A_KS;
        float v[4] = {ap[0], ap[8 * A_RS], ap[4 * A_KS], ap[8 * A_RS + 4 * A_KS]};
        if (SCALE) {
          const float s0 = kscale[k0 + t], s1 = kscale[k0 + t + 4];
          v[0] *= s0, v[1] *= s0, v[2] *= s1, v[3] *= s1;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) av[mt][i] = __float_as_uint(v[i]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      if (B_LDSM) {
        uint32_t w[4];
        ldsm_x4(b_row + 4 * (16 * (nt / 2) * B_CS + k0), w);
        bv[nt][0] = w[0], bv[nt][1] = w[1], bv[nt + 1][0] = w[2], bv[nt + 1][1] = w[3];
      } else {
#pragma unroll
        for (int u = nt; u < nt + 2 && u < NT; ++u) {
          const float* bp = b + (k0 + t) * B_KS + (8 * u + g) * B_CS;
          bv[u][0] = __float_as_uint(bp[0]), bv[u][1] = __float_as_uint(bp[4 * B_KS]);
        }
      }
    }
    uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) split(__uint_as_float(av[mt][i]), ah[mt][i], al[mt][i]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) split(__uint_as_float(bv[nt][i]), bh[nt][i], bl[nt][i]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_tf32(acc[mt][nt], al[mt], bh[nt]);
        mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
        mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
      }
  }
}

// Phase 1: cum of the chunk and its local state.  Block (bh·nc + c, tile):
// tile = p-tile · n_tiles_n + n-tile of the (P, N) state.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssd_chunk_state(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ bm,
                float* __restrict__ cum_out, float* __restrict__ local, int s_len, int p, int n,
                int q, int nc, int n_tiles_n, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                          // 2 × (kK, kLdT): x slice, j-major
  float* bs = xs + 2 * kK * kLdT;            // 2 × (kK, kLdN): B slice, j-major
  float* part = bs + 2 * kK * kLdN;          // 32: the warps' sums
  float* cum = part + 32;                    // round_up(q, kK)
  float* tail = cum + round_up(q, kK);       // dt, then exp(cum_last - cum) · dt
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % kWm, wn = warp / kWm;
  const int64_t bc = blockIdx.x, bh = bc / nc, t0 = bc % nc * static_cast<int64_t>(q);
  const int pb = blockIdx.y / n_tiles_n * kT, nb = blockIdx.y % n_tiles_n * kTN;
  const float* xc = x + (bh * s_len + t0) * p;
  const float* bcp = bm + (bh * s_len + t0) * n;
  const float* dtc = dt + bh * s_len + t0;

  // the first slices' copies overlap the scan
  stage<kK, kT>(xs, kLdT, xc, p, 0, q, pb, p, vec);
  stage<kK, kTN>(bs, kLdN, bcp, n, 0, q, nb, n, vec);
  cp_async_commit();

  // cum = cumsum(dt·a): each thread a run of consecutive steps, then a
  // block-wide exclusive scan of the runs' sums
  const float a_h = a[bh];
  const int per = (q + kThreads - 1) / kThreads;
  const int lo = min(q, tid * per), hi = min(q, lo + per);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    const float d = dtc[i];
    tail[i] = d;
    run += d * a_h;
    cum[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kThreads / 32 ? part[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < kThreads / 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += v;
    }
    if (lane < kThreads / 32) part[lane] = w;
  }
  __syncthreads();
  const float off = excl + (warp > 0 ? part[warp - 1] : 0.f);
  for (int i = lo; i < hi; ++i) cum[i] += off;
  for (int i = q + tid; i < round_up(q, kK); i += kThreads) tail[i] = 0.f;
  __syncthreads();
  const float cum_last = cum[q - 1];
  for (int i = tid; i < q; i += kThreads) tail[i] *= expf(cum_last - cum[i]);
  if (blockIdx.y == 0) {
    for (int i = tid; i < q; i += kThreads) cum_out[bh * s_len + t0 + i] = cum[i];
  }

  // local = (x ⊙ tail)ᵀ B over the chunk's steps, 32 at a time
  float acc[kMT][kNTS][4] = {};
  const int ns = (q + kK - 1) / kK;
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) {
      const int nbuf = (s + 1) & 1;
      stage<kK, kT>(xs + nbuf * kK * kLdT, kLdT, xc, p, (s + 1) * kK, q, pb, p, vec);
      stage<kK, kTN>(bs + nbuf * kK * kLdN, kLdN, bcp, n, (s + 1) * kK, q, nb, n, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = s & 1;
    warp_mma<kMT, kNTS, 1, kLdT, kLdN, 1, true>(acc, xs + buf * kK * kLdT + 16 * kMT * wm,
                                                bs + buf * kK * kLdN + kTN / 2 * wn, kK,
                                                tail + s * kK);
    __syncthreads();
  }
  const int g = lane >> 2, t = lane & 3;
  float* lc = local + bc * p * n;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNTS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pr = pb + 16 * (kMT * wm + mt) + g + (e >> 1) * 8;
        const int col = nb + kTN / 2 * wn + 8 * nt + 2 * t + (e & 1);
        if (pr < p && col < n) lc[static_cast<int64_t>(pr) * n + col] = acc[mt][nt][e];
      }
}

// Phase 2: the states between chunks.  Thread e of block (x, y) walks
// element e of every (batch·head) bh ≡ y (mod gridDim.y) through the chunks:
// local[c] becomes the state before chunk c, state the one after the last.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass(const float* __restrict__ cum, float* __restrict__ local,
               float* __restrict__ state, int bh_count, int s_len, int q, int nc, int64_t pn) {
  constexpr int kAhead = 8;                  // chunks loaded ahead of the recurrence
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kPassThreads + threadIdx.x;
  if (e >= pn) return;
  for (int64_t bh = blockIdx.y; bh < bh_count; bh += gridDim.y) {
    float* lp = local + bh * nc * pn + e;
    const float* last = cum + bh * s_len + q - 1;
    float h = 0.f;
    for (int c0 = 0; c0 < nc; c0 += kAhead) {
      float v[kAhead], d[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const bool ok = c0 + u < nc;
        v[u] = ok ? lp[(c0 + u) * pn] : 0.f;
        d[u] = ok ? expf(last[static_cast<int64_t>(c0 + u) * q]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (c0 + u < nc) {
          lp[(c0 + u) * pn] = h;
          h = d[u] * h + v[u];
        }
      }
    }
    state[bh * pn + e] = h;
  }
}

// the first slices of rows_product's operands, into buffer 0 (one group)
__device__ __forceinline__ void first_slices(float* sa, float* sb, const float* a, int ra,
                                             int ra_end, const float* b, int rb, int rb_end,
                                             int n, bool vec) {
  stage<kT, kK>(sa, kLdK, a, n, ra, ra_end, 0, n, vec);
  stage<kT, kK>(sb, kLdK, b, n, rb, rb_end, 0, n, vec);
  cp_async_commit();
}

// acc += A · Bᵀ over depth n, A the 64 rows of `a` from ra (ra_end valid),
// B the 64 rows of `b` from rb (rb_end valid), both of row stride n; the
// slices of kK double-buffered in sa, sb (2 × (kT, kLdK) each), the first
// already issued by first_slices.  A warp with `skip` set only joins the
// barriers.
__device__ __forceinline__ void rows_product(float (&acc)[kMT][4][4], float* sa, float* sb,
                                             const float* a, int ra, int ra_end,
                                             const float* b, int rb, int rb_end, int n,
                                             bool vec, int wm, int wn, bool skip) {
  const int ns = (n + kK - 1) / kK;
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) {
      const int nbuf = (s + 1) & 1;
      stage<kT, kK>(sa + nbuf * kT * kLdK, kLdK, a, n, ra, ra_end, (s + 1) * kK, n, vec);
      stage<kT, kK>(sb + nbuf * kT * kLdK, kLdK, b, n, rb, rb_end, (s + 1) * kK, n, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = s & 1;
    if (!skip) {
      warp_mma<kMT, 4, kLdK, 1, 1, kLdK, false>(acc, sa + buf * kT * kLdK + 16 * kMT * wm * kLdK,
                                                sb + buf * kT * kLdK + 32 * wn * kLdK, kK,
                                                nullptr);
    }
    __syncthreads();
  }
}

// Phase 3: y.  Block (bh·nc·nrt + ·, p-tile): row tile nrt - 1 - (x mod nrt)
// of chunk (x / nrt) mod nc of bh = x / (nrt·nc).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssd_chunk_scan(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ bm, const float* __restrict__ cm,
               const float* __restrict__ cum, const float* __restrict__ prev,
               float* __restrict__ y, int s_len, int p, int n, int q, int nc, int nrt, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;                          // 2 × (kT, kLdK): C slices
  float* sb = sa + 2 * kT * kLdK;            // 2 × (kT, kLdK): prev or B slices
  float* ws = sb + 2 * kT * kLdK;            // (kT, kLdW): the weights tile, i-major
  float* xs = ws + kT * kLdW;                // (kT, kLdT): x tile, j-major
  float* cum_i = xs + kT * kLdT;             // kT each
  float* cum_j = cum_i + kT;
  float* dt_j = cum_j + kT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % kWm, wn = warp / kWm, g = lane >> 2, t = lane & 3;
  const int64_t blk = blockIdx.x, bc = blk / nrt, bh = bc / nc;
  const int64_t t0 = bc % nc * static_cast<int64_t>(q);
  const int i0 = (nrt - 1 - static_cast<int>(blk % nrt)) * kT, pb = blockIdx.y * kT;
  const float* xc = x + (bh * s_len + t0) * p;
  const float* bcp = bm + (bh * s_len + t0) * n;
  const float* ccp = cm + (bh * s_len + t0) * n;
  const float* cumc = cum + bh * s_len + t0;
  const float* dtc = dt + bh * s_len + t0;
  // this warp's rows end before row warp_end of the tile
  const int warp_end = 16 * kMT * (wm + 1);
  if (tid < kT) cum_i[tid] = i0 + tid < q ? cumc[i0 + tid] : 0.f;

  // inter-chunk term: exp(cum_i) · C_i prevᵀ, prev (P, N) from phase 2
  float acc[kMT][4][4] = {};
  const float* pv = prev + bc * p * n;
  first_slices(sa, sb, ccp, i0, q, pv, pb, p, n, vec);
  rows_product(acc, sa, sb, ccp, i0, q, pv, pb, p, n, vec, wm, wn, false);
  first_slices(sa, sb, ccp, i0, q, bcp, 0, q, n, vec);     // column block 0's, in flight
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int il = 16 * (kMT * wm + mt) + g;
    const float e0 = expf(cum_i[il]), e1 = expf(cum_i[il + 8]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      acc[mt][nt][0] *= e0, acc[mt][nt][1] *= e0, acc[mt][nt][2] *= e1, acc[mt][nt][3] *= e1;
    }
  }

  // intra-chunk term over the column blocks on or below the diagonal; on
  // the diagonal block a warp whose tile lies wholly above it skips the
  // C·Bᵀ product, and the weights past a warp's last row are not multiplied
  constexpr float kLog2e = 1.4426950408889634f;
  for (int j0 = 0; j0 <= i0; j0 += kT) {
    const bool diag = j0 == i0;
    if (tid < kT) {
      const bool ok = j0 + tid < q;
      cum_j[tid] = ok ? cumc[j0 + tid] : 0.f;
      dt_j[tid] = ok ? dtc[j0 + tid] : 0.f;
    }
    stage<kT, kT>(xs, kLdT, xc, p, j0, q, pb, p, vec);   // waited for inside rows_product
    cp_async_commit();
    float cb[kMT][4][4] = {};
    rows_product(cb, sa, sb, ccp, i0, q, bcp, j0, q, n, vec, wm, wn,
                 diag && 32 * wn >= warp_end);
    if (!diag) first_slices(sa, sb, ccp, i0, q, bcp, j0 + kT, q, n, vec);
    // w[i][j] = cb · exp(cum_i - cum_j) · dt_j for j <= i < q, else 0
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = 16 * (kMT * wm + mt) + g + (e >> 1) * 8;
          const int jl = 32 * wn + 8 * nt + 2 * t + (e & 1);
          const int i = i0 + il, j = j0 + jl;
          ws[il * kLdW + jl] =
              (i < q && j <= i)
                  ? cb[mt][nt][e] * exp2f((cum_i[il] - cum_j[jl]) * kLog2e) * dt_j[jl] : 0.f;
        }
    __syncthreads();
    warp_mma<kMT, 4, kLdW, 1, kLdT, 1, false>(acc, ws + 16 * kMT * wm * kLdW, xs + 32 * wn,
                                              diag ? warp_end : kT, nullptr);
    __syncthreads();
  }

  float* yc = y + (bh * s_len + t0) * p;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 16 * (kMT * wm + mt) + g + (e >> 1) * 8;
        const int pc = pb + 32 * wn + 8 * nt + 2 * t + (e & 1);
        if (i < q && pc < p) yc[static_cast<int64_t>(i) * p + pc] = acc[mt][nt][e];
      }
}

size_t state_smem(int q) {
  return sizeof(float) *
         (2 * kK * (kLdT + kLdN) + 32 + 2 * static_cast<size_t>(round_up(q, kK)));
}

constexpr size_t kScanSmem = sizeof(float) * (4 * kT * kLdK + kT * kLdW + kT * kLdT + 3 * kT);

}  // namespace

// x (bh, s, p), dt (bh, s), a (bh,), b and c (bh, s, n) fp32, contiguous;
// s % q == 0, q >= 1 → y (bh, s, p), state (bh, p, n).  scratch: bh·s +
// bh·(s/q)·p·n floats, 16-byte aligned (the local states, then cum).
// Returns the first error of cudaFuncSetAttribute (the shared memory phase 1
// needs grows with q) before anything is launched, else cudaGetLastError().
extern "C" int ssd_chunk_launch(const float* x, const float* dt, const float* a,
                                const float* b, const float* c, float* y, float* state,
                                float* scratch, int bh, int s, int p, int n, int q,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = s / q;
  const int64_t pn = static_cast<int64_t>(p) * n;
  float* local = scratch;
  float* cum = scratch + static_cast<int64_t>(bh) * nc * pn;
  const size_t smem1 = state_smem(q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem1));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(ssd_chunk_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kScanSmem));
  }
  if (err != cudaSuccess) {
    cudaGetLastError();           // clear it, so that the next launch reports its own
    return static_cast<int>(err);
  }
  const bool vec = p % 4 == 0 && n % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(b) |
                     reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(scratch)) &
                    15) == 0;
  const int tp = (p + kT - 1) / kT, tn = (n + kTN - 1) / kTN, nrt = (q + kT - 1) / kT;
  if (nc > 0) {
    ssd_chunk_state<<<dim3(static_cast<unsigned>(static_cast<int64_t>(bh) * nc), tp * tn),
                      kThreads, smem1, st>>>(x, dt, a, b, cum, local, s, p, n, q, nc, tn, vec);
  }
  const unsigned pass_y = static_cast<unsigned>(bh < 65535 ? bh : 65535);
  ssd_state_pass<<<dim3(static_cast<unsigned>((pn + kPassThreads - 1) / kPassThreads), pass_y),
                   kPassThreads, 0, st>>>(cum, local, state, bh, s, q, nc, pn);
  if (nc > 0) {
    ssd_chunk_scan<<<dim3(static_cast<unsigned>(static_cast<int64_t>(bh) * nc * nrt), tp),
                     kThreads, kScanSmem, st>>>(x, dt, b, c, cum, local, y, s, p, n, q, nc,
                                                nrt, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
