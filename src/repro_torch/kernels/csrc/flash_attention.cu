// flash_attention: online-softmax attention, q (BH, Sq, D), k/v (BH, Sk, D),
// in float32 or bfloat16, output in the inputs' type.
//
// Replaces the TPU kernel `_kernel` / `flash_attention_pallas` in
// src/repro/kernels/flash_attention.py.  Semantics kept from it: scores in
// fp32 at scale D^-0.5; the causal mask keeps k_pos <= q_pos counted from
// position 0 (also when Sq != Sk), masked scores are -1e30; running (m, l,
// acc) in fp32; p is rounded to v's type before the P·V product (l sums the
// unrounded p); the output is acc / max(l, 1e-30), cast to the inputs' type.
// The TPU kernel computes the key tiles that lie wholly above the diagonal
// and masks them; here a causal block stops at the last key tile its last
// row can see, and each head's blocks run heaviest first (one head after
// another, so that its K and V stay in L2).  Keys past Sk and rows past Sq
// (the ragged edges) are masked in the kernel itself.
//
// Bound: operations.  At h2o-danube-1.8b prefill (64 heads·batch, 4096
// tokens, D = 80, causal) the work is 4·D FLOPs per (q, k) pair the mask
// keeps, 1.7e11 FLOPs against 168 MB of q, k, v and output: 0.17 ms at the
// bf16 tensor cores' 989 TFLOP/s, 2.6 ms at the fp32 pipes' 67 TFLOP/s
// (H100 SXM data sheet, 700 W).  mma.sync reaches only part of the tensor
// cores' rate (wgmma, fed by TMA, is the way to all of it, left for later),
// and each warp reads the whole K/V tile from shared memory for its 16
// rows; PERF.md has the measured times.
//
// bfloat16 (`flash_fwd_tc`), FlashAttention-2 style on the tensor cores:
//   - one block of 4 warps per 64-row q tile, 16 rows per warp; the block's
//     q tile is staged once through shared memory and each warp keeps its Q
//     fragments in registers (ldmatrix) for the whole key sweep;
//   - K and V move in 64-key tiles through a two-stage ring in shared
//     memory, filled by 16-byte cp.async copies (zero-filled past Sk) while
//     the previous tile is computed;
//   - S = Q·Kᵀ and O += P·V are mma.sync m16n8k16 bf16 products with fp32
//     accumulators; V enters through ldmatrix.trans, and P never leaves
//     registers: the S accumulator fragment, exponentiated and packed to
//     bf16x2, is the A operand of P·V (rounding p to bf16 as the reference
//     does), while l sums the unrounded fp32 p;
//   - row max and sum are shared across the 4 lanes of a quad (each quad
//     holds two rows) with __shfl_xor_sync; scores and the running max stay
//     unscaled (the scale is positive, so the max is the same), and each
//     exp(scale·(s - m)) is one FFMA and one exp2; a masked score is -1e30
//     before the scale, far below any real score, as in the reference;
//   - rows are padded by 8 elements (16 bytes), so the 8 row addresses of
//     every ldmatrix phase fall in 8 distinct 16-byte bank groups at every
//     D the wrapper takes (D = 80: 176-byte rows);
//   - the output goes through shared memory for coalesced 16-byte stores.
//   Shared memory: 5 tiles of 64 × (D + 8) bf16 (Q, two K, two V), 56 KB at
//   D = 80, 85 KB at D = 128 and 165 KB at D = 256; __launch_bounds__ asks
//   for registers that let two blocks share an SM up to D = 128.  At
//   D = 256 one block fills an SM's shared memory, the 16×256 fp32 output
//   accumulator takes 128 registers a lane, and the Q fragments are
//   reloaded from shared memory at every k16 step rather than held.
//
// float32 (`flash_fwd_f32`) stays on the fp32 FMA pipes: one block per
// 64-row q tile, one thread per q row up to D = 128 (four at D = 256, each
// with a quarter of the columns and the row's scores summed by shuffles),
// with the row's scores and its accumulators in registers and 32-key K/V
// tiles broadcast from shared memory (162 KB at D = 256).  The tensor
// cores' fp32 input type, TF32, keeps 10 mantissa bits (about 3 decimal
// digits) and would break the float32 limit of 1e-4 + 1e-4·|plain|.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kMasked = -1e30f;  // the reference's mask value

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcWarps = 4;              // 16 q rows each
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcBQ = 16 * kTcWarps;     // q rows per block
constexpr int kBK = 64;                  // keys per staged K/V tile
constexpr int kPad = 8;                  // bf16 elements of padding per staged row

template <int D>
constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) * (kTcBQ + 4 * kBK) * (D + kPad);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c (16×8, fp32) += a (16×16, bf16, row) · b (16×8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Fragment layout of an m16n8 fp32 accumulator: lane = 4·g + c holds rows g
// (elements 0, 1) and g + 8 (elements 2, 3), columns 2c and 2c + 1.
template <int D>
__global__ void __launch_bounds__(kTcThreads, D <= 128 ? 2 : 1)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out, int sq, int sk, int causal,
             float scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int kS = D + kPad;     // padded row stride, elements
  constexpr int kKD = D / 16;      // k16 steps of Q·Kᵀ
  constexpr int kND = D / 8;       // n8 tiles of the output
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  // Q fragments stay in registers up to D = 128; above, the 16×D output
  // accumulator alone takes D/2 registers a lane, so each k16 step reloads
  // its Q fragment from the staged tile instead (q_s is only overwritten
  // by the output after the key sweep)
  constexpr bool kQRegs = D <= 128;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);   // (kTcBQ, kS), later the output tile
  bf16* k_s = q_s + kTcBQ * kS;                // 2 × (kBK, kS)
  bf16* v_s = k_s + 2 * kBK * kS;              // 2 × (kBK, kS)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  // exp(scale·(s - m)) = exp2(s·c - m·c), c = scale·log2(e): one FFMA and
  // one exp2 per score, on unscaled scores and an unscaled running max
  const float scale_log2 = scale * 1.4426950408889634f;
  // one head after another (its K and V stay in L2 while its q tiles run),
  // the heaviest q tiles of each head first
  const int n_qt = (sq + kTcBQ - 1) / kTcBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x % n_qt)) * kTcBQ;
  const int64_t bh = blockIdx.x / n_qt;
  const int rows = min(kTcBQ, sq - q0);
  const bf16* qb = q + (bh * sq + q0) * D;
  const bf16* kb = k + bh * sk * D;
  const bf16* vb = v + bh * sk * D;

  for (int i = tid; i < kTcBQ * kChunks; i += kTcThreads) {
    const int r = i / kChunks, col = (i % kChunks) * 8;
    cp_async16(smem_u32(q_s + r * kS + col), r < rows ? qb + r * D + col : q, r < rows);
  }
  auto load_kv = [&](int kt) {
    const int k0 = kt * kBK, kn = min(kBK, sk - k0);
    bf16* ks = k_s + (kt & 1) * kBK * kS;
    bf16* vs = v_s + (kt & 1) * kBK * kS;
    for (int i = tid; i < kBK * kChunks; i += kTcThreads) {
      const int r = i / kChunks, col = (i % kChunks) * 8;
      const int64_t off = static_cast<int64_t>(k0 + r) * D + col;
      cp_async16(smem_u32(ks + r * kS + col), r < kn ? kb + off : k, r < kn);
      cp_async16(smem_u32(vs + r * kS + col), r < kn ? vb + off : v, r < kn);
    }
  };

  int n_kt = (sk + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + rows - 1) / kBK + 1);   // skip tiles above the diagonal
  load_kv(0);
  cp_async_commit();                                           // group 0: Q and tile 0

  // ldmatrix x4 row addresses: lane l feeds row l & 7 of matrix l >> 3
  const int lm_r = lane & 7, lm_m = lane >> 3;
  uint32_t qf[kQRegs ? kKD : 1][4];
  auto q_frag = [&](int kk) {
    return smem_u32(q_s + (warp * 16 + (lm_m & 1) * 8 + lm_r) * kS + kk * 16 + (lm_m >> 1) * 8);
  };
  float o[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  const int row_lo = q0 + warp * 16 + g;                       // rows row_lo, row_lo + 8

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      load_kv(kt + 1);
      cp_async_commit();
      cp_async_wait<1>();                                      // tile kt has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQRegs) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < kKD; ++kk) ldsm_x4(q_frag(kk), qf[kk]);
      }
    }
    const bf16* ks = k_s + (kt & 1) * kBK * kS;
    const bf16* vs = v_s + (kt & 1) * kBK * kS;

    // S = Q·Kᵀ: 8 n8 tiles of keys, two per ldmatrix x4
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
      uint32_t qa[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        ldsm_x4(q_frag(kk), qa);
      }
#pragma unroll
      for (int jp = 0; jp < kBK / 16; ++jp) {
        uint32_t b[4];
        ldsm_x4(smem_u32(ks + (jp * 16 + (lm_m >> 1) * 8 + lm_r) * kS
                         + kk * 16 + (lm_m & 1) * 8), b);
        mma_bf16(s[2 * jp], qa, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qa, b[2], b[3]);
      }
    }

    // mask, online softmax
    const int k0 = kt * kBK, kn = min(kBK, sk - k0);
    const bool edge = kn < kBK || (causal && k0 + kBK - 1 > q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * c + (e & 1);
        float x = s[j][e];
        if (edge) {
          if (causal && k0 + col > row_lo + (e >> 1) * 8) x = kMasked;
          if (col < kn) mx[e >> 1] = fmaxf(mx[e >> 1], x);
        } else {
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
        s[j][e] = x;
      }
    }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = exp2f((m[h] - mx[h]) * scale_log2);
      m[h] = mx[h];
      mx[h] *= scale_log2;
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live = !edge || j * 8 + 2 * c + (e & 1) < kn;
        const float p = live ? exp2f(fmaf(s[j][e], scale_log2, -mx[e >> 1])) : 0.f;
        psum[e >> 1] += p;
        s[j][e] = p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + psum[h];   // this lane's columns
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P·V: p packed to bf16 is the A fragment of each 16-key step
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < kND / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(smem_u32(vs + (kk * 16 + (lm_m & 1) * 8 + lm_r) * kS
                               + np * 16 + (lm_m >> 1) * 8), b);
        mma_bf16(o[2 * np], a, b[0], b[1]);
        mma_bf16(o[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();                  // this stage is free for tile kt + 2
  }

  // l over the quad, then each warp parks its normalised rows (its own q_s
  // rows, read only by itself) and the block stores the tile row-major
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = 1.f / fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < kND; ++n) {
    bf16* dst = q_s + (warp * 16 + g) * kS + n * 8 + 2 * c;
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(o[n][0] * l[0], o[n][1] * l[0]);
    *reinterpret_cast<uint32_t*>(dst + 8 * kS) = pack_bf16(o[n][2] * l[1], o[n][3] * l[1]);
  }
  __syncthreads();
  bf16* ob = out + (bh * sq + q0) * D;
  for (int i = tid; i < rows * kChunks; i += kTcThreads) {
    const int r = i / kChunks, col = (i % kChunks) * 8;
    *reinterpret_cast<uint4*>(ob + r * D + col) =
        *reinterpret_cast<const uint4*>(q_s + r * kS + col);
  }
}

// ---------------------------------------------------------------------------
// float32: fp32 FMA pipes
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;            // q rows per block
constexpr int kF32BK = 32;         // keys per staged K/V tile
constexpr int kPS = kF32BK + 1;    // padded row stride of the p tile

// kSplit threads share a q row: each holds D / kSplit of its accumulators
// (interleaved 4-float chunks, so the row's lanes read neighbouring bytes)
// and the row's partial scores are summed over those lanes by shuffles.
// One thread per row up to D = 128; at D = 256 four, whose 64 accumulators
// fit in registers where 256 would spill.
template <int D>
constexpr int kF32Split = D <= 128 ? 1 : 4;

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         (kBQ * (D + 4) + kBQ * kF32Split<D> * kPS + 2 * kF32BK * D);
}

template <int D>
__global__ void __launch_bounds__(kBQ * kF32Split<D>)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int sq, int sk,
              int causal, float scale) {
  static_assert(D % 4 == 0, "D must be a multiple of 4");
  constexpr int kSplit = kF32Split<D>;
  constexpr int kThreads = kBQ * kSplit;
  constexpr int kCh = D / 4 / kSplit;                          // float4 chunks per thread
  static_assert(D % (4 * kSplit) == 0, "D must split evenly over a row's threads");
  constexpr int kQS = D + 4;                                   // padded q row stride
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                 // (kBQ, kQS)
  float* p_s = q_s + kBQ * kQS;                                // (kThreads, kPS)
  float* k_s = p_s + kThreads * kPS;                           // (kF32BK, D)
  float* v_s = k_s + kF32BK * D;                               // (kF32BK, D)

  const int tid = threadIdx.x;
  const int r_loc = tid / kSplit, sub = tid % kSplit;          // the thread's row and share
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;           // heaviest tiles first
  const int64_t bh = blockIdx.y;
  const int rows = min(kBQ, sq - q0);
  const int row = q0 + r_loc;

  const float* qb = q + (bh * sq + q0) * D;
  for (int i = tid; i < kBQ * D / 4; i += kThreads) {
    const int r = (4 * i) / D, c = (4 * i) % D;
    *reinterpret_cast<float4*>(q_s + r * kQS + c) =
        r < rows ? *reinterpret_cast<const float4*>(qb + r * D + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  float acc[4 * kCh];                                          // chunk t: columns 4·(sub + kSplit·t)
#pragma unroll
  for (int c = 0; c < 4 * kCh; ++c) acc[c] = 0.f;
  float m = kMasked, l = 0.f;

  int n_kt = (sk + kF32BK - 1) / kF32BK;
  if (causal) n_kt = min(n_kt, (q0 + rows - 1) / kF32BK + 1); // skip tiles above the diagonal
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kF32BK;
    const int kn = min(kF32BK, sk - k0);
    __syncthreads();                                           // last tile's readers are done
    const float* kb = k + (bh * sk + k0) * D;
    const float* vb = v + (bh * sk + k0) * D;
    for (int i = tid; i < kF32BK * D / 4; i += kThreads) {
      const int r = (4 * i) / D;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(k_s)[i] = r < kn ? reinterpret_cast<const float4*>(kb)[i] : zero;
      reinterpret_cast<float4*>(v_s)[i] = r < kn ? reinterpret_cast<const float4*>(vb)[i] : zero;
    }
    __syncthreads();

    float s[kF32BK];
#pragma unroll
    for (int j = 0; j < kF32BK; ++j) s[j] = 0.f;
#pragma unroll 1
    for (int t = 0; t < kCh; ++t) {
      const int c = 4 * (sub + kSplit * t);
      const float4 qv = *reinterpret_cast<const float4*>(q_s + r_loc * kQS + c);
#pragma unroll
      for (int j = 0; j < kF32BK; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(k_s + j * D + c);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }
#pragma unroll
    for (int off = 1; off < kSplit; off <<= 1) {               // a row's lanes are neighbours
#pragma unroll
      for (int j = 0; j < kF32BK; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
    }

    float m_new = m;
#pragma unroll
    for (int j = 0; j < kF32BK; ++j) {
      s[j] = (causal && k0 + j > row) ? kMasked : s[j] * scale;
      if (j < kn) m_new = fmaxf(m_new, s[j]);
    }
    const float corr = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kF32BK; ++j) {
      const float p = j < kn ? expf(s[j] - m_new) : 0.f;
      p_sum += p;
      p_s[tid * kPS + j] = p;
    }
    l = l * corr + p_sum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < 4 * kCh; ++c) acc[c] *= corr;
#pragma unroll 1
    for (int j = 0; j < kn; ++j) {
      const float p = p_s[tid * kPS + j];
#pragma unroll
      for (int t = 0; t < kCh; ++t) {
        const float4 vv =
            *reinterpret_cast<const float4*>(v_s + j * D + 4 * (sub + kSplit * t));
        acc[4 * t] = fmaf(p, vv.x, acc[4 * t]);
        acc[4 * t + 1] = fmaf(p, vv.y, acc[4 * t + 1]);
        acc[4 * t + 2] = fmaf(p, vv.z, acc[4 * t + 2]);
        acc[4 * t + 3] = fmaf(p, vv.w, acc[4 * t + 3]);
      }
    }
  }

  // each thread parks its share of the normalised row in its row of q_s
  // (read only by the row's own threads), then the block writes the tile
  // out row-major
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int t = 0; t < kCh; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      q_s[r_loc * kQS + 4 * (sub + kSplit * t) + e] = acc[4 * t + e] / den;
  }
  __syncthreads();
  float* ob = out + (bh * sq + q0) * D;
  for (int i = tid; i < rows * D; i += kThreads) ob[i] = q_s[(i / D) * kQS + i % D];
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) cudaGetLastError();   // clear it, so that the next launch reports its own
  return err;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, int bh, int sq, int sk,
              int causal, float scale, cudaStream_t st) {
  constexpr size_t smem = tc_smem_bytes<D>();
  const cudaError_t err = allow_smem(flash_fwd_tc<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = static_cast<int64_t>((sq + kTcBQ - 1) / kTcBQ) * bh;
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_tc<D><<<static_cast<unsigned>(blocks), kTcThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), sq, sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int bh, int sq, int sk,
               int causal, float scale, cudaStream_t st) {
  constexpr size_t smem = f32_smem_bytes<D>();
  const cudaError_t err = allow_smem(flash_fwd_f32<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  flash_fwd_f32<D><<<grid, kBQ * kF32Split<D>, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), sq, sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int is_bf16, const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int sk, int causal, float scale, cudaStream_t st) {
  return is_bf16 ? launch_tc<D>(q, k, v, out, bh, sq, sk, causal, scale, st)
                 : launch_f32<D>(q, k, v, out, bh, sq, sk, causal, scale, st);
}

}  // namespace

// q (bh, sq, d), k and v (bh, sk, d), out (bh, sq, d), all contiguous, of
// float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); d in {16, 32, 64, 80,
// 96, 128, 256}; sq, sk >= 1; bh <= 65535.  Returns cudaGetLastError() (or
// cudaErrorInvalidValue for another d).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int bh, int sq, int sk, int d, int causal, float scale,
                                      int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(is_bf16, q, k, v, out, bh, sq, sk, causal, scale, st);
    case 32: return launch<32>(is_bf16, q, k, v, out, bh, sq, sk, causal, scale, st);
    case 64: return launch<64>(is_bf16, q, k, v, out, bh, sq, sk, causal, scale, st);
    case 80: return launch<80>(is_bf16, q, k, v, out, bh, sq, sk, causal, scale, st);
    case 96: return launch<96>(is_bf16, q, k, v, out, bh, sq, sk, causal, scale, st);
    case 128: return launch<128>(is_bf16, q, k, v, out, bh, sq, sk, causal, scale, st);
    case 256: return launch<256>(is_bf16, q, k, v, out, bh, sq, sk, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
