// flash_attention: online-softmax attention, q (BH, Sq, D), k/v (BH, Sk, D),
// in float32 or bfloat16, output in the inputs' type.
//
// Replaces the TPU kernel `_kernel` / `flash_attention_pallas` in
// src/repro/kernels/flash_attention.py.  Semantics kept from it: scores in
// fp32 at scale D^-0.5; the causal mask keeps k_pos <= q_pos counted from
// position 0 (also when Sq != Sk), masked scores are -1e30; running (m, l,
// acc) in fp32; p is rounded to v's type before the P·V product (l sums the
// unrounded p); the output is acc / max(l, 1e-30), cast to the inputs' type.
//
// Design: one block of 64 threads per (bh, 64-row q tile), one thread per q
// row.  The q tile is staged once in shared memory as fp32 (rows padded by 4
// floats so that the threads' 16-byte reads hit distinct banks); K and V are
// staged 32 keys at a time in their own type.  Every thread reads the same
// K/V element at the same time (a shared-memory broadcast), so the inner
// loops are 16-byte loads feeding 4 FMAs each, with the row's 32 scores and
// its D accumulators in registers.  The TPU kernel computes the key tiles
// that lie wholly above the diagonal and masks them; here a causal block
// stops at the last key tile its last row can see, and the blocks are
// ordered heaviest first.  Keys past Sk and rows past Sq (the ragged edges)
// are masked in the kernel itself.
//
// Bound: operations.  At h2o-danube-1.8b prefill (64 heads, 4096 tokens,
// D = 80, causal) the work is 4·D FLOPs per (q, k) pair the mask keeps,
// 1.7e11 FLOPs against 168 MB of q, k, v and output.  This first kernel runs
// on the fp32 FMA pipes, not the tensor cores (wgmma and TMA are later work).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;            // q rows per block == threads per block
constexpr int kBK = 32;            // keys per staged K/V tile
constexpr int kPS = kBK + 1;       // padded row stride of the p tile
constexpr float kMasked = -1e30f;  // the reference's mask value

// four consecutive elements of T, moved as one word
template <typename T> struct Pack4;
template <> struct Pack4<float> { using type = float4; };
template <> struct Pack4<__nv_bfloat16> { using type = uint2; };

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// x rounded to T (round to nearest even) and back to float
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * kBQ * (D + 4) + sizeof(float) * kBQ * kPS + 2 * sizeof(T) * kBK * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(kBQ)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ out, int sq, int sk, int causal, float scale) {
  static_assert(D % 4 == 0, "D must be a multiple of 4");
  constexpr int kQS = D + 4;                                   // padded q row stride
  using P4 = typename Pack4<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                 // (kBQ, kQS) fp32
  float* p_s = q_s + kBQ * kQS;                                // (kBQ, kPS) fp32
  T* k_s = reinterpret_cast<T*>(p_s + kBQ * kPS);              // (kBK, D)
  T* v_s = k_s + kBK * D;                                      // (kBK, D)

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;           // heaviest tiles first
  const int64_t bh = blockIdx.y;
  const int rows = min(kBQ, sq - q0);
  const int row = q0 + tid;

  const T* qb = q + (bh * sq + q0) * D;
  for (int i = tid; i < kBQ * D / 4; i += kBQ) {
    const int r = (4 * i) / D, c = (4 * i) % D;
    *reinterpret_cast<float4*>(q_s + r * kQS + c) =
        r < rows ? load4(qb + r * D + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  float m = kMasked, l = 0.f;

  int n_kt = (sk + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + rows - 1) / kBK + 1);    // skip tiles above the diagonal
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    const int kn = min(kBK, sk - k0);
    __syncthreads();                                           // last tile's readers are done
    const T* kb = k + (bh * sk + k0) * D;
    const T* vb = v + (bh * sk + k0) * D;
    for (int i = tid; i < kBK * D / 4; i += kBQ) {
      const int r = (4 * i) / D;
      const P4 zero{};
      reinterpret_cast<P4*>(k_s)[i] = r < kn ? reinterpret_cast<const P4*>(kb)[i] : zero;
      reinterpret_cast<P4*>(v_s)[i] = r < kn ? reinterpret_cast<const P4*>(vb)[i] : zero;
    }
    __syncthreads();

    float s[kBK];
#pragma unroll
    for (int j = 0; j < kBK; ++j) s[j] = 0.f;
#pragma unroll 1
    for (int c = 0; c < D; c += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(q_s + tid * kQS + c);
#pragma unroll
      for (int j = 0; j < kBK; ++j) {
        const float4 kv = load4(k_s + j * D + c);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }

    float m_new = m;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = (causal && k0 + j > row) ? kMasked : s[j] * scale;
      if (j < kn) m_new = fmaxf(m_new, s[j]);
    }
    const float corr = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = j < kn ? expf(s[j] - m_new) : 0.f;
      p_sum += p;
      p_s[tid * kPS + j] = round_to(p, k_s);
    }
    l = l * corr + p_sum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] *= corr;
#pragma unroll 1
    for (int j = 0; j < kn; ++j) {
      const float p = p_s[tid * kPS + j];
#pragma unroll
      for (int c = 0; c < D; c += 4) {
        const float4 vv = load4(v_s + j * D + c);
        acc[c] = fmaf(p, vv.x, acc[c]);
        acc[c + 1] = fmaf(p, vv.y, acc[c + 1]);
        acc[c + 2] = fmaf(p, vv.z, acc[c + 2]);
        acc[c + 3] = fmaf(p, vv.w, acc[c + 3]);
      }
    }
  }

  // each thread parks its normalised row in its own q_s row, then the block
  // writes the tile out row-major
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < D; ++c) q_s[tid * kQS + c] = acc[c] / den;
  __syncthreads();
  T* ob = out + (bh * sq + q0) * D;
  for (int i = tid; i < rows * D; i += kBQ) store(ob + i, q_s[(i / D) * kQS + i % D]);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int sq, int sk,
           int causal, float scale, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();           // clear it, so that the next launch reports its own
    return static_cast<int>(err);
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  flash_fwd<T, D><<<grid, kBQ, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* out, int bh, int sq,
             int sk, int causal, float scale, cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, bh, sq, sk, causal, scale, st);
    case 32: return launch<T, 32>(q, k, v, out, bh, sq, sk, causal, scale, st);
    case 64: return launch<T, 64>(q, k, v, out, bh, sq, sk, causal, scale, st);
    case 80: return launch<T, 80>(q, k, v, out, bh, sq, sk, causal, scale, st);
    case 128: return launch<T, 128>(q, k, v, out, bh, sq, sk, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (bh, sq, d), k and v (bh, sk, d), out (bh, sq, d), all contiguous, of
// float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); d in {16, 32, 64, 80,
// 128}; sq, sk >= 1; bh <= 65535.  Returns cudaGetLastError() (or
// cudaErrorInvalidValue for another d).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int bh, int sq, int sk, int d, int causal, float scale,
                                      int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_d<__nv_bfloat16>(d, q, k, v, out, bh, sq, sk, causal, scale, st)
                 : launch_d<float>(d, q, k, v, out, bh, sq, sk, causal, scale, st);
}
