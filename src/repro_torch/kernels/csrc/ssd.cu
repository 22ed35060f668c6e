// ssd_chunk: the Mamba-2 SSD scan over chunks, x (BH, S, P), dt (BH, S),
// a (BH,), B and C (BH, S, N), fp32 → y (BH, S, P), final state (BH, P, N).
//
// Replaces the TPU kernel `_kernel` / `ssd_chunk_pallas` in
// src/repro/kernels/ssd.py.  Per chunk of Q steps, with cum the running sum
// of dt·a restarted in every chunk and prev the state before the chunk:
//   y    = ((C Bᵀ) ⊙ L ⊙ dtᵀ) x + exp(cum) ⊙ (C prevᵀ),
//          L[i, j] = exp(cum_i - cum_j) for i >= j, else 0
//   next = exp(cum_last) prev + xᵀ (B ⊙ exp(cum_last - cum) dt)
// The decay is masked before exp: for i < j, cum_i - cum_j is positive and
// may be hundreds, whose exp is inf, and inf·0 is NaN.
//
// The TPU kernel holds a whole chunk in VMEM (x, B, C, the Q×Q weights and
// the state, about 0.6 MB at Q = 256, P = 64, N = 128) and carries the state
// through its sequential grid.  A block here has at most 227 KB, so:
//   - one block of 256 threads per (batch·head) loops over the chunks in
//     order, with the state (N×P, n-major) in shared memory the whole time;
//   - every product is cut into 64×64 output tiles, each thread owning a
//     4×4 sub-tile in registers and reading its operands as 16-byte
//     shared-memory loads from k-major staging buffers;
//   - the Q×Q weights are never held whole: for each 64-row block of y the
//     kernel walks the 64-column blocks on or below the diagonal, forms the
//     C·Bᵀ tile from 32-wide slices of C and B streamed through shared
//     memory, applies the masked decay and dt, and multiplies the tile into
//     the y accumulators at once; blocks above the diagonal are skipped.
// Shared memory at Q = 256, P = 64, N = 128: 88 KB, so two blocks fit on an
// SM.
//
// Bound: operations, on the fp32 pipes (the reference is fp32).  At
// mamba2-780m widths (192 heads·batch, S = 4096, Q = 256, P = 64, N = 128)
// the work is about 6.5e10 FLOPs against 1.2 GB of inputs and outputs.
// With one block per (batch·head) the 192 blocks fill 96 of the 132 SMs;
// a chunk-parallel design with a separate state scan is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;            // output tile edge
constexpr int kKN = 32;           // depth of one staged slice of C or B
constexpr int kLd = kT + 4;       // padded row stride of the staging buffers
constexpr int kThreads = 256;     // 16 × 16 threads, 4 × 4 outputs each

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// acc[a][b] += Σ_k A[k][4·ty + a] · B[k][4·tx + b], A and B k-major in
// shared memory with 16-byte aligned rows
__device__ __forceinline__ void mma_tile(float (&acc)[4][4], const float* A, int lda,
                                         const float* B, int ldb, int depth, int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < depth; ++kk) {
    const float4 av = *reinterpret_cast<const float4*>(A + kk * lda + 4 * ty);
    const float4 bv = *reinterpret_cast<const float4*>(B + kk * ldb + 4 * tx);
    const float a4[4] = {av.x, av.y, av.z, av.w};
    const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(a4[a], b4[b], acc[a][b]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
}

// dst[k][r] = src[(r0 + r) * ld + k0 + k] for r < 64, k < 32 (transposed),
// zero where r0 + r >= rows or k0 + k >= cols
__device__ __forceinline__ void stage_t(float* dst, const float* src, int ld, int r0, int rows,
                                        int k0, int cols) {
  for (int i = threadIdx.x; i < kT * kKN; i += kThreads) {
    const int r = i / kKN, k = i % kKN;
    dst[k * kLd + r] = (r0 + r < rows && k0 + k < cols)
                           ? src[static_cast<int64_t>(r0 + r) * ld + k0 + k] : 0.f;
  }
}

// dst[r][c] = src[(r0 + r) * ld + c0 + c] · (scale ? scale[r0 + r] : 1) for
// r, c < 64, zero where r0 + r >= rows or c0 + c >= cols
__device__ __forceinline__ void stage(float* dst, const float* src, int ld, int r0, int rows,
                                      int c0, int cols, const float* scale) {
  for (int i = threadIdx.x; i < kT * kT; i += kThreads) {
    const int r = i / kT, c = i % kT;
    float val = 0.f;
    if (r0 + r < rows && c0 + c < cols) {
      val = src[static_cast<int64_t>(r0 + r) * ld + c0 + c];
      if (scale != nullptr) val *= scale[r0 + r];
    }
    dst[r * kLd + c] = val;
  }
}

struct Smem {
  float *cum, *dts, *tail, *ct, *bt, *wt, *xs, *st;
  int lds;                        // row stride of the state buffer
};

__device__ __forceinline__ Smem carve(float* base, int q, int p, int n) {
  Smem s;
  const int qp = round_up(q, kT);
  s.cum = base;
  s.dts = s.cum + qp;
  s.tail = s.dts + qp;            // exp(cum_last - cum_j) · dt_j
  s.ct = s.tail + qp;             // (kKN, kLd): C slice, k-major
  s.bt = s.ct + kKN * kLd;        // (kKN, kLd): B slice, k-major
  s.wt = s.bt + kKN * kLd;        // (kT, kLd): weights tile (j-major) / scaled B
  s.xs = s.wt + kT * kLd;         // (kT, kLd): x tile
  s.st = s.xs + kT * kLd;         // (round_up(n, kKN), lds): state, n-major
  s.lds = round_up(p, kT) + 4;
  return s;
}

__host__ __device__ constexpr size_t smem_floats(int q, int p, int n) {
  return static_cast<size_t>(3 * round_up(q, kT) + 2 * kKN * kLd + 2 * kT * kLd) +
         static_cast<size_t>(round_up(n, kKN)) * (round_up(p, kT) + 4);
}

__global__ void __launch_bounds__(kThreads)
ssd_scan(const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
         const float* __restrict__ bm, const float* __restrict__ cm, float* __restrict__ y,
         float* __restrict__ state_out, int s_len, int p, int n, int q) {
  extern __shared__ __align__(16) float smem[];
  const Smem sm = carve(smem, q, p, n);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t bh = blockIdx.x;
  const float a_h = a[bh];
  const int n_rows = round_up(n, kKN);
  for (int i = tid; i < n_rows * sm.lds; i += kThreads) sm.st[i] = 0.f;

  for (int t0 = 0; t0 < s_len; t0 += q) {
    const float* xc = x + (bh * s_len + t0) * p;       // (q, p)
    const float* bc = bm + (bh * s_len + t0) * n;      // (q, n)
    const float* cc = cm + (bh * s_len + t0) * n;      // (q, n)
    float* yc = y + (bh * s_len + t0) * p;
    __syncthreads();                                   // last chunk's state update is done
    for (int i = tid; i < q; i += kThreads) sm.dts[i] = dt[bh * s_len + t0 + i];
    __syncthreads();
    if (tid == 0) {                                    // cum restarts in every chunk
      float run = 0.f;
      for (int i = 0; i < q; ++i) {
        run += sm.dts[i] * a_h;
        sm.cum[i] = run;
      }
    }
    __syncthreads();
    const float cum_last = sm.cum[q - 1];
    for (int i = tid; i < q; i += kThreads) sm.tail[i] = expf(cum_last - sm.cum[i]) * sm.dts[i];

    // y, one 64×64 tile (rows i0.., columns pb..) at a time
    for (int i0 = 0; i0 < q; i0 += kT) {
      for (int pb = 0; pb < p; pb += kT) {
        float acc[4][4];
        zero(acc);
        // inter-chunk part: exp(cum_i) · Σ_n C[i][n] prev[p][n]
        for (int n0 = 0; n0 < n; n0 += kKN) {
          __syncthreads();
          stage_t(sm.ct, cc, n, i0, q, n0, n);
          __syncthreads();
          mma_tile(acc, sm.ct, kLd, sm.st + n0 * sm.lds + pb, sm.lds, kKN, ty, tx);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + 4 * ty + r;
          const float e = i < q ? expf(sm.cum[i]) : 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] *= e;
        }
        // intra-chunk part: column blocks on or below the diagonal
        for (int j0 = 0; j0 <= i0; j0 += kT) {
          float cb[4][4];
          zero(cb);
          for (int n0 = 0; n0 < n; n0 += kKN) {
            __syncthreads();
            stage_t(sm.ct, cc, n, i0, q, n0, n);
            stage_t(sm.bt, bc, n, j0, q, n0, n);
            __syncthreads();
            mma_tile(cb, sm.ct, kLd, sm.bt, kLd, kKN, ty, tx);
          }
          // w[i][j] = cb · exp(cum_i - cum_j) · dt_j for i >= j, else 0,
          // stored j-major as the next product's k-major operand
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + 4 * ty + r;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int j = j0 + 4 * tx + c;
              const float w = (i < q && j <= i)
                                  ? cb[r][c] * expf(sm.cum[i] - sm.cum[j]) * sm.dts[j] : 0.f;
              sm.wt[(4 * tx + c) * kLd + 4 * ty + r] = w;
            }
          }
          stage(sm.xs, xc, p, j0, q, pb, p, nullptr);
          __syncthreads();
          mma_tile(acc, sm.wt, kLd, sm.xs, kLd, kT, ty, tx);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + 4 * ty + r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int pc = pb + 4 * tx + c;
            if (i < q && pc < p) yc[static_cast<int64_t>(i) * p + pc] = acc[r][c];
          }
        }
      }
    }

    // next state = exp(cum_last) · prev + Σ_j x[j]ᵀ (B[j] · exp(cum_last - cum_j) · dt_j),
    // one (p, n) tile at a time; the y tiles above have read prev already
    const float e_last = expf(cum_last);
    for (int pb = 0; pb < p; pb += kT) {
      for (int nb = 0; nb < n; nb += kT) {
        float acc[4][4];
        zero(acc);
        for (int j0 = 0; j0 < q; j0 += kT) {
          __syncthreads();
          stage(sm.xs, xc, p, j0, q, pb, p, nullptr);
          stage(sm.wt, bc, n, j0, q, nb, n, sm.tail);
          __syncthreads();
          mma_tile(acc, sm.xs, kLd, sm.wt, kLd, kT, ty, tx);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int pr = pb + 4 * ty + r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int nc = nb + 4 * tx + c;
            if (pr < p && nc < n) {
              float* slot = sm.st + nc * sm.lds + pr;
              *slot = e_last * *slot + acc[r][c];
            }
          }
        }
      }
    }
  }
  __syncthreads();
  float* so = state_out + bh * p * n;
  for (int i = tid; i < p * n; i += kThreads) so[i] = sm.st[(i % n) * sm.lds + i / n];
}

}  // namespace

// x (bh, s, p), dt (bh, s), a (bh,), b and c (bh, s, n) fp32, contiguous;
// s % q == 0, q >= 1 → y (bh, s, p), state (bh, p, n).  Returns
// cudaGetLastError(), or the error of cudaFuncSetAttribute where the shared
// memory this (q, p, n) needs exceeds what a block can have.
extern "C" int ssd_chunk_launch(const float* x, const float* dt, const float* a,
                                const float* b, const float* c, float* y, float* state,
                                int bh, int s, int p, int n, int q, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_floats(q, p, n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();           // clear it, so that the next launch reports its own
    return static_cast<int>(err);
  }
  ssd_scan<<<bh, kThreads, smem, st>>>(x, dt, a, b, c, y, state, s, p, n, q);
  return static_cast<int>(cudaGetLastError());
}
