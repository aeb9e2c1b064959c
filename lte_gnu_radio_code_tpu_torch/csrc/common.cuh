// Shared device code of the port's kernels.
//
// cgemm_rows: the complex row-block product that K1 (ofdm_mod.cu) and K2
// (equalize.cu) share.  One thread block owns RT whole rows of the output:
// it walks every column tile of the row, and inside each tile loops over
// the contraction in KC-deep chunks staged through shared memory (the
// Pallas kernels carried this sum across sequential grid steps in VMEM
// scratch; blocks on the GPU run in no order, so the loop lives inside the
// block).  Owning whole rows lets the caller's per-row epilogue (a norm over
// the full row) run in the same launch after a __syncthreads().
//
// Arithmetic is float32 FFMA on the CUDA cores (no TF32).  Complex values
// are float2 (re, im), the layout of a contiguous torch.complex64 tensor.

#pragma once

#include <cuda_runtime.h>

namespace lte {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

namespace cgemm {

constexpr int RT = 16;   // rows per block
constexpr int CT = 64;   // output columns per tile
constexpr int KC = 16;   // contraction depth per shared-memory stage

struct Smem {
  float2 a[RT][KC];
  float2 b[KC][CT];
};

// C[r, c] = sum_k A[r, k] * B[k, c] for rows row0..row0+RT-1 (< M) and all
// columns c < N.  A is [M, K] row-major, B is [K, N] row-major, C row r
// starts at C + r * ldc.  256 threads: thread (ty, tx) = (tid / 16,
// tid % 16) owns row row0 + ty and columns tx + 16 j, j < 4, of each tile.
__device__ __forceinline__ void rows(const float2* __restrict__ A, int M,
                                     int K, const float2* __restrict__ B,
                                     int N, float2* __restrict__ C,
                                     long ldc, int row0, Smem& s) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float2 zero = make_float2(0.f, 0.f);
  for (int c0 = 0; c0 < N; c0 += CT) {
    float2 acc[4] = {zero, zero, zero, zero};
    for (int k0 = 0; k0 < K; k0 += KC) {
      {
        const int r = tid / KC, k = tid % KC;   // RT * KC == kThreads
        const int gr = row0 + r, gk = k0 + k;
        s.a[r][k] = (gr < M && gk < K) ? A[(long)gr * K + gk] : zero;
      }
      for (int i = tid; i < KC * CT; i += kThreads) {
        const int k = i / CT, c = i % CT;
        const int gk = k0 + k, gc = c0 + c;
        s.b[k][c] = (gk < K && gc < N) ? B[(long)gk * N + gc] : zero;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const float2 a = s.a[ty][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 b = s.b[k][tx + 16 * j];
          acc[j].x = fmaf(a.x, b.x, fmaf(-a.y, b.y, acc[j].x));
          acc[j].y = fmaf(a.x, b.y, fmaf(a.y, b.x, acc[j].y));
        }
      }
      __syncthreads();
    }
    const int gr = row0 + ty;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = c0 + tx + 16 * j;
      if (gr < M && gc < N) C[(long)gr * ldc + gc] = acc[j];
    }
  }
}

}  // namespace cgemm
}  // namespace lte
