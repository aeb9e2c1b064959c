// K2: fused data demodulation.
//
// Replaces the TPU kernel lte_gnu_radio_code_tpu/pallas_kernels/equalize.py
// (demod_windows, body _kernel): out[r] = coeff[r] * sqrt(B) * F[r] / |F[r]|
// with F = win @ V, V the [nfft, B] DFT basis on the B data bins, |F[r]|
// the row's 2-norm (power floored at 1e-30), and coeff the combined timing
// derotation x MMSE gain, one [B] vector for every row (coeff_ld = 0) or
// one per row (coeff_ld = B).
//
// What bounds it on the H100: the complex product, 8*K*nfft*B float32
// FLOPs against 8*K*(nfft + 2B) bytes — compute-bound on the CUDA cores
// at every shipped nfft (no TF32).
//
// Design: the same row-owning block product as K1 (common.cuh) writes F
// into the output; after a block barrier one warp per row reduces the
// row's power over the true B bins (no lane padding exists here, so no
// padded bin can enter the norm) and applies scale and coefficient in
// place.  The TPU version's host-side row cap is gone.

#include "common.cuh"

namespace {

using lte::cgemm::RT;

__global__ void __launch_bounds__(lte::kThreads)
equalize_kernel(const float2* __restrict__ win, const float2* __restrict__ v,
                const float2* __restrict__ coeff, int coeff_ld,
                float2* __restrict__ out, int k_rows, int nfft, int nbins) {
  __shared__ lte::cgemm::Smem smem;
  const int row0 = blockIdx.x * RT;
  lte::cgemm::rows(win, k_rows, nfft, v, nbins, out, nbins, row0, smem);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float sqrt_b = sqrtf((float)nbins);
  for (int rr = warp; rr < RT; rr += lte::kThreads / 32) {
    const int r = row0 + rr;
    if (r >= k_rows) break;
    float2* f = out + (long)r * nbins;
    const float2* c = coeff + (long)r * coeff_ld;
    float pw = 0.f;
    for (int b = lane; b < nbins; b += 32) {
      const float2 x = f[b];
      pw += x.x * x.x + x.y * x.y;
    }
    pw = lte::warp_sum(pw);
    const float scale = sqrt_b / sqrtf(fmaxf(pw, 1e-30f));
    for (int b = lane; b < nbins; b += 32) {
      const float2 x = f[b], cb = c[b];
      const float fr = x.x * scale, fi = x.y * scale;
      f[b] = make_float2(fr * cb.x - fi * cb.y, fr * cb.y + fi * cb.x);
    }
  }
}

}  // namespace

extern "C" int equalize_demod(const void* win, const void* v,
                              const void* coeff, int coeff_ld, void* out,
                              int k_rows, int nfft, int nbins, void* stream) {
  const dim3 grid((k_rows + RT - 1) / RT);
  equalize_kernel<<<grid, lte::kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)win, (const float2*)v, (const float2*)coeff, coeff_ld,
      (float2*)out, k_rows, nfft, nbins);
  return (int)cudaGetLastError();
}
