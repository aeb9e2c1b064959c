// K2: fused data demodulation.
//
// Replaces the TPU kernel lte_gnu_radio_code_tpu/pallas_kernels/equalize.py
// (demod_windows, body _kernel): out[r] = coeff[r] * sqrt(B) * F[r] / |F[r]|
// with F[r] the DFT of window r on the B data bins (e^{-2 pi i b n / N}),
// |F[r]| its 2-norm over those B bins (power floored at 1e-30), and coeff
// the combined timing derotation x MMSE gain, one [B] vector for every row
// (coeff_ld = 0) or one per row (coeff_ld = B).
//
// What bounds it on the H100: HBM bytes.  A row reads its window (8 nfft
// bytes) and, on the chain's path, its own coefficients (8 B), and writes
// 8 B: 23,552 bytes per row at LTE1024 (B = 960), 35,584 at LTE2048
// (B = 1200), 1,472 at GOLDEN64 (B = 60); the 1024-point FFT's ~51 kFLOP is
// ~2 FLOP per byte, far under the card's float32 ratio.
// Design: the window goes once into shared memory (cp.async, 16 bytes a
// thread, queued while the previous window is transformed), runs the
// forward Stockham FFT there (fft.cuh), the B bins are gathered in used_bins
// order by an int32 table for the power and again for the output, which
// is scaled, multiplied by coeff and written once, 16 bytes a thread.  One
// row per block at nfft >= 1024, 256 / (nfft / 4) rows per block below;
// blocks walk the rows grid-stride.  nfft is a power of two in [16, 4096]
// (every shipped config); the wrapper refuses any other.

#include "common.cuh"
#include "fft.cuh"

namespace {

template <int N>
__global__ void __launch_bounds__(lte::kThreads)
equalize_fft_kernel(const float2* __restrict__ win,
                    const int* __restrict__ bins,
                    const float2* __restrict__ tw,
                    const float2* __restrict__ coeff, int coeff_ld,
                    float2* __restrict__ out, int k_rows, int nbins) {
  using Rows = lte::fft::Rows<N>;
  constexpr int T = Rows::T, R = Rows::R;
  extern __shared__ float4 smem[];
  __shared__ float red[lte::kThreads / 32];
  const int t = threadIdx.x % T, slot = threadIdx.x / T;
  float2* c = reinterpret_cast<float2*>(smem) + slot * 2 * N;   // staging
  float2* w = c + N;                                              // work
  const float sqrt_b = sqrtf((float)nbins);
  const int2* bins2 = reinterpret_cast<const int2*>(bins);
  const int groups = (k_rows + R - 1) / R;

  int g = blockIdx.x;
  if (g < groups) lte::fft::fetch_row<N, T>(c, win, g * R + slot, k_rows, t);
  for (; g < groups; g += gridDim.x) {
    const int r = g * R + slot, next = g + gridDim.x;
    lte::fft::copy_wait();
    lte::fft::row_sync<T>();
    lte::fft::transform<N, T, false>(c, w, tw, t, 1.f, [&] {
      if (next < groups)
        lte::fft::fetch_row<N, T>(c, win, next * R + slot, k_rows, t);
    });

    float pw[1] = {0.f};
    for (int q = t; q < nbins; q += T) {
      const float2 v = w[bins[q]];
      pw[0] += v.x * v.x + v.y * v.y;
    }
    lte::fft::row_sum<T>(pw, red);
    if (r >= k_rows) continue;
    const float scale = sqrt_b / sqrtf(fmaxf(pw[0], 1e-30f));
    auto eq = [&](float2 v, float2 cb) {
      const float fr = v.x * scale, fi = v.y * scale;
      return make_float2(fr * cb.x - fi * cb.y, fr * cb.y + fi * cb.x);
    };
    // nbins is even (used_bins): rows start on 16 bytes, two bins a store
    const float4* c4 =
        reinterpret_cast<const float4*>(coeff + (long)r * coeff_ld);
    float4* o = reinterpret_cast<float4*>(out + (long)r * nbins);
    for (int q = t; q < nbins / 2; q += T) {
      const int2 n = bins2[q];
      const float4 cb = c4[q];
      const float2 u = eq(w[n.x], make_float2(cb.x, cb.y));
      const float2 v = eq(w[n.y], make_float2(cb.z, cb.w));
      o[q] = make_float4(u.x, u.y, v.x, v.y);
    }
  }
}

}  // namespace

// win [k_rows, nfft], coeff [B] or [k_rows, B] complex64; bins: B (even)
// int32 wrapped bin indices in used_bins order; tw: fft.cuh's table for
// nfft.
extern "C" int equalize_fft(const void* win, const void* bins, const void* tw,
                            const void* coeff, int coeff_ld, void* out,
                            int k_rows, int nfft, int nbins, void* stream) {
  return lte::fft::dispatch(nfft, [&](auto n) {
    constexpr int N = decltype(n)::value;
    return lte::fft::launch<N, equalize_fft_kernel<N>>(
        k_rows, (cudaStream_t)stream,
        (const float2*)win, (const int*)bins, (const float2*)tw,
        (const float2*)coeff, coeff_ld, (float2*)out, k_rows, nbins);
  });
}
