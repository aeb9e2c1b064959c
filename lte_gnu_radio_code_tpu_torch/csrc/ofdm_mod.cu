// K1: fused OFDM modulator.
//
// Replaces the TPU kernel lte_gnu_radio_code_tpu/pallas_kernels/ofdm_mod.py
// (_mod_rows_planar, body _kernel): out[s] = normalise(CP(IDFT(rows[s]))),
// the row being the full nfft grid or K values on given bins.  The
// normalisation scales each CP-extended row to unit mean energy (skipped
// when the energy is <= 1e-30), then divides it by the square root of its
// mean-subtracted complex variance (floored at 1e-30).
//
// What bounds it on the H100: HBM bytes.  A row reads 8 K and writes
// 8 (nfft + cp) bytes: 18,432 per row at LTE1024 (8 KiB in, 10 KiB out),
// 36,864 at LTE2048, 1,152 at GOLDEN64, against a 1024-point FFT's
// ~51 kFLOP, about 2.8 FLOP per byte where the card sustains ~20 in float32.
// Design: the row goes once into shared memory (cp.async, 16 bytes a
// thread, queued while the previous row is transformed; the bins form
// zero-fills the row and scatters its K values by an int32 table, with
// shared atomics so repeated bins add as in the product), runs the inverse
// Stockham FFT there (fft.cuh; the 1/nfft is folded into the first stage,
// exact for a power of two), takes both norm passes over shared memory, and
// is written once with its CP, 16 bytes a thread.  One row per block at
// nfft >= 1024, 256 / (nfft / 4) rows per block below; blocks walk the
// rows grid-stride.  nfft is a power of two in [16, 4096] (every shipped
// config); the wrapper refuses any other.

#include "common.cuh"
#include "fft.cuh"

namespace {

// Two-stage norm of the CP-extended row x[nfft-cp..nfft) ++ x, whose last
// cp samples count twice: returns the (scale, inv) of out = (x scale) inv.
template <int T>
__device__ __forceinline__ float2 cp_norm(const float2* x, int nfft, int cp,
                                          int t, float* red) {
  const float inv_len = 1.f / (float)(nfft + cp);
  float m1[3] = {0.f, 0.f, 0.f};   // energy, sum re, sum im
  for (int n = t; n < nfft; n += T) {
    const float2 v = x[n];
    const float m = (n >= nfft - cp) ? 2.f : 1.f;
    m1[0] += m * (v.x * v.x + v.y * v.y);
    m1[1] += m * v.x;
    m1[2] += m * v.y;
  }
  lte::fft::row_sum<T>(m1, red);
  const float scale =
      m1[0] > 1e-30f ? 1.f / sqrtf(fmaxf(m1[0], 1e-30f) * inv_len) : 1.f;
  const float mr = m1[1] * scale * inv_len, mi = m1[2] * scale * inv_len;
  float p[1] = {0.f};
  for (int n = t; n < nfft; n += T) {
    const float2 v = x[n];
    const float m = (n >= nfft - cp) ? 2.f : 1.f;
    const float dr = v.x * scale - mr, di = v.y * scale - mi;
    p[0] += m * (dr * dr + di * di);
  }
  lte::fft::row_sum<T>(p, red);
  return make_float2(scale, 1.f / sqrtf(fmaxf(p[0] * inv_len, 1e-30f)));
}

template <int N>
__global__ void __launch_bounds__(lte::kThreads)
ofdm_mod_fft_kernel(const float2* __restrict__ vals,
                    const int* __restrict__ bins, int k,
                    const float2* __restrict__ tw, float2* __restrict__ out,
                    int s, int cp) {
  using Rows = lte::fft::Rows<N>;
  constexpr int T = Rows::T, R = Rows::R;
  extern __shared__ float4 smem[];
  __shared__ float red[3 * lte::kThreads / 32];
  const int t = threadIdx.x % T, slot = threadIdx.x / T;
  float2* c = reinterpret_cast<float2*>(smem) + slot * 2 * N;   // staging
  float2* w = c + N;                                              // work
  const float inv_n = 1.f / (float)N;
  const int len = N + cp, groups = (s + R - 1) / R;

  int g = blockIdx.x;
  if (bins == nullptr && g < groups)
    lte::fft::fetch_row<N, T>(c, vals, g * R + slot, s, t);
  for (; g < groups; g += gridDim.x) {
    const int r = g * R + slot, next = g + gridDim.x;
    if (bins != nullptr) {      // K values on bins[0..K), scattered
      for (int n = t; n < N; n += T) c[n] = make_float2(0.f, 0.f);
      lte::fft::row_sync<T>();
      for (int q = t; r < s && q < k; q += T) {
        const float2 v = vals[(long)r * k + q];
        atomicAdd(&c[bins[q]].x, v.x);
        atomicAdd(&c[bins[q]].y, v.y);
      }
    }
    lte::fft::copy_wait();
    lte::fft::row_sync<T>();
    // the 1/N of the inverse is exact for a power of two
    lte::fft::transform<N, T, true>(c, w, tw, t, inv_n, [&] {
      if (bins == nullptr && next < groups)
        lte::fft::fetch_row<N, T>(c, vals, next * R + slot, s, t);
    });

    const float2 sn = cp_norm<T>(w, N, cp, t, red);
    if (r >= s) continue;
    // output sample j is w[(j + N - cp) mod N]
    if (cp % 2 == 0) {          // rows start on 16 bytes: two samples a store
      float4* o = reinterpret_cast<float4*>(out + (long)r * len);
      for (int q = t; q < len / 2; q += T) {
        const int n = (2 * q + N - cp) & (N - 1);
        const float2 u = w[n], v = w[(n + 1) & (N - 1)];
        o[q] = make_float4((u.x * sn.x) * sn.y, (u.y * sn.x) * sn.y,
                           (v.x * sn.x) * sn.y, (v.y * sn.x) * sn.y);
      }
    } else {
      float2* o = out + (long)r * len;
      for (int j = t; j < len; j += T) {
        const float2 u = w[(j + N - cp) & (N - 1)];
        o[j] = make_float2((u.x * sn.x) * sn.y, (u.y * sn.x) * sn.y);
      }
    }
  }
}

}  // namespace

// vals [s, k] complex64; bins: k int32 bin positions in [0, nfft), or null
// for the full grid (k == nfft); tw: fft.cuh's table for nfft.
extern "C" int ofdm_mod_fft(const void* vals, const void* bins, int k,
                            const void* tw, void* out, int s, int nfft,
                            int cp, void* stream) {
  return lte::fft::dispatch(nfft, [&](auto n) {
    constexpr int N = decltype(n)::value;
    return lte::fft::launch<N, ofdm_mod_fft_kernel<N>>(
        s, (cudaStream_t)stream, (const float2*)vals,
        (const int*)bins, k, (const float2*)tw, (float2*)out, s, cp);
  });
}
