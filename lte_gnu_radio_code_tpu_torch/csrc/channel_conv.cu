// K3: short-CIR multipath channel convolution.
//
// Replaces the TPU kernel lte_gnu_radio_code_tpu/pallas_kernels/channel_conv.py
// (conv_frames, body _kernel; wrapper apply_channel_frames):
// y[b, m] = sum_{k < t} h[k] * x[b, m - k], t <= 16 complex taps, summed in
// ascending k (the order of ops/channel.py's shifted-add form), for every
// m < n_out; samples past n + t - 1 come out zero, so the output is already
// the zero-tailed [B, n + max_impulse - 1] frame.
//
// What bounds it on the H100: memory.  8 t FLOPs per output sample against
// 16 bytes moved (read x once, write y once); at t = 5 that is 2.5 FLOP/B,
// far below the card's ridge point.
//
// Design: a 1-D stencil.  Each block stages a 1024-sample tile of one
// frame plus its 15-sample left halo in shared memory (coalesced, zeros
// outside the frame) and every thread computes 4 outputs from it.  The taps
// travel by value in the kernel's parameter space (the constant bank), the
// counterpart of the TPU kernel's trace-time constants.  The overlap-save
// re-rowing the TPU version needed to fit VMEM is gone.

#include "common.cuh"

namespace {

constexpr int kMaxTaps = 16;
constexpr int kTile = 1024;
constexpr int kHalo = kMaxTaps - 1;

struct Taps {
  float2 h[kMaxTaps];
  int t;
};

__global__ void __launch_bounds__(lte::kThreads)
channel_conv_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                    int n, int n_out, Taps taps) {
  __shared__ float2 xs[kTile + kHalo];
  const int m0 = blockIdx.x * kTile;
  const float2* xb = x + (long)blockIdx.y * n;
  float2* yb = y + (long)blockIdx.y * n_out;
  for (int i = threadIdx.x; i < kTile + kHalo; i += lte::kThreads) {
    const int j = m0 - kHalo + i;
    xs[i] = (j >= 0 && j < n) ? xb[j] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile; i += lte::kThreads) {
    const int m = m0 + i;
    if (m >= n_out) break;
    float yr = 0.f, yi = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) {
      if (k < taps.t) {
        const float2 v = xs[i + kHalo - k];        // x[m - k]
        const float2 h = taps.h[k];
        yr = yr + (h.x * v.x - h.y * v.y);
        yi = yi + (h.x * v.y + h.y * v.x);
      }
    }
    yb[m] = make_float2(yr, yi);
  }
}

}  // namespace

extern "C" int channel_conv(const void* x, void* y, int batch, int n,
                            int n_out, const void* taps_ri, int t,
                            void* stream) {
  if (t < 1 || t > kMaxTaps) return (int)cudaErrorInvalidValue;
  Taps taps{};
  const float* ri = (const float*)taps_ri;     // host memory: re, im pairs
  for (int k = 0; k < t; ++k) taps.h[k] = make_float2(ri[2 * k], ri[2 * k + 1]);
  taps.t = t;
  const dim3 grid((n_out + kTile - 1) / kTile, batch);
  channel_conv_kernel<<<grid, lte::kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)x, (float2*)y, n, n_out, taps);
  return (int)cudaGetLastError();
}
