// K4: fused sync search.
//
// Replaces the TPU kernel lte_gnu_radio_code_tpu/pallas_kernels/sync_search.py
// (sync_corr_abs, bodies _kernel and _kernel_packed): for frame b, every
// stride-spaced trial p < n_trials and every delay hypothesis d < D = cp+1,
//
//   out[b, p, d] = |sum_{m < klen} x[b, cp + p s + m] K_d[m]|
//                  * sqrt(L / max(sum_l (N E_l - |DC_l|^2 - |NY_l|^2), 1e-30))
//
// where window l of trial p is the nfft samples from m = l (nfft + cp), E_l
// is the window's energy, DC_l its sum and NY_l its sum signed by (-1)^n
// over the in-window index n (the Parseval form of the synch-bin power,
// valid when num_synch_bins == nfft - 2).  Samples past the frame are zero.
//
// What bounds it on the H100: the correlation, 8 n_trials D klen float32
// FLOPs per frame (compute-bound: each x sample feeds D delays and each
// kernel tap TP trials).  No TF32: lock decisions compare against a gate.
//
// Design: block (trial tile of 32, delay tile of 32, frame).  It loads the
// one contiguous span of x its 32 trials read ((32-1) s + klen samples, for
// the dense s = 1 search and the strided s = cp-1 one alike) into shared
// memory once; that span is the Hankel tile, row p starting at p s.  Warps
// compute the per-trial Parseval norms from it, then the block streams
// K_d through shared memory in 32-deep chunks; thread (trial group, delay)
// accumulates 4 trials of one delay.  Delays past D are masked (D = 17, 257
// and 513 are not multiples of the tile).  The TPU version's G-group
// interleave and block-banded weights, which existed for sublane
// alignment, are gone; the stride is an argument.

#include "common.cuh"

namespace {

constexpr int kTpt = 4;                        // trials per thread
constexpr int kTy = lte::kThreads / 32;        // trial groups (warps)
constexpr int kTp = kTpt * kTy;                // trials per block
constexpr int kDt = 32;                        // delays per block
constexpr int kKc = 32;                        // K_d taps per stage

__global__ void __launch_bounds__(lte::kThreads)
sync_search_kernel(const float2* __restrict__ x, int n,
                   const float2* __restrict__ kt, int klen, int nd,
                   float* __restrict__ out, int n_trials, int cp, int stride,
                   int nfft, int m0, int rxb, float big_l) {
  extern __shared__ float2 smem[];
  const int span = (kTp - 1) * stride + klen;
  float2* xs = smem;                           // [span]
  float2* ks = xs + span;                      // [kKc][kDt]
  float* scale = (float*)(ks + kKc * kDt);     // [kTp]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p0 = blockIdx.x * kTp, d0 = blockIdx.y * kDt, b = blockIdx.z;
  const float2* xb = x + (long)b * n;
  const long base = cp + (long)p0 * stride;
  for (int i = tid; i < span; i += lte::kThreads) {
    const long j = base + i;
    xs[i] = j < n ? xb[j] : make_float2(0.f, 0.f);
  }
  __syncthreads();

  // per-trial Parseval power: warp w takes trials w, w + 8, ...
  for (int pl = warp; pl < kTp; pl += kTy) {
    const float2* xw = xs + (long)pl * stride;
    float s_pow = 0.f;
    for (int l = 0; l < m0; ++l) {
      float e = 0.f, dcr = 0.f, dci = 0.f, nyr = 0.f, nyi = 0.f;
      for (int k = lane; k < nfft; k += 32) {
        const float2 v = xw[l * rxb + k];
        const float sg = (k & 1) ? -1.f : 1.f;
        e += v.x * v.x + v.y * v.y;
        dcr += v.x;
        dci += v.y;
        nyr += sg * v.x;
        nyi += sg * v.y;
      }
      e = lte::warp_sum(e);
      dcr = lte::warp_sum(dcr);
      dci = lte::warp_sum(dci);
      nyr = lte::warp_sum(nyr);
      nyi = lte::warp_sum(nyi);
      s_pow += (float)nfft * e - (dcr * dcr + dci * dci) -
               (nyr * nyr + nyi * nyi);
    }
    if (lane == 0) scale[pl] = sqrtf(big_l / fmaxf(s_pow, 1e-30f));
  }

  const int dl = lane, ty = warp;
  float2 acc[kTpt];
#pragma unroll
  for (int i = 0; i < kTpt; ++i) acc[i] = make_float2(0.f, 0.f);
  for (int k0 = 0; k0 < klen; k0 += kKc) {
    __syncthreads();                           // previous stage consumed
    for (int i = tid; i < kKc * kDt; i += lte::kThreads) {
      const int kk = i / kDt, dd = i % kDt;
      const int gk = k0 + kk, gd = d0 + dd;
      ks[i] = (gk < klen && gd < nd) ? kt[(long)gk * nd + gd]
                                     : make_float2(0.f, 0.f);
    }
    __syncthreads();
    const int kmax = min(kKc, klen - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      const float2 kv = ks[kk * kDt + dl];
#pragma unroll
      for (int i = 0; i < kTpt; ++i) {
        const float2 xv = xs[(long)(ty + kTy * i) * stride + k0 + kk];
        acc[i].x = fmaf(xv.x, kv.x, fmaf(-xv.y, kv.y, acc[i].x));
        acc[i].y = fmaf(xv.x, kv.y, fmaf(xv.y, kv.x, acc[i].y));
      }
    }
  }
  __syncthreads();                             // scale[] from all warps
  const int d = d0 + dl;
  if (d >= nd) return;
#pragma unroll
  for (int i = 0; i < kTpt; ++i) {
    const int pl = ty + kTy * i, p = p0 + pl;
    if (p < n_trials) {
      const float mag = sqrtf(acc[i].x * acc[i].x + acc[i].y * acc[i].y);
      out[((long)b * n_trials + p) * nd + d] = mag * scale[pl];
    }
  }
}

}  // namespace

extern "C" int sync_search(const void* x, int batch, int n, const void* kt,
                           int klen, int nd, void* out, int n_trials, int cp,
                           int stride, int nfft, int m0, int rxb, float big_l,
                           void* stream) {
  const size_t span = (size_t)(kTp - 1) * stride + klen;
  const size_t smem = span * sizeof(float2) + kKc * kDt * sizeof(float2) +
                      kTp * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sync_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_trials + kTp - 1) / kTp, (nd + kDt - 1) / kDt, batch);
  sync_search_kernel<<<grid, lte::kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)x, n, (const float2*)kt, klen, nd, (float*)out,
      n_trials, cp, stride, nfft, m0, rxb, big_l);
  return (int)cudaGetLastError();
}
