// K1: fused OFDM modulator.
//
// Replaces the TPU kernel lte_gnu_radio_code_tpu/pallas_kernels/ofdm_mod.py
// (_mod_rows_planar, body _kernel): out[s] = normalise(CP(rows[s] @ W)),
// with W the [K, nfft] IDFT basis (full, or restricted to the data bins).
// The normalisation scales each CP-extended row to unit mean energy
// (skipped when the energy is <= 1e-30), then divides it by the square root
// of its mean-subtracted complex variance (floored at 1e-30).
//
// What bounds it on the H100: the complex product, 8*S*K*nfft float32
// FLOPs, against 8*S*(K + nfft + cp) bytes of traffic — at K = nfft >= 64
// it is compute-bound on the CUDA cores (no TF32: the chain's lock and bit
// decisions are held to float32 results).
//
// Design: one block owns 16 whole rows.  Phase 1 is the shared-memory
// tiled complex product (common.cuh), written straight into the output
// row after the CP slot.  Phase 2, after a block barrier, reads each row
// back (one warp per row, from L2), reduces energy, mean and variance,
// and rescales in place, writing the CP copy in the same pass.  No row is
// split across blocks, so the per-row norm needs no second launch; the
// TPU version's host-side row slabs and lane padding are gone.

#include "common.cuh"

namespace {

using lte::cgemm::RT;

__global__ void __launch_bounds__(lte::kThreads)
ofdm_mod_kernel(const float2* __restrict__ rows, const float2* __restrict__ w,
                float2* __restrict__ out, int s, int k, int nfft, int cp) {
  __shared__ lte::cgemm::Smem smem;
  const int row0 = blockIdx.x * RT;
  const int len = nfft + cp;
  lte::cgemm::rows(rows, s, k, w, nfft, out + cp, len, row0, smem);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float inv_len = 1.f / (float)len;
  for (int rr = warp; rr < RT; rr += lte::kThreads / 32) {
    const int r = row0 + rr;
    if (r >= s) break;
    float2* row = out + (long)r * len;
    float2* x = row + cp;          // the IDFT output, x[0..nfft)
    // the CP-extended row is x[nfft-cp..nfft) ++ x: tail samples count twice
    float e = 0.f, sr = 0.f, si = 0.f;
    for (int n = lane; n < nfft; n += 32) {
      const float2 v = x[n];
      const float m = (n >= nfft - cp) ? 2.f : 1.f;
      e += m * (v.x * v.x + v.y * v.y);
      sr += m * v.x;
      si += m * v.y;
    }
    e = lte::warp_sum(e);
    sr = lte::warp_sum(sr);
    si = lte::warp_sum(si);
    const float scale = e > 1e-30f ? 1.f / sqrtf(fmaxf(e, 1e-30f) * inv_len)
                                   : 1.f;
    const float mr = sr * scale * inv_len, mi = si * scale * inv_len;
    float p = 0.f;
    for (int n = lane; n < nfft; n += 32) {
      const float2 v = x[n];
      const float m = (n >= nfft - cp) ? 2.f : 1.f;
      const float dr = v.x * scale - mr, di = v.y * scale - mi;
      p += m * (dr * dr + di * di);
    }
    p = lte::warp_sum(p) * inv_len;
    const float inv = 1.f / sqrtf(fmaxf(p, 1e-30f));
    // each sample is read and rewritten by the same lane; the CP slots
    // [0, cp) are written, never read
    for (int n = lane; n < nfft; n += 32) {
      const float2 v = x[n];
      const float2 o = make_float2((v.x * scale) * inv, (v.y * scale) * inv);
      x[n] = o;
      if (n >= nfft - cp) row[n - (nfft - cp)] = o;
    }
  }
}

}  // namespace

extern "C" int ofdm_mod_rows(const void* rows, const void* w, void* out,
                             int s, int k, int nfft, int cp, void* stream) {
  const dim3 grid((s + RT - 1) / RT);
  ofdm_mod_kernel<<<grid, lte::kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)rows, (const float2*)w, (float2*)out, s, k, nfft, cp);
  return (int)cudaGetLastError();
}
