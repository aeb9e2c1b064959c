// The 2x2 LMMSE detection of spatial multiplexing (SpMult), as a pair of
// kernels.
//
// Replaces no Pallas kernel: the JAX package leaves this stage to XLA
// (lte_gnu_radio_code_tpu/models/mimo.py:rx_frame_mimo, W and its product
// with every data symbol as jnp matmuls).  The port ran it as plain torch,
// where the broadcast product W y became a cuBLAS batched gemv over one
// 2x2 system per symbol and bin, plus some ninety small launches.
//
// Per frame f and data bin b, with H = chan[f, :, :, bins[b]] ([rx, tx]):
// W = (H^H H + I / snr)^-1 H^H; x = W y for y = fd[f, :, k, b] on every
// data symbol k; then each layer of each frame scaled to unit mean power
// over its KN x B phasors, 1 / sqrt(max(mean |x|^2, 1e-30)).  float32
// throughout, FFMA on the CUDA cores.
//
// What bounds it on the H100: bytes.  A symbol-bin reads 16 bytes of y and
// writes 16 of x for about 40 float32 operations, 1.25 FLOP/B, far below
// the card's ridge point; W costs about 80 operations a bin, once for KN
// symbols.
//
// Design.  The scale needs every phasor of the frame before the first one
// is written, and blocks run in no order, so there are two passes:
//   mimo_detect_power_kernel forms W in registers, streams y, and keeps
//     only each block's sums of |x0|^2 and |x1|^2 ([frames, 2, parts]);
//   mimo_detect_scale_kernel sums its frame's parts, forms W and x again,
//     and writes x scaled.
// Recomputing x costs a second read of y instead of a write and a read of
// an unscaled x: 3 x 16 bytes a symbol-bin against 4 x 16.  The second pass
// walks the blocks in the reverse order, so that its first blocks read the
// part of y that the first pass read last, some of which is still in the
// L2.  A thread owns one frame, one bin and kSym consecutive symbols:
// neighbouring threads read neighbouring bins, so a warp reads 256
// contiguous bytes of a row whatever B and the alignment of y, and each
// thread has 2 kSym loads in flight.  The symbols run across blocks along
// the grid, so that enough loads are in flight to fill the card whatever
// the number of frames.  (A form with two bins a thread, as 16-byte loads,
// would need B even and y on 16 bytes; this one serves every shape.)  The
// block sums and the parts' sum go in a fixed order and no atomics are
// used: a rerun is bit-identical.  The grid follows the shape, kSym
// symbols by kBlock bins a block; the wrapper (kernels/mimo_detect.py)
// allocates the parts for it and passes their count, which must be that
// grid's.

#include "common.cuh"

namespace {

constexpr int kSym = 4;          // data symbols a thread
constexpr int kBlock = 128;      // threads a block, along the bins
constexpr int kWarps = kBlock / 32;

struct Shape {
  int kn, nb, nfft, slices, bin_blocks;
  float inv_snr;
  Shape(int kn_, int nb_, int nfft_, float inv_snr_)
      : kn(kn_), nb(nb_), nfft(nfft_), slices((kn_ + kSym - 1) / kSym),
        bin_blocks((nb_ + kBlock - 1) / kBlock), inv_snr(inv_snr_) {}
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {  // conj(a) b
  return make_float2(a.x * b.x + a.y * b.y, a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 cscale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}

// W = (H^H H + I / snr)^-1 H^H of one bin, rows w[0] = (W00, W01) and
// w[1] = (W10, W11).  The Gram matrix G is Hermitian: G00 and G11 are
// real, G10 = conj(G01), and its determinant is real.
struct W2 {
  float2 w00, w01, w10, w11;
};

__device__ __forceinline__ W2 lmmse(const float2* __restrict__ chan_f,
                                    int nfft, long long bin, float inv_snr) {
  const float2 h00 = chan_f[0 * nfft + bin];    // [rx 0, tx 0]
  const float2 h01 = chan_f[1 * nfft + bin];    // [rx 0, tx 1]
  const float2 h10 = chan_f[2 * nfft + bin];    // [rx 1, tx 0]
  const float2 h11 = chan_f[3 * nfft + bin];    // [rx 1, tx 1]
  const float g00 = h00.x * h00.x + h00.y * h00.y +
                    (h10.x * h10.x + h10.y * h10.y) + inv_snr;
  const float g11 = h01.x * h01.x + h01.y * h01.y +
                    (h11.x * h11.x + h11.y * h11.y) + inv_snr;
  const float2 g01 = cadd(cmul_conj(h00, h01), cmul_conj(h10, h11));
  const float inv_det = 1.0f / (g00 * g11 - (g01.x * g01.x + g01.y * g01.y));
  // (G^-1 H^H)[i][j] with G^-1 = [[g11, -g01], [-conj(g01), g00]] / det and
  // (H^H)[k][j] = conj(H[j][k])
  const float2 c00 = make_float2(h00.x, -h00.y);
  const float2 c01 = make_float2(h10.x, -h10.y);
  const float2 c10 = make_float2(h01.x, -h01.y);
  const float2 c11 = make_float2(h11.x, -h11.y);
  const float2 ng01 = make_float2(-g01.x, -g01.y);
  const float2 ng10 = make_float2(-g01.x, g01.y);
  W2 w;
  w.w00 = cscale(cadd(cscale(c00, g11), cmul(ng01, c10)), inv_det);
  w.w01 = cscale(cadd(cscale(c01, g11), cmul(ng01, c11)), inv_det);
  w.w10 = cscale(cadd(cmul(ng10, c00), cscale(c10, g00)), inv_det);
  w.w11 = cscale(cadd(cmul(ng10, c01), cscale(c11, g00)), inv_det);
  return w;
}

// Where a block's threads lie: frame f, symbol slice s, bin block bx.  The
// blocks run frame-major; `reverse` walks them from the last.
struct Place {
  long long f;
  int k0, b0;
};

__device__ __forceinline__ Place place(const Shape& sh, bool reverse) {
  const long long blk = reverse ? (long long)gridDim.x - 1 - blockIdx.x
                                : (long long)blockIdx.x;
  const int bx = (int)(blk % sh.bin_blocks);
  const int s = (int)((blk / sh.bin_blocks) % sh.slices);
  return {blk / ((long long)sh.bin_blocks * sh.slices), s * kSym,
          bx * kBlock + (int)threadIdx.x};
}

__device__ __forceinline__ void detect(const W2& w, float2 y0, float2 y1,
                                       float2& x0, float2& x1) {
  x0 = cadd(cmul(w.w00, y0), cmul(w.w01, y1));
  x1 = cadd(cmul(w.w10, y0), cmul(w.w11, y1));
}

__global__ void __launch_bounds__(kBlock)
mimo_detect_power_kernel(const float2* __restrict__ fd,
                         const float2* __restrict__ chan,
                         const long long* __restrict__ bins, Shape sh,
                         float* __restrict__ partial) {
  const Place pl = place(sh, false);
  const long long plane = (long long)sh.kn * sh.nb;    // one antenna's
  float p0 = 0.f, p1 = 0.f;
  if (pl.b0 < sh.nb) {
    const W2 w = lmmse(chan + pl.f * 4 * sh.nfft, sh.nfft, bins[pl.b0],
                       sh.inv_snr);
    const float2* y = fd + pl.f * 2 * plane + pl.b0;
    float2 y0[kSym], y1[kSym];
#pragma unroll
    for (int i = 0; i < kSym; ++i) {
      const int k = pl.k0 + i;
      if (k < sh.kn) {
        y0[i] = y[(long long)k * sh.nb];
        y1[i] = y[plane + (long long)k * sh.nb];
      }
    }
#pragma unroll
    for (int i = 0; i < kSym; ++i) {
      if (pl.k0 + i < sh.kn) {
        float2 x0, x1;
        detect(w, y0[i], y1[i], x0, x1);
        p0 += x0.x * x0.x + x0.y * x0.y;
        p1 += x1.x * x1.x + x1.y * x1.y;
      }
    }
  }
  __shared__ float red[2][kWarps];
  p0 = lte::warp_sum(p0);
  p1 = lte::warp_sum(p1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = p0;
    red[1][warp] = p1;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += red[threadIdx.x][i];
    const int parts = sh.slices * sh.bin_blocks;
    const int part = (int)(blockIdx.x % parts);
    partial[(pl.f * 2 + threadIdx.x) * parts + part] = s;
  }
}

__global__ void __launch_bounds__(kBlock)
mimo_detect_scale_kernel(const float2* __restrict__ fd,
                         const float2* __restrict__ chan,
                         const long long* __restrict__ bins, Shape sh,
                         const float* __restrict__ partial,
                         float2* __restrict__ ph) {
  const Place pl = place(sh, true);
  const long long plane = (long long)sh.kn * sh.nb;
  __shared__ float scale[2];
  if (threadIdx.x < 32) {           // warp 0: the frame's two sums
    const int parts = sh.slices * sh.bin_blocks;
#pragma unroll
    for (int layer = 0; layer < 2; ++layer) {
      const float* p = partial + (pl.f * 2 + layer) * parts;
      float s = 0.f;
      for (int i = threadIdx.x; i < parts; i += 32) s += p[i];
      s = lte::warp_sum(s);
      if (threadIdx.x == 0)
        scale[layer] = 1.0f / sqrtf(fmaxf(s / (float)plane, 1e-30f));
    }
  }
  __syncthreads();
  if (pl.b0 >= sh.nb) return;
  const W2 w = lmmse(chan + pl.f * 4 * sh.nfft, sh.nfft, bins[pl.b0],
                     sh.inv_snr);
  const float s0 = scale[0], s1 = scale[1];
  const long long base = pl.f * 2 * plane + pl.b0;
  const float2* y = fd + base;
  float2* out = ph + base;
  float2 y0[kSym], y1[kSym];
#pragma unroll
  for (int i = 0; i < kSym; ++i) {
    const int k = pl.k0 + i;
    if (k < sh.kn) {
      y0[i] = y[(long long)k * sh.nb];
      y1[i] = y[plane + (long long)k * sh.nb];
    }
  }
#pragma unroll
  for (int i = 0; i < kSym; ++i) {
    const int k = pl.k0 + i;
    if (k >= sh.kn) break;
    float2 x0, x1;
    detect(w, y0[i], y1[i], x0, x1);
    out[(long long)k * sh.nb] = cscale(x0, s0);
    out[plane + (long long)k * sh.nb] = cscale(x1, s1);
  }
}

// The grid of the shape, frames x slices x bin blocks, or an error where
// the wrapper allocated another number of parts a frame.
int grid_of(int frames, int parts, const Shape& sh, dim3& grid) {
  const long long blocks =
      (long long)frames * sh.slices * (long long)sh.bin_blocks;
  if (frames < 1 || sh.kn < 1 || sh.nb < 1 || sh.nfft < 1 ||
      (long long)sh.slices * sh.bin_blocks != parts || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  grid = dim3((unsigned)blocks);
  return 0;
}

}  // namespace

extern "C" int mimo_detect_power(const void* fd, const void* chan,
                                 const void* bins, int frames, int kn, int nb,
                                 int nfft, int parts, float inv_snr,
                                 void* partial, void* stream) {
  const Shape sh(kn, nb, nfft, inv_snr);
  dim3 grid;
  if (int err = grid_of(frames, parts, sh, grid)) return err;
  mimo_detect_power_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const float2*)fd, (const float2*)chan, (const long long*)bins, sh,
      (float*)partial);
  return (int)cudaGetLastError();
}

extern "C" int mimo_detect_scale(const void* fd, const void* chan,
                                 const void* bins, int frames, int kn, int nb,
                                 int nfft, int parts, float inv_snr,
                                 const void* partial, void* ph,
                                 void* stream) {
  const Shape sh(kn, nb, nfft, inv_snr);
  dim3 grid;
  if (int err = grid_of(frames, parts, sh, grid)) return err;
  mimo_detect_scale_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const float2*)fd, (const float2*)chan, (const long long*)bins, sh,
      (const float*)partial, (float2*)ph);
  return (int)cudaGetLastError();
}
