// K4: fused sync search.
//
// Replaces the TPU kernel lte_gnu_radio_code_tpu/pallas_kernels/sync_search.py
// (sync_corr_abs, bodies _kernel and _kernel_packed): for frame b, every
// stride-spaced trial p < n_trials and every delay hypothesis d < D = cp+1,
//
//   out[b, p, d] = |sum_{m < klen} x[b, cp + p s + m] K_d[m]|
//                  * sqrt(L / max(power[b, p], 1e-30))
//
// where window l < m_synch of trial p is the nfft samples from
// m = l (nfft + cp), K_d[l (nfft + cp) + n] = sum_k e^{-2 pi i b_k (n - d) /
// nfft} conj(ZC[l L' + k]) over the L' synch bins b_k (zero between the
// windows), L = m_synch L', and power is the windows' energy on the synch
// bins, sum_l sum_k |X_l[b_k]|^2.  Samples past the frame are zero.
//
// The TPU kernel took the sum over m as a dense product, the form its
// matrix unit wanted.  Here the wrapper picks one of two kernels by a rule
// on the shape (kernels/sync_search.py:route); neither falls back to the
// other.
//
// FFT route (sync_search_fft; every strided search, LTE1024 and LTE2048).
// K_d is a circular shift by d of one length-nfft sequence, so a trial's
// whole row of D delays is the forward FFT of each window, a multiply by
// conj(ZC) on the synch bins, their sum over l, and one unscaled inverse
// FFT: 5 (m_synch + 1) nfft log2 nfft operations a trial where the product
// takes 8 D m_synch nfft (37 times fewer at LTE2048), and the power is the
// sum of |X_l[b_k]|^2 taken on the way.  What bounds it on the H100: the
// transforms' shared-memory traffic and barriers (fft.cuh); HBM sees x
// once, since neighbouring trials' windows overlap in L2, and out once.
// Design: as K1 and K2, a row of nfft / 4 threads (at most 256) per trial,
// 256 / that many trials a block, blocks walking the (frame, trial) pairs
// grid-stride.  A window arrives in the staging buffer by 8-byte cp.async
// (window starts are odd multiples of 8 bytes as often as even ones; samples
// past the frame are written as zeros), the first forward stage takes it to
// the work buffer, and the next window is queued while this one goes on.
// The multiply by the conj(ZC) table (indexed by bin, zero off the synch
// bins) runs in place; with m_synch > 1 the products add up in a third
// buffer.  The inverse runs in place and the first D outputs are scaled
// and stored.
//
// Direct route (sync_search_direct; the dense stride-1 search of GOLDEN64,
// and any shape the FFT route does not take, such as an nfft that is not a
// power of two).  With stride 1 the FFT form would transform a whole window
// for every new sample, so the product stays.  What bounds it: float32
// FFMA issue, 8 D klen operations a trial.  Design: a thread owns one trial
// (lanes take consecutive trials, so their x reads are conflict-free) and
// all 17 delays of the block's delay tile, 34 accumulators in registers:
// per tap it reads one sample and 9 broadcast 16-byte words of K for 68
// FFMA, where the first version of this kernel read 5 words for 16.  More
// trials a thread (2, 4) read fewer words per FFMA but ran slower: fewer
// warps were left to hide the reads' latency (PERF.md, K4).  D = 17 is
// one tile exactly (larger D take ceil(D / 17) tiles, in blockIdx.y in the
// surface form, at most 6 % of lanes idle from D = 33 on).  A block takes
// 256 trials of one frame: their span of x goes to shared memory once, K in
// stages of 64 taps (all of K in one stage at GOLDEN64).  The window sums
// that the power needs (energy, and the even and odd samples' sums, which
// give DC and Nyquist) are taken from the same x registers in the same
// pass, with the Parseval form power = sum_l (nfft E_l - |DC_l|^2 -
// |NY_l|^2), valid for the canonical all-but-DC-and-Nyquist synch bins (the
// wrapper checks).
// Results go through shared memory so that the stores are coalesced.
// Where the span of 256 trials would not fit in shared memory (a large
// stride), the block takes the trials that fit.
//
// Two output forms, a compile-time switch of both kernels (kPeaks).  The
// surface form writes out[b, p, d] as above.  The peaks form writes only
// what a caller whose next step is the per-trial reduction over the delays
// reads: peak[b, p] = max_d out[b, p, d] and delay[b, p] its first argmax
// (ties to the lowest delay, NaN above every number: torch's max(-1) and
// jnp.argmax).  Each value is the surface form's expression in the same
// order, so both are out.max(-1) bit for bit; the [B, trials, D] surface
// (665 MB at GOLDEN64 B 512) never reaches HBM.  Direct route: a thread
// holds its trial's D delays in registers and reduces them there, and a
// block walks every delay tile itself (one launch, no atomics) where D >
// 17; consecutive lanes hold consecutive trials, so the stores coalesce
// without the shared-memory staging.  D <= 17 has a kernel of its own
// (kOneTile): without the running max across tiles it needs no spills
// (ptxas, 80 registers), where the tile loop run at D = 17 spilled 56 bytes
// of stores (40 bytes of stack); the tile-loop kernel, taken only where
// D > 17, spills 184 bytes of stores (40 bytes of stack).  FFT route:
// each thread reduces its strided delays of y, then the row reduces the
// (value, index) pairs.
//
// Float32 throughout, no TF32, no fast-math; the twiddles are the float64-
// built table of kernels/fft.py.

#include <atomic>
#include <climits>
#include <cmath>

#include "common.cuh"
#include "fft.cuh"

namespace {

// |v| * scale: one delay's value, the same expression in both forms.
__device__ __forceinline__ float scaled_abs(float2 v, float scale) {
  return sqrtf(v.x * v.x + v.y * v.y) * scale;
}

// Whether (a, ia) comes before (b, ib) in the order max(-1) keeps: the
// larger value, NaN above every number, the lower index between equals.
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

// (v, i) <- the pair that beats every other of the T threads of the row.
// Rows of T > 32 threads are whole warps; their winners meet in redv, redi
// (kThreads / 32 entries each of shared memory).
template <int T>
__device__ __forceinline__ void row_argmax(float& v, int& i, float* redv,
                                           int* redi) {
  constexpr int W = T < 32 ? T : 32;
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  if constexpr (T > 32) {
    constexpr int RW = T / 32;                      // warps of the row
    const int warp = threadIdx.x / 32, first = warp / RW * RW;
    if (threadIdx.x % 32 == 0) {
      redv[warp] = v;
      redi[warp] = i;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < RW; ++w) {
      if (beats(redv[first + w], redi[first + w], v, i)) {
        v = redv[first + w];
        i = redi[first + w];
      }
    }
    __syncthreads();   // redv, redi free again
  }
}

// ---------------------------------------------------------------- FFT route

// zc: [m0, N] conj(ZC) by FFT bin, zero off the synch bins.  kBufs: 2, or 3
// where m0 > 1 (the sum over windows then has its own buffer).  kPeaks: out
// is peak [rows] and delay [rows] is written too, else out is [rows, cp+1].
template <int N, int kBufs, bool kPeaks>
__global__ void __launch_bounds__(lte::kThreads)
sync_search_fft_kernel(const float2* __restrict__ x, int n,
                       const float2* __restrict__ zc,
                       const float2* __restrict__ tw, float* __restrict__ out,
                       int* __restrict__ delay, int rows, int n_trials, int cp,
                       int stride, int m0, int rxb, float big_l) {
  using Rows = lte::fft::Rows<N>;
  constexpr int T = Rows::T, R = Rows::R;
  extern __shared__ float4 smem[];
  __shared__ float red[lte::kThreads / 32];
  __shared__ int redi[lte::kThreads / 32];
  const int t = threadIdx.x % T, slot = threadIdx.x / T;
  float2* c = reinterpret_cast<float2*>(smem) + slot * kBufs * N;  // staging
  float2* w = c + N;                                               // work
  float2* y = kBufs == 3 ? w + N : w;                              // sum
  const int groups = (rows + R - 1) / R, nd = cp + 1;

  // queue window l of the slot's row in group g into c
  auto fetch = [&](int g, int l) {
    const int r = g * R + slot, b = r / n_trials, p = r - b * n_trials;
    const long start = cp + (long)p * stride + (long)l * rxb;
    const float2* xb = x + (long)b * n + start;
    const long left = r < rows ? (long)n - start : 0;   // samples in frame
    for (int i = t; i < N; i += T) {
      if (i < left)
        lte::fft::copy8_async(c + i, xb + i);
      else
        c[i] = make_float2(0.f, 0.f);
    }
  };

  int g = blockIdx.x;
  if (g < groups) fetch(g, 0);
  for (; g < groups; g += gridDim.x) {
    const int r = g * R + slot, next = g + gridDim.x;
    float pw[1] = {0.f};
    for (int l = 0; l < m0; ++l) {
      lte::fft::copy_wait();
      lte::fft::row_sync<T>();   // window landed; last row's y all read
      auto fetch_next = [&] {
        if (l + 1 < m0)
          fetch(g, l + 1);
        else if (next < groups)
          fetch(next, 0);
      };
      lte::fft::transform<N, T, false>(c, w, tw, t, 1.f, fetch_next);
      const float2* z = zc + l * N;
      for (int i = t; i < N; i += T) {
        const float2 v = w[i], q = __ldg(z + i);
        if (q.x != 0.f || q.y != 0.f) pw[0] += v.x * v.x + v.y * v.y;
        const float2 u = lte::fft::cmul(v, q);
        y[i] = (kBufs == 3 && l > 0) ? lte::fft::cadd(y[i], u) : u;
      }
    }
    lte::fft::row_sum<T>(pw, red);
    lte::fft::row_sync<T>();     // y written by the whole row
    lte::fft::transform<N, T, true>(y, y, tw, t, 1.f, [] {});
    const float scale = sqrtf(big_l / fmaxf(pw[0], 1e-30f));
    if constexpr (kPeaks) {   // every row reduces: row_argmax may sync
      float best = -INFINITY;
      int at = INT_MAX;
      for (int d = t; d < nd; d += T) {
        const float v = scaled_abs(y[d], scale);
        if (beats(v, d, best, at)) {
          best = v;
          at = d;
        }
      }
      row_argmax<T>(best, at, red, redi);
      if (t == 0 && r < rows) {
        out[r] = best;
        delay[r] = at;
      }
    } else if (r < rows) {
      float* o = out + (long)r * nd;
      for (int d = t; d < nd; d += T) o[d] = scaled_abs(y[d], scale);
    }
  }
}

// ------------------------------------------------------------- direct route

constexpr int kDt = 17;              // delays a thread, and a block, takes
constexpr int kDp = 18;              // a tap's row of K in shared memory
constexpr int kKc = 64;              // taps of K a stage (even)
constexpr int kSmemMax = 200 << 10;  // bytes a block may ask for
constexpr int kMinBlocks = 3;        // blocks an SM it is compiled for
constexpr int kUnroll = 8;           // pairs of taps unrolled in its loop

__host__ __device__ constexpr int direct_span(int tile, int stride, int m0,
                                              int rxb, int nfft) {
  return (tile - 1) * stride + (m0 - 1) * rxb + nfft;
}

__host__ __device__ constexpr int even_up(int v) { return (v + 1) & ~1; }

// Shared memory of a block of `tile` trials: the span of x and a stage of
// K, then (in the same bytes) the tile of results.
inline long direct_smem(int tile, int stride, int m0, int rxb, int nfft) {
  const long taps =
      ((long)even_up(direct_span(tile, stride, m0, rxb, nfft)) +
       kKc * kDp) * (long)sizeof(float2);
  const long res = (long)tile * kDt * (long)sizeof(float);
  return taps > res ? taps : res;
}

// Trials a block takes: 256, or as many as have their span in shared
// memory; 0 where one trial's taps alone do not fit (or nfft is odd).
inline int direct_tile(int stride, int nfft, int m0, int rxb) {
  if (nfft % 2) return 0;
  int tile = lte::kThreads;
  while (tile > 1 && direct_smem(tile, stride, m0, rxb, nfft) > kSmemMax)
    tile /= 2;
  return direct_smem(tile, stride, m0, rxb, nfft) > kSmemMax ? 0 : tile;
}

// kt: [klen, nd] K_d[m], tap-major.  Block (trial tile, delay tile, frame)
// in the surface form, (trial tile, 1, frame) in the peaks form, which walks
// the delay tiles itself; thread tid owns trial tid of the tile.  80
// registers: three blocks an SM.  kOneTile (peaks form, nd <= kDt): no
// running max outlives the sums, which keeps that kernel free of spills.
template <bool kPeaks, bool kOneTile>
__global__ void __launch_bounds__(lte::kThreads, kMinBlocks)
sync_search_direct_kernel(const float2* __restrict__ x, int n,
                          const float2* __restrict__ kt, int nd,
                          float* __restrict__ out, int* __restrict__ delay,
                          int n_trials, int tile, int cp, int stride, int nfft,
                          int m0, int rxb, float big_l) {
  extern __shared__ float4 smem[];
  const int span = direct_span(tile, stride, m0, rxb, nfft);
  float2* xs = reinterpret_cast<float2*>(smem);          // [span]
  float2* ks = xs + even_up(span);                       // [kKc][kDp]

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * tile, b = blockIdx.z;
  const float2* xb = x + (long)b * n;
  const long base = cp + (long)p0 * stride;
  for (int i = tid; i < span; i += lte::kThreads) {
    const long j = base + i;
    xs[i] = j < n ? xb[j] : make_float2(0.f, 0.f);
  }

  const float2* xt = xs + (tid < tile ? tid : 0) * stride;   // the trial
  float2 acc[kDt];
  // the sums of delay tile d0 (delays d0 + j) into acc; returns the scale
  auto tile_sums = [&](int d0) {
#pragma unroll
    for (int j = 0; j < kDt; ++j) acc[j] = make_float2(0.f, 0.f);
    float pw = 0.f;
    for (int l = 0; l < m0; ++l) {
      float e = 0.f;                                 // window energy
      float2 se = make_float2(0.f, 0.f), so = se;    // even and odd samples
      for (int n0 = 0; n0 < nfft; n0 += kKc) {
        const int kmax = min(kKc, nfft - n0), m = l * rxb + n0;
        __syncthreads();             // xs loaded; previous stage consumed
        for (int i = tid; i < kmax * kDt; i += lte::kThreads) {
          const int kk = i / kDt, dd = i - kk * kDt, gd = d0 + dd;
          ks[kk * kDp + dd] = gd < nd ? __ldg(kt + (long)(m + kk) * nd + gd)
                                      : make_float2(0.f, 0.f);
        }
        __syncthreads();
        // one tap: a sample and 9 words of K for 68 FFMA
        auto tap = [&](int kk, float2& s) {
          const float4* k4 = reinterpret_cast<const float4*>(ks + kk * kDp);
          float4 kv[kDp / 2];
#pragma unroll
          for (int j = 0; j < kDp / 2; ++j) kv[j] = k4[j];
          const float2 xv = xt[m + kk];
          e = fmaf(xv.x, xv.x, fmaf(xv.y, xv.y, e));
          s.x += xv.x;
          s.y += xv.y;
#pragma unroll
          for (int j = 0; j < kDt; ++j) {
            const float kr = (j & 1) ? kv[j / 2].z : kv[j / 2].x;
            const float ki = (j & 1) ? kv[j / 2].w : kv[j / 2].y;
            acc[j].x = fmaf(xv.x, kr, fmaf(-xv.y, ki, acc[j].x));
            acc[j].y = fmaf(xv.x, ki, fmaf(xv.y, kr, acc[j].y));
          }
        };
#pragma unroll kUnroll
        for (int kk = 0; kk < kmax; kk += 2) {   // nfft and kKc are even
          tap(kk, se);
          tap(kk + 1, so);
        }
      }
      const float dcr = se.x + so.x, dci = se.y + so.y;
      const float nyr = se.x - so.x, nyi = se.y - so.y;
      pw += (float)nfft * e - (dcr * dcr + dci * dci) -
            (nyr * nyr + nyi * nyi);
    }
    return sqrtf(big_l / fmaxf(pw, 1e-30f));
  };

  if constexpr (kPeaks) {
    float best = -INFINITY;          // the running max and its delay
    int at = INT_MAX;
    auto reduce = [&](int d0, float scale) {
      const int dn = min(kDt, nd - d0);
#pragma unroll
      for (int j = 0; j < kDt; ++j) {
        const float v = scaled_abs(acc[j], scale);
        if (j < dn && beats(v, d0 + j, best, at)) {
          best = v;
          at = d0 + j;
        }
      }
    };
    if constexpr (kOneTile) {
      reduce(0, tile_sums(0));
    } else {
      for (int d0 = 0; d0 < nd; d0 += kDt) reduce(d0, tile_sums(d0));
    }
    if (tid < tile && p0 + tid < n_trials) {   // lanes: consecutive trials
      out[(long)b * n_trials + p0 + tid] = best;
      delay[(long)b * n_trials + p0 + tid] = at;
    }
  } else {
    const int d0 = blockIdx.y * kDt;
    const float scale = tile_sums(d0);
    float* os = reinterpret_cast<float*>(smem);          // [tile][kDt]
    __syncthreads();                 // xs and ks consumed: os takes over
    if (tid < tile) {
#pragma unroll
      for (int j = 0; j < kDt; ++j)
        os[tid * kDt + j] = scaled_abs(acc[j], scale);
    }
    __syncthreads();
    const int np = min(tile, n_trials - p0), dn = min(kDt, nd - d0);
    float* o = out + ((long)b * n_trials + p0) * nd + d0;
    if (dn == nd && nd == kDt) {     // whole rows: the tile is contiguous
      for (int i = tid; i < np * kDt; i += lte::kThreads) o[i] = os[i];
    } else {
      for (int i = tid; i < np * dn; i += lte::kThreads) {
        const int pl = i / dn, d = i - pl * dn;
        o[(long)pl * nd + d] = os[pl * kDt + d];
      }
    }
  }
}

// The direct kernel of form (kPeaks, kOneTile) over the grid of its form
// (module note); the shared-memory opt-in is made at its first launch on a
// device.
template <bool kPeaks, bool kOneTile>
int direct_launch(const float2* x, int batch, int n, const float2* kt, int nd,
                  float* out, int* delay, int n_trials, int tile, long smem,
                  int cp, int stride, int nfft, int m0, int rxb, float big_l,
                  cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> opted[kMaxDevices];   // shared-memory opt-in done
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted[dev].load()) {
    err = cudaFuncSetAttribute(sync_search_direct_kernel<kPeaks, kOneTile>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
    if (err != cudaSuccess) return (int)err;
    opted[dev].store(true);
  }
  const dim3 grid((n_trials + tile - 1) / tile,
                  kPeaks ? 1 : (nd + kDt - 1) / kDt, batch);
  sync_search_direct_kernel<kPeaks, kOneTile>
      <<<grid, lte::kThreads, smem, stream>>>(x, n, kt, nd, out, delay,
                                              n_trials, tile, cp, stride, nfft,
                                              m0, rxb, big_l);
  return (int)cudaGetLastError();
}

}  // namespace

// x [batch, n] complex64; zc: [m0, nfft] conj(ZC) by FFT bin, zero off the
// synch bins; tw: fft.cuh's table for nfft (a power of two in [16, 4096],
// cp < nfft).  delay null: out [batch, n_trials, cp + 1] float32 (the
// surface form); else out [batch, n_trials] float32 the peak and delay
// [batch, n_trials] int32 its delay (the peaks form).
extern "C" int sync_search_fft(const void* x, int batch, int n, const void* zc,
                               const void* tw, void* out, int n_trials, int cp,
                               int stride, int nfft, int m0, int rxb,
                               float big_l, void* delay, void* stream) {
  if (cp >= nfft) return (int)cudaErrorInvalidValue;
  const int rows = batch * n_trials;
  return lte::fft::dispatch(nfft, [&](auto nn) {
    constexpr int N = decltype(nn)::value;
    auto go = [&](auto bufs, auto peaks) {
      constexpr int kBufs = decltype(bufs)::value;
      constexpr bool kPeaks = decltype(peaks)::value;
      return lte::fft::launch<N, sync_search_fft_kernel<N, kBufs, kPeaks>,
                              kBufs>(
          rows, (cudaStream_t)stream, (const float2*)x, n, (const float2*)zc,
          (const float2*)tw, (float*)out, (int*)delay, rows, n_trials, cp,
          stride, m0, rxb, big_l);
    };
    auto form = [&](auto bufs) {
      return delay ? go(bufs, std::true_type{}) : go(bufs, std::false_type{});
    };
    return m0 > 1 ? form(std::integral_constant<int, 3>{})
                  : form(std::integral_constant<int, 2>{});
  });
}

// 1 where the direct kernel takes this shape (one trial's taps fit in a
// block's shared memory and nfft is even), else 0.  The wrapper asks before
// it builds the table of K.
extern "C" int sync_search_direct_fits(int stride, int nfft, int m0, int rxb) {
  return direct_tile(stride, nfft, m0, rxb) > 0;
}

// x [batch, n] complex64; kt [klen, nd] complex64 K_d[m], tap-major.  delay
// null: out [batch, n_trials, nd] float32 (the surface form); else out
// [batch, n_trials] float32 the peak and delay [batch, n_trials] int32 its
// delay (the peaks form).  cudaErrorInvalidValue where
// sync_search_direct_fits gives 0.
extern "C" int sync_search_direct(const void* x, int batch, int n,
                                  const void* kt, int nd, void* out,
                                  int n_trials, int cp, int stride, int nfft,
                                  int m0, int rxb, float big_l, void* delay,
                                  void* stream) {
  const int tile = direct_tile(stride, nfft, m0, rxb);
  if (tile == 0) return (int)cudaErrorInvalidValue;
  const long smem = direct_smem(tile, stride, m0, rxb, nfft);
  auto go = [&](auto peaks, auto one_tile) {
    return direct_launch<decltype(peaks)::value, decltype(one_tile)::value>(
        (const float2*)x, batch, n, (const float2*)kt, nd, (float*)out,
        (int*)delay, n_trials, tile, smem, cp, stride, nfft, m0, rxb, big_l,
        (cudaStream_t)stream);
  };
  if (!delay) return go(std::false_type{}, std::false_type{});
  return nd <= kDt ? go(std::true_type{}, std::true_type{})
                   : go(std::true_type{}, std::false_type{});
}
