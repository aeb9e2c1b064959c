// Block-level complex FFT of rows in shared memory, shared by K1
// (ofdm_mod.cu), K2 (equalize.cu) and K4's FFT route (sync_search.cu).
//
// Stockham autosort: the result comes out in natural order with no bit
// reversal.  Radix 4 throughout, with one radix-2 stage last where log2(N)
// is odd; kernels/fft.py:plan lists the same radices, and
// tests/test_torch_fft_plan.py runs these stages in numpy against np.fft.
//
// A stage of radix R after sub-transforms of length P (P = 1 first, times
// R after each stage): butterfly i < N/R reads x[i + j N/R], j < R,
// multiplies the j-th by w^(j k), k = i mod P, w = e^(-2 pi i / (P R)),
// takes the R-point DFT and writes output j to y[(i - k) R + k + j P].
// w^(j k) is entry j k N / (P R) of the table e^(-2 pi i m / N), m < N,
// that the wrapper builds in float64 (kernels/fft.py:twiddles).  The
// inverse conjugates the twiddles and the butterfly's +-i (unscaled).
// Reads are contiguous across a row's threads; the writes of the P = 1 and
// P = 4 stages are not, and each thread rotates the order of its four
// stores so that a half-warp's stores still spread over all banks.
//
// A row has T = min(N / 4, 256) threads; a 256-thread block holds 256 / T
// rows, each with two buffers: the row arrives in the staging buffer, the
// first stage takes it to the work buffer, and the other stages run in
// place there (each thread holds its butterflies' outputs in registers
// until the row's threads have read their inputs).  So the staging buffer
// is free after the first stage, and the block queues its next row into it
// with cp.async while this row's transform, norm and store go on: blocks
// walk the rows grid-stride, one row in flight and one in work.  Where a
// row fits in one warp (N <= 128) its stages sync that warp only.

#pragma once

#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace lte {
namespace fft {

constexpr int kMinN = 16, kMaxN = 4096;

template <int N>
struct Rows {
  static_assert(N >= kMinN && N <= kMaxN && (N & (N - 1)) == 0,
                "N: a power of two in [16, 4096]");
  static constexpr int T = N / 4 < kThreads ? N / 4 : kThreads;  // per row
  static constexpr int R = kThreads / T;                          // per block
  static constexpr int smem = 2 * R * N * (int)sizeof(float2);    // bytes
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// Barrier among the T threads of a row (and everything they wrote).
template <int T>
__device__ __forceinline__ void row_sync() {
  if constexpr (T <= 32) __syncwarp(); else __syncthreads();
}

// v[q] <- its sum over the T threads of the row, for every q < V.  Rows of
// T > 32 threads are whole warps; their partial sums meet in red
// (V * kThreads / 32 floats of shared memory).
template <int T, int V>
__device__ __forceinline__ void row_sum(float (&v)[V], float* red) {
  constexpr int W = T < 32 ? T : 32;
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
#pragma unroll
    for (int q = 0; q < V; ++q) v[q] += __shfl_xor_sync(0xffffffffu, v[q], o);
  if constexpr (T > 32) {
    constexpr int NW = kThreads / 32, RW = T / 32;   // warps: block, row
    const int warp = threadIdx.x / 32, first = warp / RW * RW;
    if (threadIdx.x % 32 == 0)
#pragma unroll
      for (int q = 0; q < V; ++q) red[q * NW + warp] = v[q];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < V; ++q) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < RW; ++w) s += red[q * NW + first + w];
      v[q] = s;
    }
    __syncthreads();   // red is free again
  }
}

// One Stockham stage, src -> dst (dst may be src), for thread t < T of the
// row; the inputs are scaled by pre.  Returns synced.
template <int N, int T, int R, int P, bool kInv>
__device__ __forceinline__ void stage(const float2* src, float2* dst,
                                      const float2* __restrict__ tw, int t,
                                      float pre) {
  constexpr int M = N / R;            // butterflies
  constexpr int U = M / T;            // butterflies per thread
  constexpr int STEP = N / (P * R);   // table entries per unit of j k
  static_assert(M % T == 0, "whole butterflies per thread");
  float2 y[U][R];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = t + u * T, k = i & (P - 1);
    float2 x[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      x[j] = src[i + j * M];
      x[j].x *= pre;
      x[j].y *= pre;
    }
    if constexpr (P > 1) {
#pragma unroll
      for (int j = 1; j < R; ++j) {
        float2 w = __ldg(tw + j * k * STEP);
        if constexpr (kInv) w.y = -w.y;
        x[j] = cmul(x[j], w);
      }
    }
    if constexpr (R == 2) {
      y[u][0] = cadd(x[0], x[1]);
      y[u][1] = csub(x[0], x[1]);
    } else {
      const float2 a0 = cadd(x[0], x[2]), a1 = csub(x[0], x[2]);
      const float2 a2 = cadd(x[1], x[3]), a3 = csub(x[1], x[3]);
      // -i a3 forward, +i a3 inverse
      const float2 b = kInv ? make_float2(-a3.y, a3.x)
                            : make_float2(a3.y, -a3.x);
      y[u][0] = cadd(a0, a2);
      y[u][1] = cadd(a1, b);
      y[u][2] = csub(a0, a2);
      y[u][3] = csub(a1, b);
    }
  }
  if (src == dst) row_sync<T>();      // every input read before any write
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = t + u * T, k = i & (P - 1), o = (i - k) * R + k;
    if constexpr (R == 4 && P <= 4) {
      // Output j of butterfly i lands at 4 i + j (P = 1) or 16 (i / 4) +
      // i % 4 + 4 j (P = 4): for one j the 16 threads of a half-warp hit 4
      // of the 16 eight-byte bank pairs, a 4-way conflict.  Thread i stores
      // its outputs in the order j = (jj + i / 4) % 4 instead, which
      // spreads each store over all 16.
      const int r = (i >> 2) & 3;
      float2 a[R], b[R];
#pragma unroll
      for (int jj = 0; jj < R; ++jj)
        a[jj] = (r & 1) ? y[u][(jj + 1) & 3] : y[u][jj];
#pragma unroll
      for (int jj = 0; jj < R; ++jj) b[jj] = (r & 2) ? a[(jj + 2) & 3] : a[jj];
#pragma unroll
      for (int jj = 0; jj < R; ++jj) dst[o + ((jj + r) & 3) * P] = b[jj];
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) dst[o + j * P] = y[u][j];
    }
  }
  row_sync<T>();
}

// The in-place stages from sub-transform length P on, the row in w.
template <int N, int T, int P, bool kInv>
__device__ __forceinline__ void rest(float2* w, const float2* __restrict__ tw,
                                     int t) {
  if constexpr (P < N) {
    constexpr int R = N / P >= 4 ? 4 : 2;
    stage<N, T, R, P, kInv>(w, w, tw, t, 1.f);
    rest<N, T, P * R, kInv>(w, tw, t);
  }
}

// The transform of the row in c (synced) into w, its inputs scaled by pre;
// calls between() once c is free again (after the first stage).
template <int N, int T, bool kInv, class Between>
__device__ __forceinline__ void transform(const float2* c, float2* w,
                                          const float2* __restrict__ tw,
                                          int t, float pre, Between between) {
  stage<N, T, 4, 1, kInv>(c, w, tw, t, pre);   // N >= 16: radix 4 first
  between();
  rest<N, T, 4, kInv>(w, tw, t);
}

// 16 bytes global -> shared without registers, completed by copy_wait.
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}

// 8 bytes (one complex64) the same way, for rows that start on any sample.
__device__ __forceinline__ void copy8_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src) : "memory");
}

// Wait for this thread's cp.async copies (sync the row after it).
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Queue row r of src [rows, N] into c with cp.async, 16 bytes a thread;
// zeros where r is past the last row.
template <int N, int T>
__device__ __forceinline__ void fetch_row(float2* c, const float2* src,
                                          int r, int rows, int t) {
  for (int q = t; q < N / 2; q += T) {
    if (r < rows)
      copy16_async(c + 2 * q, src + (long)r * N + 2 * q);
    else
      reinterpret_cast<float4*>(c)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// f(std::integral_constant<int, N>{}) for N == nfft, a power of two in
// [16, 4096]; cudaErrorInvalidValue for any other nfft.
template <class F>
int dispatch(int nfft, F&& f) {
  switch (nfft) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    case 512: return f(std::integral_constant<int, 512>{});
    case 1024: return f(std::integral_constant<int, 1024>{});
    case 2048: return f(std::integral_constant<int, 2048>{});
    case 4096: return f(std::integral_constant<int, 4096>{});
  }
  return (int)cudaErrorInvalidValue;
}

// Launch Kern over `rows` rows with kBufs buffers of shared memory a row
// (Rows<N>'s two, or more): as many blocks as fit on the card at once, or
// one per group of R rows if fewer.  The shared-memory opt-in and the count
// of resident blocks are set up at Kern's first launch on a device; later
// launches are the <<<>>> call.
template <int N, auto Kern, int kBufs = 2, class... Args>
int launch(int rows, cudaStream_t stream, Args... args) {
  constexpr int smem = Rows<N>::smem / 2 * kBufs, kMaxDevices = 64;
  static std::atomic<int> resident[kMaxDevices];   // 0: not set up yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int blocks = resident[dev].load();
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(
        Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kern,
                                                          kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    blocks = sms * per_sm;
    resident[dev].store(blocks);
  }
  const int groups = (rows + Rows<N>::R - 1) / Rows<N>::R;
  const dim3 grid(groups < blocks ? groups : blocks);
  Kern<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace fft
}  // namespace lte
