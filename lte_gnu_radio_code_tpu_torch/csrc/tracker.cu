// The tracker's step loop, one persistent block a stream.
//
// No Pallas kernel stands behind this one: the JAX package runs the step of
// lte_gnu_radio_code_tpu/models/tracker.py (make_tracker_step) in one
// lax.scan (models/tracker.py:217, runtime/stream.py:503), which XLA
// compiles into one loop on the device.  Written out in torch the step is
// some 60-90 small kernels, and every step depends on the one before.
//
// What bounds it on the H100: latency.  A step reads m_synch windows of
// nfft samples at a pointer that the step before decided, so nothing of the
// next step can start before this one's state update; the bytes (a window
// of 512 bytes at GOLDEN64, mostly from L1 / L2 since neighbouring windows
// overlap) and the operations (one 64-point FFT, 62 x 17 complex products)
// are tiny.  Design: one block of 256 threads a stream runs every step:
//   1. thread 0 turns the carry (in registers) into this step's pointer;
//   2. the block gathers the m_synch windows (clamped to the buffer, as the
//      JAX gather is) into shared memory and transforms them with fft.cuh,
//      the same in-block FFT as K2, and keeps the synch bins;
//   3. the power normalisation, then one warp a delay forms
//      |sum_l sd_l conj(zc_l) P[d, l]| for the cp + 1 delays;
//   4. thread 0 takes the max and the first-index argmax, runs the state
//      machine and, where a detection is accepted with more than three
//      before it, the closed-form least-squares drift fit;
//   5. every thread writes its bins of the step's channel row (zero unless
//      accepted).
// The step's outputs (accept, pointer, delay, peak, channel row) are the
// scan's.  The carry, x_start and fire_limit are read from and written to
// device memory, so a chunk step of the streaming receiver needs nothing
// from the host.
//
// The pointer prediction ceil(b0 + b1 x - cp/4) is an integer with no drift,
// so float noise in b flips it by one.  The fit and the prediction round as
// the plain step (models/tracker.py:_masked_lstsq) and the JAX package's
// CPU build do: sums in the order ((((v0 + v1) + v2) + v3) + v4), and a
// product contracted into the addition after it, in the sums of products
// too (XLA's CPU backend fuses those), written out as __fadd_rn /
// __fmul_rn / __fmaf_rn / __fdiv_rn so that nvcc contracts nothing else.
//
// nfft is a power of two in [16, 4096] and m_synch >= 1, with the rows, the
// synch spectrum and the correlations in one block's shared memory; the
// wrapper (kernels/tracker.py) refuses any other shape.

#include "common.cuh"
#include "fft.cuh"

namespace {

constexpr int kHist = 5;       // least-squares history entries

struct Carry {                 // the nine leaves, one row a stream
  int* loop_count;
  int* corr_obs;
  int* ptr_frame;
  int* ptr_adj;
  int* sym_count;
  int* last_ptr;
  float* hx;                   // [B, 5]
  float* hy;                   // [B, 5]
  float* b;                    // [B, 2]
};

struct Params {
  const float2* x;             // [B, n]
  long n;
  const int* x_start;          // [B] global index of x[s, 0]
  const int* fire_limit;       // [B] global limit of a window's end
  Carry in, out;
  int steps;
  const int* bins;             // [nsb] synch bins, wrapped
  const int* bin_slot;         // [nfft] index among the synch bins, or -1
  const float2* zc_conj;       // [L]
  const float2* p_t;           // [cp + 1, L] delay matrix, transposed
  const float2* tw;            // fft.cuh twiddles
  unsigned char* accept;       // [B, steps]
  int* ptr;                    // [B, steps]
  int* delay;                  // [B, steps]
  float* peak;                 // [B, steps]
  float2* h_row;               // [B, steps, nfft]
  int cp, m0, nsb, pattern, stride;
  float gate;                  // 0.5 L
  float denom;                 // 1 + 1 / snr
};

__device__ __forceinline__ float fsum5(const float (&v)[kHist]) {
  float s = v[0];
#pragma unroll
  for (int i = 1; i < kHist; ++i) s = __fadd_rn(s, v[i]);
  return s;
}

// sum_i a_i b_i, each product contracted into the running sum.
__device__ __forceinline__ float fdot5(const float (&a)[kHist],
                                       const float (&b)[kHist]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kHist; ++i) s = __fmaf_rn(a[i], b[i], s);
  return s;
}

// b = argmin sum_i w_i (b0 + b1 x_i - y_i)^2, w_i = (i < n_eff), in the
// plain step's order and rounding.
__device__ void masked_lstsq(const float (&hx)[kHist], const float (&hy)[kHist],
                             int n_eff, float& b0, float& b1) {
  float w[kHist], v1[kHist], vy[kHist];
#pragma unroll
  for (int i = 0; i < kHist; ++i) {
    w[i] = i < n_eff ? 1.f : 0.f;
    v1[i] = __fmul_rn(w[i], hx[i]);
    vy[i] = __fmul_rn(w[i], hy[i]);
  }
  const float s0 = fsum5(w), s1 = fsum5(v1), s2 = fdot5(v1, hx),
              sy = fsum5(vy), sxy = fdot5(v1, hy);
  const float det = __fmaf_rn(s0, s2, -__fmul_rn(s1, s1));
  const bool safe = fabsf(det) > 1e-9f;
  b1 = safe ? __fdiv_rn(__fmaf_rn(s0, sxy, -__fmul_rn(s1, sy)), det) : 0.f;
  b0 = s0 > 0.f ? __fdiv_rn(__fmaf_rn(-b1, s1, sy), fmaxf(s0, 1.f)) : 0.f;
}

template <int N>
__global__ void __launch_bounds__(lte::kThreads)
tracker_scan_kernel(const Params p) {
  using Rows = lte::fft::Rows<N>;
  constexpr int T = Rows::T, R = Rows::R;
  constexpr int kWarps = lte::kThreads / 32;
  extern __shared__ float4 smem[];
  __shared__ float red[kWarps];
  __shared__ int s_local, s_accept, s_col;
  __shared__ float s_scale;

  const int s = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int t = tid % T, slot = tid / T;
  const int cp = p.cp, m0 = p.m0, nsb = p.nsb, L = m0 * nsb, D = cp + 1;
  const int rx_b_len = N + cp;
  float2* rows = reinterpret_cast<float2*>(smem);
  float2* sd = rows + 2 * R * N;                        // [L]
  float* dd = reinterpret_cast<float*>(sd + ((L + 1) / 2) * 2);   // [D]
  float2* c = rows + slot * 2 * N;                      // staging
  float2* w = c + N;                                    // work
  const float2* x = p.x + (long)s * p.n;

  // the carry, held by thread 0
  int lc = 0, co = 0, pf = 0, pa = 0, sc = 0, lp = 0, xs = 0, fl = 0;
  float hx[kHist], hy[kHist], b0 = 0.f, b1 = 0.f;
  int ptr = 0;
  bool fire = false;
  if (tid == 0) {
    lc = p.in.loop_count[s];
    co = p.in.corr_obs[s];
    pf = p.in.ptr_frame[s];
    pa = p.in.ptr_adj[s];
    sc = p.in.sym_count[s];
    lp = p.in.last_ptr[s];
#pragma unroll
    for (int i = 0; i < kHist; ++i) {
      hx[i] = p.in.hx[s * kHist + i];
      hy[i] = p.in.hy[s * kHist + i];
    }
    b0 = p.in.b[2 * s];
    b1 = p.in.b[2 * s + 1];
    xs = p.x_start[s];
    fl = p.fire_limit[s];
  }

  for (int step = 0; step < p.steps; ++step) {
    // 1. this step's pointer
    if (tid == 0) {
      const float xh = (float)(sc * p.pattern);
      const int pred =
          (int)ceilf(__fsub_rn(__fmaf_rn(b1, xh, b0), 0.25f * cp));
      ptr = co == -1 ? lc * p.stride + (cp - 5) + pa
                     : (co < 5 ? pf + p.pattern * rx_b_len : pred);
      fire = (m0 - 1) * rx_b_len + N + ptr < fl && ptr >= xs;
      s_local = fire ? ptr - xs : 0;
    }
    __syncthreads();

    // 2. the synch windows' spectra on the synch bins
    const long local = s_local;
    for (int g = 0; g < m0; g += R) {
      const int m = g + slot;
      if (m < m0) {
        const long base = local + (long)m * rx_b_len;
        for (int q = t; q < N; q += T) {
          long i = base + q;
          i = i < 0 ? 0 : (i >= p.n ? p.n - 1 : i);
          c[q] = x[i];
        }
      } else {
        for (int q = t; q < N; q += T) c[q] = make_float2(0.f, 0.f);
      }
      __syncthreads();
      lte::fft::transform<N, T, false>(c, w, p.tw, t, 1.f, [] {});
      if (m < m0)
        for (int q = t; q < nsb; q += T) sd[m * nsb + q] = w[__ldg(p.bins + q)];
      __syncthreads();
    }

    // 3. power normalisation, then |correlation| at each delay
    float pw = 0.f;
    for (int l = tid; l < L; l += lte::kThreads)
      pw += sd[l].x * sd[l].x + sd[l].y * sd[l].y;
    pw = lte::warp_sum(pw);
    if (lane == 0) red[warp] = pw;
    __syncthreads();
    if (tid == 0) {
      float tot = 0.f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) tot += red[i];
      s_scale = sqrtf(fmaxf(tot / L, 1e-30f));
    }
    __syncthreads();
    const float scale = s_scale;
    for (int l = tid; l < L; l += lte::kThreads)
      sd[l] = make_float2(sd[l].x / scale, sd[l].y / scale);
    __syncthreads();
    for (int d = warp; d < D; d += kWarps) {
      const float2* pd = p.p_t + (long)d * L;
      float re = 0.f, im = 0.f;
      for (int l = lane; l < L; l += 32) {
        const float2 q = lte::fft::cmul(sd[l], __ldg(p.zc_conj + l));
        const float2 v = __ldg(pd + l);
        re += q.x * v.x - q.y * v.y;
        im += q.x * v.y + q.y * v.x;
      }
      re = lte::warp_sum(re);
      im = lte::warp_sum(im);
      if (lane == 0) dd[d] = hypotf(re, im);
    }
    __syncthreads();

    // 4. the decision and the state machine
    if (tid == 0) {
      float dmax = dd[0];
      int arg = 0;
      for (int d = 1; d < D; ++d)
        if (dd[d] > dmax) {
          dmax = dd[d];
          arg = d;
        }
      const int dind = arg - 1;
      const bool enter = fire && (dmax > p.gate || co > -1);
      const bool need_adj = enter && dind > (int)ceilf(0.75f * cp);
      const int adj = (cp + 1) / 2;
      const int pa1 = need_adj && co == 0 ? pa + adj : pa;
      if (need_adj && co == 0)
        ptr = lc * p.stride + (cp - 5) + pa1;
      else if (need_adj && co > 0 && co < 5)
        ptr += adj;
      const int refr = co == 0 ? 0 : lp;
      const bool acc = enter && (ptr - refr > 2 * cp + N || co == -1);
      const int co1 = acc ? co + 1 : co;
      if (acc) {
        const int k = sc % kHist;
#pragma unroll
        for (int i = 0; i < kHist; ++i)
          if (i == k) {
            hx[i] = (float)(sc * p.pattern);
            hy[i] = (float)(ptr + dind);
          }
        if (co1 > 3) masked_lstsq(hx, hy, co1 < kHist ? co1 : kHist, b0, b1);
      }
      const long o = (long)s * p.steps + step;
      p.accept[o] = acc;
      p.ptr[o] = ptr;
      p.delay[o] = dind;
      p.peak[o] = dmax;
      lc = fire ? lc + 1 : lc;
      co = co1;
      pf = fire ? ptr : pf;
      pa = pa1;
      sc = acc ? sc + 1 : sc;
      lp = acc ? ptr : lp;
      s_accept = acc;
      s_col = arg < 0 ? 0 : (arg > cp ? cp : arg);
    }
    __syncthreads();

    // 5. the step's channel row: the estimate on the synch bins if accepted
    const bool acc = s_accept;
    const float2* pc = p.p_t + (long)s_col * L;
    float2* h = p.h_row + ((long)s * p.steps + step) * N;
    for (int q = tid; q < N; q += lte::kThreads) {
      const int l = __ldg(p.bin_slot + q);
      float2 v = make_float2(0.f, 0.f);
      if (acc && l >= 0) {
        for (int m = 0; m < m0; ++m) {
          const int k = m * nsb + l;
          const float2 e = lte::fft::cmul(lte::fft::cmul(sd[k], __ldg(pc + k)),
                                          __ldg(p.zc_conj + k));
          v.x += e.x / p.denom;
          v.y += e.y / p.denom;
        }
        v = make_float2(v.x / m0, v.y / m0);
      }
      h[q] = v;
    }
    __syncthreads();
  }

  if (tid == 0) {
    p.out.loop_count[s] = lc;
    p.out.corr_obs[s] = co;
    p.out.ptr_frame[s] = pf;
    p.out.ptr_adj[s] = pa;
    p.out.sym_count[s] = sc;
    p.out.last_ptr[s] = lp;
#pragma unroll
    for (int i = 0; i < kHist; ++i) {
      p.out.hx[s * kHist + i] = hx[i];
      p.out.hy[s * kHist + i] = hy[i];
    }
    p.out.b[2 * s] = b0;
    p.out.b[2 * s + 1] = b1;
  }
}

Carry carry_of(void* const* f) {
  return Carry{(int*)f[0], (int*)f[1], (int*)f[2], (int*)f[3], (int*)f[4],
               (int*)f[5], (float*)f[6], (float*)f[7], (float*)f[8]};
}

}  // namespace

// x [batch, n] complex64; x_start, fire_limit [batch] int32; carry_in /
// carry_out: host arrays of the nine carry fields' device pointers; ys:
// accept [batch, steps] bool, ptr, delay [batch, steps] int32, peak [batch,
// steps] float32, h_row [batch, steps, nfft] complex64.  smem: the dynamic
// shared memory the wrapper computed (kernels/tracker.py:smem_bytes).
extern "C" int tracker_scan(const void* x, int n, int batch,
                            const void* x_start, const void* fire_limit,
                            void* const* carry_in, void* const* carry_out,
                            int steps, const void* bins, const void* bin_slot,
                            const void* zc_conj, const void* p_t,
                            const void* tw, void* accept, void* ptr,
                            void* delay, void* peak, void* h_row, int nfft,
                            int cp, int m0, int nsb, int pattern, int stride,
                            int smem, float gate, float denom, void* stream) {
  Params p{(const float2*)x, n, (const int*)x_start, (const int*)fire_limit,
           carry_of(carry_in), carry_of(carry_out), steps, (const int*)bins,
           (const int*)bin_slot, (const float2*)zc_conj, (const float2*)p_t,
           (const float2*)tw, (unsigned char*)accept, (int*)ptr, (int*)delay,
           (float*)peak, (float2*)h_row, cp, m0, nsb, pattern, stride, gate,
           denom};
  return lte::fft::dispatch(nfft, [&](auto nn) {
    constexpr int N = decltype(nn)::value;
    const auto kern = tracker_scan_kernel<N>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<batch, lte::kThreads, smem, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
  });
}
