// The tracker's step loop: two persistent kernels, one a route, chosen by
// kernels/tracker.py:route on the shape.
//
// No Pallas kernel stands behind them: the JAX package runs the step of
// lte_gnu_radio_code_tpu/models/tracker.py (make_tracker_step) in one
// lax.scan (models/tracker.py:217, runtime/stream.py:503), which XLA
// compiles into one loop on the device.  Written out in torch the step is
// hundreds of small kernels, and every step depends on the one before.
//
// What bounds it on the H100: latency.  A step reads m_synch windows of
// nfft samples at a pointer that the step before decided, so nothing of the
// next step can start before this one's state update; the bytes (a window
// of 512 bytes at GOLDEN64, mostly from L1 / L2) and the operations (one
// 64-point FFT, 62 x 17 complex products) are tiny.  What sets a step's
// time is the length of its dependent chain.
//
// tracker_scan_warp ("warp" route, nfft a power of two in [16, 128] and
// cp < nfft): one warp a stream, kStreams streams a block.  The block puts
// its read-only tables in shared memory once, in the order of the warp's
// registers (the delay matrix and conj(ZC) at each lane's bins, zero
// elsewhere), and then crosses no block barrier: each warp loops over its
// stream's steps alone, with shuffles only.  A step:
//   1. every lane runs the pointer (the carry is held, the same, in every
//      lane's registers, so nothing is broadcast);
//   2. lane l loads samples l + W e, e < E = nfft / W, of each synch window
//      (W = 32 lanes, 16 at nfft 16), clamped to the buffer as the JAX
//      gather is; an E-point DFT in registers, the twiddle w^(l e), then a
//      W-point radix-2 DIF across the lanes by __shfl_xor_sync: register e
//      of lane l ends at bin e + E brev(l);
//   3. the power by warp_sum; q = X conj(zc) summed over the windows; the
//      correlations at every delay d, sum_k q_k e^(+2 pi i k d / nfft), as
//      the unscaled inverse transform of q (the same rounds backwards:
//      lane l ends with delays l + W e); a shuffle argmax over d <= cp,
//      ties to the lower index as torch.max and the block route's loop;
//   4. the state machine and the fit, in every lane;
//   5. on accept, the channel row, straight from the registers.
// A step that does not fire leaves the carry as it found it (make_tracker_
// step: no loop count, no accept, no history), so its pointer and every
// later step of the call are the same: the warp writes the rest of the
// call's outputs from that one step (the correlation of the window at
// x[0]) and leaves the loop.
//
// tracker_scan ("block" route, nfft above 128, or cp >= nfft): one block
// of 256 threads a stream; thread 0 holds the carry.  A step:
//   1. thread 0 turns the carry into this step's pointer and whether it
//      fires, and hands both to the block through shared memory;
//   2. the block gathers the m_synch windows (clamped) into shared memory
//      and transforms them with fft.cuh, the same in-block FFT as K2, and
//      keeps the synch bins;
//   3. the power normalisation sd / sqrt(mean |sd|^2), and q_k = sum_m
//      sd[m, k] conj(zc[m, k]) scattered to its bins in a zeroed row;
//   4. the correlations at every delay d, sum_k q_k e^(+2 pi i k d / nfft),
//      as the unscaled inverse transform of that row (fft.cuh again), read
//      at d <= cp (at d mod nfft where cp >= nfft);
//   5. the max |corr| and its first index by a block reduction: each thread
//      over its delays in order, warp shuffles, then the 8 warps' winners,
//      ties to the lower index as torch.max;
//   6. thread 0 runs the state machine and the fit;
//   7. on accept, the channel row: sd P[arg] conj(zc) / denom over the
//      windows, with P[arg] formed from the FFT's twiddle table,
//      e^(+2 pi i k arg / nfft) = conj(tw[k arg mod nfft]): the same float32
//      values as the delay matrix (both are the float64 exponential rounded
//      once), from an 8-32 KB table the transforms keep in L1, so the
//      block route never reads the delay matrix.
// As on the warp route, a step that does not fire is the carry's fixed
// point: the block writes its outputs (the correlation of the window at
// x[0]) into every later step's slots and leaves the loop, so a call
// computes its fired steps and one more, not every step.
//
// Both routes write the step outputs of the scan (accept, pointer, delay,
// peak) and the channel table compacted: row k of [max_det, nfft] holds
// the estimate of the k-th accepted step of the call, accepted steps past
// max_det are dropped, the rows past the count are zeroed at the end
// (models/tracker.py:emit_channels of the scan's rows).  The carry,
// x_start and fire_limit are read from and written to device memory, so a
// chunk step of the streaming receiver needs nothing from the host.
//
// The pointer prediction ceil(fit - cp/4) is exact on an unbounded stream,
// as the plain step's (models/tracker.py, module docstring): the history is
// int32 (hx = sym_count * pattern, hy = ptr + delay, global), the fit runs
// in float32 on differences from the newest entry, whose sums and products
// of sums are integers below 2^24, and the prediction is the newest entry's
// y plus ceil(b0 - cp/4), b0 the fitted value at the next entry's x less
// that y.  Only the two quotients round, once each (__fdiv_rn), as in the
// plain step, so both routes equal it bit for bit.
//
// The wrapper (kernels/tracker.py) checks the shapes; an nfft neither
// kernel was built for returns cudaErrorInvalidValue.

#include "common.cuh"
#include "fft.cuh"

namespace {

using lte::fft::cadd;
using lte::fft::cmul;
using lte::fft::csub;

constexpr int kHist = 5;           // least-squares history entries
constexpr int kStreams = 4;        // streams (a warp each) a block, warp route
constexpr unsigned kFull = 0xffffffffu;

struct Carry {                 // the nine leaves, one row a stream
  int* loop_count;
  int* corr_obs;
  int* ptr_frame;
  int* ptr_adj;
  int* sym_count;
  int* last_ptr;
  int* hx;                     // [B, 5] sym_count * pattern
  int* hy;                     // [B, 5] ptr + delay, global
  float* b;                    // [B, 2] the fit, as masked_lstsq leaves it
};

struct Params {
  const float2* x;             // [B, n]
  long n;
  int batch;
  const int* x_start;          // [B] global index of x[s, 0]
  const int* fire_limit;       // [B] global limit of a window's end
  Carry in, out;
  int steps, max_det;
  const int* bins;             // [nsb] synch bins, wrapped
  const int* bin_slot;         // [nfft] index among the synch bins, or -1
  const float2* zc_conj;       // [L]
  const float2* p_t;           // [cp + 1, L] delay matrix, transposed
  const float2* tw;            // fft.cuh twiddles
  unsigned char* accept;       // [B, steps]
  int* ptr;                    // [B, steps]
  int* delay;                  // [B, steps]
  float* peak;                 // [B, steps]
  float2* chans;               // [B, max_det, nfft]
  int cp, m0, nsb, pattern, stride;
  float gate;                  // 0.5 L
  float denom;                 // 1 + 1 / snr
};

// The least-squares line through the entries i < n_eff, on differences from
// entry k (the newest): x in patterns, u_i = (hx_i - hx_k) / pattern, and y
// in samples, v_i = hy_i - hy_k.  b0 = the line at u = 1 (the next entry),
// b1 = its slope per unit of x; zero with fewer than two entries.  Every
// sum and product below is an exact integer in float32; only the two
// quotients round (models/tracker.py:_masked_lstsq).
__device__ void masked_lstsq(const int (&hx)[kHist], const int (&hy)[kHist],
                             int n_eff, int k, int pattern, float& b0,
                             float& b1) {
  int ax = 0, ay = 0;
#pragma unroll
  for (int i = 0; i < kHist; ++i)
    if (i == k) {
      ax = hx[i];
      ay = hy[i];
    }
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, sy = 0.f, sxy = 0.f;
#pragma unroll
  for (int i = 0; i < kHist; ++i)
    if (i < n_eff) {
      const float u = (float)((hx[i] - ax) / pattern);
      const float v = (float)(hy[i] - ay);
      s0 = __fadd_rn(s0, 1.f);
      s1 = __fadd_rn(s1, u);
      s2 = __fadd_rn(s2, __fmul_rn(u, u));
      sy = __fadd_rn(sy, v);
      sxy = __fadd_rn(sxy, __fmul_rn(u, v));
    }
  const float det = __fsub_rn(__fmul_rn(s0, s2), __fmul_rn(s1, s1));
  const float num1 = __fsub_rn(__fmul_rn(s0, sxy), __fmul_rn(s1, sy));
  if (det > 0.f) {
    b0 = __fdiv_rn(__fadd_rn(__fsub_rn(__fmul_rn(s2, sy), __fmul_rn(s1, sxy)),
                             num1),
                   det);
    b1 = __fdiv_rn(num1, __fmul_rn(det, (float)pattern));
  } else {
    b0 = 0.f;
    b1 = 0.f;
  }
}

// One stream's carry and the step's state machine (models/tracker.py:
// make_tracker_step), the same on both routes.
struct State {
  int lc, co, pf, pa, sc, lp;
  int hx[kHist], hy[kHist];
  float b0, b1;

  __device__ void load(const Carry& c, int s) {
    lc = c.loop_count[s];
    co = c.corr_obs[s];
    pf = c.ptr_frame[s];
    pa = c.ptr_adj[s];
    sc = c.sym_count[s];
    lp = c.last_ptr[s];
#pragma unroll
    for (int i = 0; i < kHist; ++i) {
      hx[i] = c.hx[s * kHist + i];
      hy[i] = c.hy[s * kHist + i];
    }
    b0 = c.b[2 * s];
    b1 = c.b[2 * s + 1];
  }

  __device__ void store(const Carry& c, int s) const {
    c.loop_count[s] = lc;
    c.corr_obs[s] = co;
    c.ptr_frame[s] = pf;
    c.ptr_adj[s] = pa;
    c.sym_count[s] = sc;
    c.last_ptr[s] = lp;
#pragma unroll
    for (int i = 0; i < kHist; ++i) {
      c.hx[s * kHist + i] = hx[i];
      c.hy[s * kHist + i] = hy[i];
    }
    c.b[2 * s] = b0;
    c.b[2 * s + 1] = b1;
  }

  // this step's pointer: search by stride, nominal advance, or prediction
  __device__ int pointer(const Params& p, int rx_b_len) const {
    const int k = (sc + kHist - 1) % kHist;          // the newest entry
    int ay = 0;
#pragma unroll
    for (int i = 0; i < kHist; ++i)
      if (i == k) ay = hy[i];
    const int pred = ay + (int)ceilf(__fsub_rn(b0, 0.25f * p.cp));
    return co == -1 ? lc * p.stride + (p.cp - 5) + pa
                    : (co < 5 ? pf + p.pattern * rx_b_len : pred);
  }

  // The decision on the step's correlation (dmax, first-index argmax arg):
  // the +cp/2 re-adjustment (it may move ptr), the refractory test, the
  // history and the fit.  Returns whether the step is accepted.
  __device__ bool decide(const Params& p, int nfft, bool fire, int& ptr,
                         float dmax, int arg) {
    const int cp = p.cp, dind = arg - 1;
    const bool enter = fire && (dmax > p.gate || co > -1);
    const bool need_adj = enter && dind > (int)ceilf(0.75f * cp);
    const int adj = (cp + 1) / 2;
    const int pa1 = need_adj && co == 0 ? pa + adj : pa;
    if (need_adj && co == 0)
      ptr = lc * p.stride + (cp - 5) + pa1;
    else if (need_adj && co > 0 && co < 5)
      ptr += adj;
    const int refr = co == 0 ? 0 : lp;
    const bool acc = enter && (ptr - refr > 2 * cp + nfft || co == -1);
    const int co1 = acc ? co + 1 : co;
    if (acc) {
      const int k = sc % kHist;
#pragma unroll
      for (int i = 0; i < kHist; ++i)
        if (i == k) {
          hx[i] = sc * p.pattern;
          hy[i] = ptr + dind;
        }
      if (co1 > 3)
        masked_lstsq(hx, hy, co1 < kHist ? co1 : kHist, k, p.pattern, b0, b1);
    }
    lc = fire ? lc + 1 : lc;
    co = co1;
    pf = fire ? ptr : pf;
    pa = pa1;
    sc = acc ? sc + 1 : sc;
    lp = acc ? ptr : lp;
    return acc;
  }
};

// ---------------------------------------------------------------------------
// The warp route
// ---------------------------------------------------------------------------

template <int N>
struct Lanes {
  static_assert(N >= 16 && N <= 128 && (N & (N - 1)) == 0,
                "the warp route: N a power of two in [16, 128]");
  static constexpr int E = N >= 64 ? N / 32 : 1;   // points a lane
  static constexpr int W = N / E;                  // lanes a window
  static constexpr int LOGW = W == 32 ? 5 : 4;
  static constexpr int ROW = E * 32;               // table entries a row

  // the bin that register e of lane ln holds after the transform
  __device__ static int bin(int ln, int e) {
    return e + E * (int)(__brev((unsigned)(ln & (W - 1))) >> (32 - LOGW));
  }
};

// What one lane keeps for the whole loop: its twiddles and bins.
template <int N>
struct Lane {
  using Ln = Lanes<N>;
  static constexpr int E = Ln::E, W = Ln::W, LOGW = Ln::LOGW;
  int lane, l;                 // l: the lane's place in its window
  float2 w1[E];                // w_N^(l e)
  float2 ws[LOGW];             // each DIF round's twiddle
  bool use[E];                 // register e holds a synch bin (lane < W)

  __device__ Lane(const Params& p, int lane_)
      : lane(lane_), l(lane_ & (W - 1)) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      w1[e] = __ldg(p.tw + l * e);
      use[e] = lane < W && __ldg(p.bin_slot + Ln::bin(lane, e)) >= 0;
    }
#pragma unroll
    for (int r = 0; r < LOGW; ++r) {
      const int h = W >> (r + 1);
      ws[r] = __ldg(p.tw + (l & (h - 1)) * (N / (2 * h)));
    }
  }

  // This lane's samples of the window at x[base], clamped to the buffer.
  __device__ void load(const float2* __restrict__ x, long n, long base,
                       float2 (&X)[E]) const {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      long i = base + l + (long)W * e;
      i = i < 0 ? 0 : (i >= n ? n - 1 : i);
      X[e] = __ldg(x + i);
    }
  }

  // The forward transform of a window load() fetched: register e ends at
  // bin Ln::bin(lane, e).
  __device__ void forward(float2 (&X)[E]) const {
    if constexpr (E == 2) {
      const float2 a = X[0], b = X[1];
      X[0] = cadd(a, b);
      X[1] = csub(a, b);
    } else if constexpr (E == 4) {
      const float2 a0 = cadd(X[0], X[2]), a1 = csub(X[0], X[2]);
      const float2 a2 = cadd(X[1], X[3]), a3 = csub(X[1], X[3]);
      const float2 b = make_float2(a3.y, -a3.x);          // -i a3
      X[0] = cadd(a0, a2);
      X[1] = cadd(a1, b);
      X[2] = csub(a0, a2);
      X[3] = csub(a1, b);
    }
#pragma unroll
    for (int e = 1; e < E; ++e) X[e] = cmul(X[e], w1[e]);
#pragma unroll
    for (int r = 0; r < LOGW; ++r) {
      const int h = W >> (r + 1);
      const bool up = l & h;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float2 q = make_float2(__shfl_xor_sync(kFull, X[e].x, h),
                                     __shfl_xor_sync(kFull, X[e].y, h));
        X[e] = up ? cmul(csub(q, X[e]), ws[r]) : cadd(X[e], q);
      }
    }
  }

  // The unscaled inverse of forward(), registers laid out as it leaves
  // them: its rounds in reverse order with conjugate twiddles, so that
  // register e of lane l ends at time index l + W e.
  __device__ void inverse(float2 (&X)[E]) const {
#pragma unroll
    for (int r = LOGW - 1; r >= 0; --r) {
      const int h = W >> (r + 1);
      const bool up = l & h;
      const float2 w = make_float2(ws[r].x, -ws[r].y);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float2 t = up ? cmul(X[e], w) : X[e];
        const float2 q = make_float2(__shfl_xor_sync(kFull, t.x, h),
                                     __shfl_xor_sync(kFull, t.y, h));
        X[e] = up ? csub(q, t) : cadd(t, q);
      }
    }
#pragma unroll
    for (int e = 1; e < E; ++e)
      X[e] = cmul(X[e], make_float2(w1[e].x, -w1[e].y));
    if constexpr (E == 2) {
      const float2 a = X[0], b = X[1];
      X[0] = cadd(a, b);
      X[1] = csub(a, b);
    } else if constexpr (E == 4) {
      const float2 a0 = cadd(X[0], X[2]), a1 = csub(X[0], X[2]);
      const float2 a2 = cadd(X[1], X[3]), a3 = csub(X[1], X[3]);
      const float2 b = make_float2(-a3.y, a3.x);          // +i a3
      X[0] = cadd(a0, a2);
      X[1] = cadd(a1, b);
      X[2] = csub(a0, a2);
      X[3] = csub(a1, b);
    }
  }

  // The windows at x[local + m rx_b_len]: q = sum_m X_m conj(zc_m) at this
  // lane's bins (Q, zero off the synch bins), the power scale, and in every
  // lane the max |corr| over the cp + 1 delays and its first index.  The
  // delay matrix is P[d, k] = e^(+2 pi i k d / nfft), so the correlations
  // sum_k q_k P[d, k] of every d are the unscaled inverse transform of q.
  __device__ void correlate(const Params& p, const float2* __restrict__ x,
                            long local, int rx_b_len, const float2* ztab,
                            float2 (&Q)[E], float& scale, float& dmax,
                            int& arg) const {
    float pw = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) Q[e] = make_float2(0.f, 0.f);
    for (int m = 0; m < p.m0; ++m) {
      float2 X[E];
      load(x, p.n, local + (long)m * rx_b_len, X);
      forward(X);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (use[e]) pw = fmaf(X[e].y, X[e].y, fmaf(X[e].x, X[e].x, pw));
        Q[e] = cadd(Q[e], cmul(X[e], ztab[(m * E + e) * 32 + lane]));
      }
    }
    pw = lte::warp_sum(pw);
    scale = sqrtf(fmaxf(pw / (p.m0 * p.nsb), 1e-30f));
    float2 c[E];
#pragma unroll
    for (int e = 0; e < E; ++e) c[e] = Q[e];
    inverse(c);
    float best = -1.f;
    int at = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {        // e in order: the lower delay
      const int d = l + W * e;
      const float val =
          lane < W && d <= p.cp ? hypotf(c[e].x, c[e].y) / scale : -1.f;
      if (val > best) {
        best = val;
        at = d;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, best, o);
      const int oi = __shfl_xor_sync(kFull, at, o);
      if (ov > best || (ov == best && oi < at)) {
        best = ov;
        at = oi;
      }
    }
    dmax = best;
    arg = at;
  }
};

template <int N>
__global__ void __launch_bounds__(kStreams * 32)
tracker_scan_warp_kernel(const Params p) {
  using Ln = Lanes<N>;
  constexpr int E = Ln::E, W = Ln::W, ROW = Ln::ROW;
  extern __shared__ float4 smem[];
  const int cp = p.cp, D = cp + 1, rx_b_len = N + cp, L = p.m0 * p.nsb;
  // [D][E][32] the delay matrix and [m0][E][32] conj(ZC), each at the bin
  // of register e of lane l, zero where that is no synch bin
  float2* ptab = reinterpret_cast<float2*>(smem);
  const float2* ztab = ptab + D * ROW;
  for (int i = threadIdx.x; i < (D + p.m0) * ROW; i += blockDim.x) {
    const int row = i / ROW, e = i / 32 % E, ln = i % 32;
    const int slot = ln < W ? __ldg(p.bin_slot + Ln::bin(ln, e)) : -1;
    float2 v = make_float2(0.f, 0.f);
    if (slot >= 0)
      v = row < D ? __ldg(p.p_t + (long)row * L + slot)
                  : __ldg(p.zc_conj + (row - D) * p.nsb + slot);
    ptab[i] = v;
  }
  __syncthreads();
  const int s = blockIdx.x * kStreams + threadIdx.x / 32;
  if (s >= p.batch) return;

  const Lane<N> me(p, threadIdx.x % 32);
  const float2* x = p.x + (long)s * p.n;
  const int xs = p.x_start[s], fl = p.fire_limit[s];
  const long o = (long)s * p.steps;
  float2* chans = p.chans + (long)s * p.max_det * N;
  State st;
  st.load(p.in, s);
  int count = 0;                         // accepted steps of this call

  for (int step = 0; step < p.steps; ++step) {
    int ptr = st.pointer(p, rx_b_len);
    const bool fire = (p.m0 - 1) * rx_b_len + N + ptr < fl && ptr >= xs;
    float2 Q[E];
    float scale, dmax;
    int arg;
    me.correlate(p, x, fire ? ptr - xs : 0, rx_b_len, ztab, Q, scale, dmax,
                 arg);
    if (!fire) {                         // the carry's fixed point
      for (int t = step + me.lane; t < p.steps; t += 32) {
        p.accept[o + t] = 0;
        p.ptr[o + t] = ptr;
        p.delay[o + t] = arg - 1;
        p.peak[o + t] = dmax;
      }
      break;
    }
    const bool acc = st.decide(p, N, fire, ptr, dmax, arg);
    if (me.lane == 0) {
      p.accept[o + step] = acc;
      p.ptr[o + step] = ptr;
      p.delay[o + step] = arg - 1;
      p.peak[o + step] = dmax;
    }
    if (acc && count < p.max_det && me.lane < W) {
      // the estimate on the synch bins: sd P[arg] conj(zc) / denom, the
      // mean over the windows (zero on the other bins: ptab is)
      float2* h = chans + (long)count * N;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float2 c = cmul(make_float2(Q[e].x / scale, Q[e].y / scale),
                              ptab[(arg * E + e) * 32 + me.lane]);
        h[Ln::bin(me.lane, e)] = make_float2(c.x / p.denom / p.m0,
                                             c.y / p.denom / p.m0);
      }
    }
    count += acc;
  }

  for (long i = (long)min(count, p.max_det) * N + me.lane;
       i < (long)p.max_det * N; i += 32)
    chans[i] = make_float2(0.f, 0.f);
  if (me.lane == 0) st.store(p.out, s);
}

// ---------------------------------------------------------------------------
// The block route
// ---------------------------------------------------------------------------

template <int N>
__global__ void __launch_bounds__(lte::kThreads)
tracker_scan_kernel(const Params p) {
  using Rows = lte::fft::Rows<N>;
  constexpr int T = Rows::T, R = Rows::R;
  constexpr int kWarps = lte::kThreads / 32;
  extern __shared__ float4 smem[];
  __shared__ float red[kWarps];
  __shared__ int red_at[kWarps];
  __shared__ int s_local, s_ptr, s_row, s_used;
  __shared__ bool s_fire;

  const int s = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int t = tid % T, slot = tid / T;
  const int cp = p.cp, m0 = p.m0, nsb = p.nsb, L = m0 * nsb, D = cp + 1;
  const int rx_b_len = N + cp;
  float2* rows = reinterpret_cast<float2*>(smem);
  float2* sd = rows + 2 * R * N;                        // [L]
  float2* c = rows + slot * 2 * N;                      // staging
  float2* w = c + N;                                    // work
  float2* q = rows;            // slot 0's staging row: q at its bins ...
  const float2* corr = rows + N;   // ... and its inverse transform
  const float2* x = p.x + (long)s * p.n;
  float2* chans = p.chans + (long)s * p.max_det * N;

  // the carry, held by thread 0
  State st;
  int xs = 0, fl = 0, ptr = 0, count = 0;
  if (tid == 0) {
    st.load(p.in, s);
    xs = p.x_start[s];
    fl = p.fire_limit[s];
  }

  for (int step = 0; step < p.steps; ++step) {
    // 1. this step's pointer
    if (tid == 0) {
      ptr = st.pointer(p, rx_b_len);
      const bool fire = (m0 - 1) * rx_b_len + N + ptr < fl && ptr >= xs;
      s_local = fire ? ptr - xs : 0;
      s_ptr = ptr;
      s_fire = fire;
    }
    __syncthreads();
    const long local = s_local;
    const bool fire = s_fire;

    // 2. the synch windows' spectra on the synch bins
    for (int g = 0; g < m0; g += R) {
      const int m = g + slot;
      if (m < m0) {
        const long base = local + (long)m * rx_b_len;
        for (int k = t; k < N; k += T) {
          long i = base + k;
          i = i < 0 ? 0 : (i >= p.n ? p.n - 1 : i);
          c[k] = x[i];
        }
      } else {
        for (int k = t; k < N; k += T) c[k] = make_float2(0.f, 0.f);
      }
      __syncthreads();
      lte::fft::transform<N, T, false>(c, w, p.tw, t, 1.f, [] {});
      if (m < m0)
        for (int k = t; k < nsb; k += T) sd[m * nsb + k] = w[__ldg(p.bins + k)];
      __syncthreads();
    }

    // 3. the power normalisation, and q scattered to its bins in a zeroed
    // row (the staging rows are free since the transforms' first stage)
    float pw = 0.f;
    for (int l = tid; l < L; l += lte::kThreads)
      pw += sd[l].x * sd[l].x + sd[l].y * sd[l].y;
    for (int k = tid; k < N; k += lte::kThreads) q[k] = make_float2(0.f, 0.f);
    pw = lte::warp_sum(pw);
    if (lane == 0) red[warp] = pw;
    __syncthreads();
    float tot = 0.f;                     // every thread, in the same order
#pragma unroll
    for (int i = 0; i < kWarps; ++i) tot += red[i];
    const float scale = sqrtf(fmaxf(tot / L, 1e-30f));
    for (int k = tid; k < nsb; k += lte::kThreads) {
      float2 acc = make_float2(0.f, 0.f);
      for (int m = 0; m < m0; ++m) {
        const int l = m * nsb + k;
        const float2 v = make_float2(sd[l].x / scale, sd[l].y / scale);
        sd[l] = v;
        acc = cadd(acc, cmul(v, __ldg(p.zc_conj + l)));
      }
      q[__ldg(p.bins + k)] = acc;
    }
    __syncthreads();

    // 4. the correlations: the unscaled inverse transform of q (every
    // slot runs the transform's barriers; slot 0's row is the one read)
    lte::fft::transform<N, T, true>(c, w, p.tw, t, 1.f, [] {});
    if constexpr (T <= 32) __syncthreads();   // rows of a warp sync it only

    // 5. max |corr| over d <= cp and its first index
    float best = -1.f;
    int at = D;
    for (int d = tid; d < D; d += lte::kThreads) {   // d in order: the lower
      const float2 v = corr[d & (N - 1)];
      const float a = hypotf(v.x, v.y);
      if (a > best) {
        best = a;
        at = d;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, best, o);
      const int oi = __shfl_xor_sync(kFull, at, o);
      if (ov > best || (ov == best && oi < at)) {
        best = ov;
        at = oi;
      }
    }
    if (lane == 0) {
      red[warp] = best;
      red_at[warp] = at;
    }
    __syncthreads();
    float dmax = red[0];
    int arg = red_at[0];
#pragma unroll
    for (int i = 1; i < kWarps; ++i)
      if (red[i] > dmax || (red[i] == dmax && red_at[i] < arg)) {
        dmax = red[i];
        arg = red_at[i];
      }

    if (!fire) {                         // the carry's fixed point
      const int at_ptr = s_ptr;
      for (int u = step + tid; u < p.steps; u += lte::kThreads) {
        const long o = (long)s * p.steps + u;
        p.accept[o] = 0;
        p.ptr[o] = at_ptr;
        p.delay[o] = arg - 1;
        p.peak[o] = dmax;
      }
      break;
    }

    // 6. the decision and the state machine
    if (tid == 0) {
      const bool acc = st.decide(p, N, true, ptr, dmax, arg);
      const long o = (long)s * p.steps + step;
      p.accept[o] = acc;
      p.ptr[o] = ptr;
      p.delay[o] = arg - 1;
      p.peak[o] = dmax;
      s_row = acc && count < p.max_det ? count : -1;
      count += acc;
    }
    __syncthreads();

    // 7. on accept, the channel row in its slot of the table.  No barrier
    // after it: the next step writes sd and s_row only after its first
    // one, and the end of the call reads the count from s_used.
    const int row = s_row;
    if (row >= 0) {
      float2* h = chans + (long)row * N;
      for (int k = tid; k < N; k += lte::kThreads) {
        const int l = __ldg(p.bin_slot + k);
        float2 v = make_float2(0.f, 0.f);
        if (l >= 0) {
          const float2 e = __ldg(p.tw + ((k * arg) & (N - 1)));
          const float2 pk = make_float2(e.x, -e.y);      // P[k, arg]
          for (int m = 0; m < m0; ++m) {
            const int j = m * nsb + l;
            const float2 u = cmul(cmul(sd[j], pk), __ldg(p.zc_conj + j));
            v.x += u.x / p.denom;
            v.y += u.y / p.denom;
          }
          v = make_float2(v.x / m0, v.y / m0);
        }
        h[k] = v;
      }
    }
  }

  if (tid == 0) {
    st.store(p.out, s);
    s_used = min(count, p.max_det);
  }
  __syncthreads();
  for (long i = (long)s_used * N + tid; i < (long)p.max_det * N;
       i += lte::kThreads)
    chans[i] = make_float2(0.f, 0.f);
}

Carry carry_of(void* const* f) {
  return Carry{(int*)f[0], (int*)f[1], (int*)f[2], (int*)f[3], (int*)f[4],
               (int*)f[5], (int*)f[6], (int*)f[7], (float*)f[8]};
}

}  // namespace

// Both routes take the same arguments.  x [batch, n] complex64; x_start,
// fire_limit [batch] int32; carry_in / carry_out: host arrays of the nine
// carry fields' device pointers; ys: accept [batch, steps] bool, ptr, delay
// [batch, steps] int32, peak [batch, steps] float32, chans [batch, max_det,
// nfft] complex64; smem: the dynamic shared memory the wrapper computed
// (kernels/tracker.py:smem_bytes).
#define TRACKER_ARGS                                                          \
  const void *x, int n, int batch, const void *x_start,                       \
      const void *fire_limit, void *const *carry_in, void *const *carry_out,  \
      int steps, int max_det, const void *bins, const void *bin_slot,         \
      const void *zc_conj, const void *p_t, const void *tw, void *accept,     \
      void *ptr, void *delay, void *peak, void *chans, int nfft, int cp,      \
      int m0, int nsb, int pattern, int stride, int smem, float gate,         \
      float denom, void *stream

#define TRACKER_PARAMS                                                        \
  Params p{(const float2*)x, n, batch, (const int*)x_start,                   \
           (const int*)fire_limit, carry_of(carry_in), carry_of(carry_out),   \
           steps, max_det, (const int*)bins, (const int*)bin_slot,            \
           (const float2*)zc_conj, (const float2*)p_t, (const float2*)tw,     \
           (unsigned char*)accept, (int*)ptr, (int*)delay, (float*)peak,      \
           (float2*)chans, cp, m0, nsb, pattern, stride, gate, denom}

template <class Kern>
static int launch(Kern kern, int blocks, int threads, int smem,
                  void* stream, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int tracker_scan(TRACKER_ARGS) {
  TRACKER_PARAMS;
  return lte::fft::dispatch(nfft, [&](auto nn) {
    constexpr int N = decltype(nn)::value;
    return launch(tracker_scan_kernel<N>, batch, lte::kThreads, smem, stream,
                  p);
  });
}

extern "C" int tracker_scan_warp(TRACKER_ARGS) {
  TRACKER_PARAMS;
  const int blocks = (batch + kStreams - 1) / kStreams;
  const auto run = [&](auto kern) {
    return launch(kern, blocks, kStreams * 32, smem, stream, p);
  };
  switch (nfft) {
    case 16: return run(tracker_scan_warp_kernel<16>);
    case 32: return run(tracker_scan_warp_kernel<32>);
    case 64: return run(tracker_scan_warp_kernel<64>);
    case 128: return run(tracker_scan_warp_kernel<128>);
  }
  return (int)cudaErrorInvalidValue;
}
