// The expensive range observers' device work, f32: the MSE observer's
// candidate search (mse_range), the histogram observer's update
// (hist_update) and its range search (hist_search).
//
// They replace no TPU kernel: jaxlsq runs these observers as XLA programs
// (jaxlsq/observers/minmax.py MSEObserver._best_range :145,
// jaxlsq/observers/histogram.py HistogramObserver.update :123 and _search
// :184) and skips them after the observer window with a lax.cond
// (jaxlsq/observers/quantizer.py:331-348).  A captured CUDA graph has no
// lax.cond, and as PyTorch ops the MSE search is 64 passes over the
// activation and the histogram search a host-driven loop that cannot be
// captured at all.  So each kernel takes a nullable device bool `gate` (the
// quantizer's observer_enabled): when it reads false the kernel returns at
// its first instruction and writes nothing, and the where-merge after it
// keeps the old state, as jaxlsq's untaken branch does.  The eager regime
// launches only when its host mirror says the observer is on, and passes
// null.
//
// Numerics: every product, sum and quotient is an explicit _rn intrinsic
// (nvcc may not contract them into an FMA), divisions are IEEE (no fast
// math), rintf rounds half to even, and max/min pass NaN through as
// torch.maximum/torch.clamp do.  So each element's value is the plain
// version's bit for bit (jaxlsq_torch/ops/observers.py); only sums differ
// in order, and each order is fixed by the shape alone: no float atomics,
// the same bits on every run, eager and captured alike.
//
// mse_range (K1).  For each channel c of x's (outer, C, inner) view (per
// tensor: outer = C = 1) and each of the 64 candidates f_k =
// linspace(1/64, 1, 64)[k] (jnp.linspace's formula), the qparams (s_k, z_k)
// of the range (bmin[c] f_k, bmax[c] f_k) (observer_qparams) and the error
// sum over the channel of ((rint(clamp(x / s_k + z_k, qmin, qmax)) - z_k)
// s_k - x)^2; then the first k of least error, and out = (bmin f_k, bmax
// f_k).  One pass over x: the block's 256 threads are four quarters of 64
// lanes, a quarter on 16 of the candidates (a thread keeps their 16 sums in
// registers), lane l on the groups of 4 consecutive elements at 4 (64 j +
// l) of the block's chunk, in ascending order.  (The 64 sums of one thread
// held 216 registers, one block an SM: 7.6 ms at mobilenetv2's largest
// activation on the H100, PERF.md §6.)  A channel's elements are cut into
// bpc chunks (mse_plan in ops/observers.py), one block each (each level by
// mse_level: the divide only near a half-integer); a block folds
// each candidate's sums by the shuffle tree over a warp's lanes, then its
// quarter's first warp plus its second, stores them, and draws the
// channel's ticket; the block that draws the last ticket adds the bpc
// partials in ascending block order and picks the candidate.  Bound: each
// element costs ~10 operations a candidate (a divide, an add, max, min,
// rint, then (xq - z) s - x, its square and the sum), against 4 bytes read:
// operations, 640 an element.
//
// hist_update (K2).  The batch's histc over the new range [mn, mx]
// (bins equal-width bins; out-of-range values ignored, x == mx in the last
// bin, a degenerate range's mass in bin bins / 2) counted in integers:
// warp-aggregated shared-memory atomics (lanes of one bin add once), a
// block's counts added to a global count (integer atomics: the same total
// in any order), a ticket, and the last block converts the counts (f32
// saturates at 2^24, as a scatter-add of ones does) and adds the old
// histogram in the new grid: the old one itself when the range did not
// move; all its mass in the bin of omin when its range was degenerate;
// else torch's _upscale_histogram, each source bin split into u fine bins
// whose mass goes to the destination bin holding the fine bin's mid-point.
// The destination index is monotone in the fine bin wherever the mid-points
// are, so each destination bin sums a contiguous run of fine bins, in
// ascending order from +0 (a sequential scatter-add's order); if rounding
// ever makes it not monotone, one thread scatters the fine bins in order.
// Bound: the bytes of x (4 an element).
//
// hist_search (K3).  torch's _non_linear_param_search as jaxlsq's
// lax.while_loop, in one block: thread 0 steps alpha/beta by 1e-5f in f32,
// binary-searches the cumulative histogram (each prefix a double sum rounded
// to f32, as torch.cumsum on the CPU) and, only when the candidate range
// moved, the block scores it: the piecewise-uniform L2 error of each of
// the bins, summed by the adjacent pairwise tree (pairs, then pairs of
// pairs, ...; bins < 2048 padded with +0).  It stops when the error rises.
// Writes (min, max) of the chosen range, and the loop's trips and how many
// of them scored a range.  Bound:
// the loop is serial; its bytes are the histogram's.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kCand = 64;          // MSE candidates
constexpr int kMseThreads = 256;
constexpr int kCandPerThread = 16;  // a thread's candidates: a quarter of them
constexpr int kMseLanes = kMseThreads / (kCand / kCandPerThread);  // 64
constexpr int kHistThreads = 512;
constexpr int kSearchThreads = 1024;
constexpr int kMaxBins = 2048;

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return min_nan(max_nan(v, lo), hi);
}

// The quant range of observer_qparams (jaxlsq_torch/observers/minmax.py).
struct QRange {
  float qmin, qmax;
  float span;       // qmax - qmin
  float half_span;  // (qmax - qmin) / 2
  float zp_sym;     // a symmetric range's zero point
  int sym;
  int fast;         // |qmin|, |qmax| <= 1000: mse_level's shortcut holds
};

// observer_qparams of one range (mn, mx): scale s and the float zero point z.
__device__ __forceinline__ void range_qparams(float mn, float mx, const QRange& q,
                                              float& s, float& z) {
  const float min_neg = min_nan(mn, 0.f);
  const float max_pos = max_nan(mx, 0.f);
  if (q.sym) {
    s = max_nan(__fdiv_rn(max_nan(-min_neg, max_pos), q.half_span), FLT_EPSILON);
    z = q.zp_sym;
  } else {
    s = max_nan(__fdiv_rn(__fsub_rn(max_pos, min_neg), q.span), FLT_EPSILON);
    z = clamp_nan(__fsub_rn(q.qmin, rintf(__fdiv_rn(min_neg, s))), q.qmin, q.qmax);
  }
}

// jnp.linspace(start, stop, num)[k]: start (1 - k/div) + stop (k/div), the
// last element stop itself.
__device__ __forceinline__ float linspace_at(float start, float stop, int k, int num) {
  const int div = num - 1;
  if (k == div) return stop;
  const float step = __fdiv_rn((float)k, (float)div);
  return __fadd_rn(__fmul_rn(start, __fsub_rn(1.f, step)), __fmul_rn(stop, step));
}

// The shuffle tree of a warp's 32 values: v[l] += v[l + h] for h = 16 .. 1;
// lane 0 holds the sum.
__device__ __forceinline__ float warp_tree(float v) {
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, h));
  return v;
}

// The adjacent pairwise tree of a warp's 32 values: v[l] += v[l + h] for
// h = 1 .. 16 (pairs, then pairs of pairs); lane 0 holds the sum.
__device__ __forceinline__ float warp_pairs(float v) {
#pragma unroll
  for (int h = 1; h < 32; h <<= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, h));
  return v;
}

__device__ __forceinline__ float tree8(float (&v)[8]) {
#pragma unroll
  for (int h = 4; h > 0; h >>= 1)
#pragma unroll
    for (int k = 0; k < h; ++k) v[k] = __fadd_rn(v[k], v[k + h]);
  return v[0];
}

__device__ __forceinline__ bool gate_off(const bool* gate) {
  return gate != nullptr && !*gate;
}

// ------------------------------------------------------------------ K1

// A candidate's level rint(clamp(x / s + z, qmin, qmax)) without the divide
// where that cannot change it: ta = x r + z (r = 1 / s rounded) lies within
// 1e-4 of the exact x / s + z wherever |ta| < qmax + 1 (|x / s| < 512 with
// |z| <= 255: 2^-24 of it from r, from the fma and from each of the exact
// path's two roundings), so beyond qmax + 1 or qmin - 1 the level is the
// bound, and more than kLevelMargin = 2^-11 from a half-integer it is
// rint(ta) clamped (the bounds are integers, so clamp and rint commute).
// Only near a half-integer (about 1 in 1,000 of the values) is the IEEE
// divide taken; a NaN takes it too, and every value of a range wider than
// |q| <= 1000 (q.fast 0), where the 1e-4 would not hold.
constexpr float kLevelMargin = 4.8828125e-4f;

__device__ __forceinline__ float mse_level(float x, float s, float r, float z,
                                           const QRange& q) {
  const float ta = fmaf(x, r, z);
  if (!q.fast) return rintf(clamp_nan(__fadd_rn(__fdiv_rn(x, s), z), q.qmin, q.qmax));
  if (ta >= q.qmax + 1.f) return q.qmax;
  if (ta <= q.qmin - 1.f) return q.qmin;
  if (fabsf(ta - floorf(ta) - 0.5f) > kLevelMargin)
    return fminf(fmaxf(rintf(ta), q.qmin), q.qmax);
  return rintf(clamp_nan(__fadd_rn(__fdiv_rn(x, s), z), q.qmin, q.qmax));
}

__global__ void __launch_bounds__(kMseThreads)
mse_range_kernel(const float* __restrict__ x, const float* __restrict__ bmin,
                 const float* __restrict__ bmax, const bool* __restrict__ gate,
                 float* __restrict__ part, unsigned* __restrict__ tickets,
                 float* __restrict__ out_min, float* __restrict__ out_max,
                 float* __restrict__ errs, int* __restrict__ best, int C, int inner,
                 int n, int bpc, int chunk, QRange q) {
  if (gate_off(gate)) return;
  __shared__ float s_s[kCand], s_z[kCand], s_r[kCand];
  __shared__ float wsum[kMseThreads / 32][kCandPerThread];
  __shared__ float errs_s[kCand];
  __shared__ bool last;
  const int c = blockIdx.x / bpc, pb = blockIdx.x % bpc;
  const float mn = bmin[c], mx = bmax[c];
  if (threadIdx.x < kCand) {
    const float f = linspace_at(1.f / kCand, 1.f, threadIdx.x, kCand);
    float s, z;
    range_qparams(__fmul_rn(mn, f), __fmul_rn(mx, f), q, s, z);
    s_s[threadIdx.x] = s;
    s_z[threadIdx.x] = z;
    s_r[threadIdx.x] = __frcp_rn(s);
  }
  __syncthreads();
  // quarter qt of the block takes candidates kq .. kq + 15; its lane l the
  // groups of 4 elements at 4 (64 j + l) of the chunk
  const int qt = threadIdx.x / kMseLanes, l = threadIdx.x % kMseLanes;
  const int kq = qt * kCandPerThread;
  float acc[kCandPerThread];
#pragma unroll
  for (int k = 0; k < kCandPerThread; ++k) acc[k] = 0.f;
  const int lo = pb * chunk;
  const int hi = min(n, lo + chunk);
  const bool flat = C == 1 && inner == n;
  for (int j0 = lo + 4 * l; j0 < hi; j0 += 4 * kMseLanes) {
    float v[4];
    const int cnt = min(4, hi - j0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + e;
      // the channel's j-th element: (j / inner, c, j % inner) of the view
      v[e] = e < cnt ? x[flat ? j : (j / inner * C + c) * inner + j % inner] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kCandPerThread; ++k) {
      const float s = s_s[kq + k], z = s_z[kq + k], r = s_r[kq + k];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e < cnt) {
          const float xq = mse_level(v[e], s, r, z, q);
          const float d = __fsub_rn(__fmul_rn(__fsub_rn(xq, z), s), v[e]);
          acc[k] = __fadd_rn(acc[k], __fmul_rn(d, d));
        }
      }
    }
  }
  // a quarter's two warps: the shuffle tree over each warp's lanes, then the
  // first warp's sum plus the second's
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kCandPerThread; ++k) {
    const float t = warp_tree(acc[k]);
    if (lane == 0) wsum[warp][k] = t;
  }
  __syncthreads();
  if (threadIdx.x < kCand) {
    const int qq = threadIdx.x / kCandPerThread, k = threadIdx.x % kCandPerThread;
    part[(size_t)blockIdx.x * kCand + threadIdx.x] =
        __fadd_rn(wsum[2 * qq][k], wsum[2 * qq + 1][k]);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[c], 1u) == (unsigned)(bpc - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x < kCand) {
    float e = 0.f;
    for (int b = 0; b < bpc; ++b)
      e = __fadd_rn(e, __ldcg(&part[((size_t)c * bpc + b) * kCand + threadIdx.x]));
    errs_s[threadIdx.x] = e;
    if (errs != nullptr) errs[(size_t)c * kCand + threadIdx.x] = e;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // the first least error; a NaN wins, as argmin's
    int k0 = 0;
    for (int k = 1; k < kCand; ++k) {
      const float b = errs_s[k0], e = errs_s[k];
      if (!isnan(b) && (isnan(e) || e < b)) k0 = k;
    }
    const float f = linspace_at(1.f / kCand, 1.f, k0, kCand);
    out_min[c] = __fmul_rn(mn, f);
    out_max[c] = __fmul_rn(mx, f);
    if (best != nullptr) best[c] = k0;
  }
}

// ------------------------------------------------------------------ K2

// The histc bin of v over [mn, mx] (bins equal-width bins), or -1 when v is
// outside it (a NaN too).
__device__ __forceinline__ int histc_bin(float v, float mn, float mx, float width,
                                         bool degenerate, int bins) {
  if (!(v >= mn && v <= mx)) return -1;
  if (degenerate) return bins / 2;
  if (v >= mx) return bins - 1;
  const float idx = floorf(__fdiv_rn(__fsub_rn(v, mn), width));
  return (int)fminf(fmaxf(idx, 0.f), (float)(bins - 1));
}

// The histc grid of [mn, mx]: its bin width and whether it is degenerate.
__device__ __forceinline__ void histc_grid(float mn, float mx, int bins, float& width,
                                           bool& degenerate) {
  width = __fdiv_rn(__fsub_rn(mx, mn), (float)bins);
  degenerate = width <= 0.f;
  if (degenerate) width = 1.f;
}

__global__ void __launch_bounds__(kHistThreads)
hist_update_kernel(const float* __restrict__ x, int n, const float* __restrict__ hist,
                   const float* __restrict__ omin_p, const float* __restrict__ omax_p,
                   const float* __restrict__ nmin_p, const float* __restrict__ nmax_p,
                   const int* __restrict__ seen, const bool* __restrict__ gate,
                   unsigned* __restrict__ work, float* __restrict__ out, int bins, int u) {
  if (gate_off(gate)) return;
  __shared__ unsigned cnt[kMaxBins];
  __shared__ float bnd[kMaxBins + 1];
  __shared__ int run[kMaxBins + 1];
  __shared__ float wsum[kHistThreads / 32];
  __shared__ bool last, mono;
  unsigned* counts = work;            // bins counts
  unsigned* ticket = work + bins;     // one counter
  const float mn = *nmin_p, mx = *nmax_p;
  float width;
  bool degenerate;
  histc_grid(mn, mx, bins, width, degenerate);
  for (int j = threadIdx.x; j < bins; j += kHistThreads) cnt[j] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kHistThreads / 32);
  for (int base = (blockIdx.x * (kHistThreads / 32) + (threadIdx.x >> 5)) * 32; base < n;
       base += warps * 32) {
    const int i = base + lane;
    const int b = i < n ? histc_bin(x[i], mn, mx, width, degenerate, bins) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (b >= 0 && lane == __ffs(peers) - 1) atomicAdd(&cnt[b], (unsigned)__popc(peers));
  }
  __syncthreads();
  for (int j = threadIdx.x; j < bins; j += kHistThreads)
    if (cnt[j]) atomicAdd(&counts[j], cnt[j]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the batch's counts as f32 (a scatter-add of ones saturates at 2^24)
  for (int j = threadIdx.x; j < bins; j += kHistThreads)
    cnt[j] = min(__ldcg(&counts[j]), 16777216u);
  const bool first = *seen == 0;
  if (first) {
    __syncthreads();
    for (int j = threadIdx.x; j < bins; j += kHistThreads) out[j] = (float)cnt[j];
    return;
  }
  const float omin = *omin_p, omax = *omax_p;
  if (mn == omin && mx == omax) {  // the range did not move
    for (int j = threadIdx.x; j < bins; j += kHistThreads)
      out[j] = __fadd_rn((float)cnt[j], hist[j]);
    return;
  }
  if (omin == omax) {  // degenerate old range: all its mass at omin
    float t = 0.f;  // the old histogram's sum: a fixed tree
    for (int j = threadIdx.x; j < bins; j += kHistThreads) t = __fadd_rn(t, hist[j]);
    t = warp_tree(t);
    if (lane == 0) wsum[threadIdx.x >> 5] = t;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int w = 0; w < kHistThreads / 32; ++w) s = __fadd_rn(s, wsum[w]);
      wsum[0] = s;
    }
    __syncthreads();
    const float total = wsum[0];
    const int ob = histc_bin(omin, mn, mx, width, degenerate, bins);
    for (int j = threadIdx.x; j < bins; j += kHistThreads)
      out[j] = __fadd_rn((float)cnt[j], __fmul_rn(j == ob ? 1.f : 0.f, total));
    return;
  }
  // _upscale: fine bin k of K = bins * u over [omin, omax] has mass
  // hist[k / u] / u and mid-point linspace(omin, omax, K + 1)[k] + bin_size / 2;
  // it goes to searchsorted(boundaries, mid, 'right') - 1, clipped
  const int K = bins * u;
  const float half = __fmul_rn(0.5f, __fdiv_rn(__fsub_rn(omax, omin), (float)K));
  for (int j = threadIdx.x; j <= bins; j += kHistThreads)
    bnd[j] = linspace_at(mn, mx, j, bins + 1);
  if (threadIdx.x == 0) mono = true;
  __syncthreads();
  auto dest = [&](int k) {
    const float mid = __fadd_rn(linspace_at(omin, omax, k, K + 1), half);
    int lo = 0, hi = bins + 1;  // the count of boundaries <= mid
    while (lo < hi) {
      const int m = (lo + hi) >> 1;
      if (bnd[m] <= mid) lo = m + 1; else hi = m;
    }
    return min(max(lo - 1, 0), bins - 1);
  };
  bool ok = true;
  for (int k = threadIdx.x; k + 1 < K; k += kHistThreads) ok &= dest(k) <= dest(k + 1);
  if (!ok) mono = false;
  __syncthreads();
  const float uf = (float)u;
  if (mono) {
    // run[j]: the first fine bin whose destination is >= j
    for (int j = threadIdx.x; j <= bins; j += kHistThreads) {
      int lo = 0, hi = K;
      while (lo < hi) {
        const int m = (lo + hi) >> 1;
        if (dest(m) < j) lo = m + 1; else hi = m;
      }
      run[j] = lo;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < bins; j += kHistThreads) {
      float s = 0.f;
      const int end = j == bins - 1 ? K : run[j + 1];
      for (int k = run[j]; k < end; ++k) s = __fadd_rn(s, __fdiv_rn(hist[k / u], uf));
      out[j] = __fadd_rn((float)cnt[j], s);
    }
    return;
  }
  __shared__ float racc[kMaxBins];
  for (int j = threadIdx.x; j < bins; j += kHistThreads) racc[j] = 0.f;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < K; ++k) {
      const int d = dest(k);
      racc[d] = __fadd_rn(racc[d], __fdiv_rn(hist[k / u], uf));
    }
  __syncthreads();
  for (int j = threadIdx.x; j < bins; j += kHistThreads)
    out[j] = __fadd_rn((float)cnt[j], racc[j]);
}

// ------------------------------------------------------------------ K3

// The first i of csum[0..n) with csum[i] >= v (side 'left') or > v ('right').
__device__ __forceinline__ int search(const float* csum, int n, float v, bool right) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    const bool before = right ? csum[m] <= v : csum[m] < v;
    if (before) lo = m + 1; else hi = m;
  }
  return lo;
}

// norm(b, e) = density (e^3 - b^3) / 3
__device__ __forceinline__ float l2_norm(float density, float b, float e) {
  const float e3 = __fmul_rn(__fmul_rn(e, e), e);
  const float b3 = __fmul_rn(__fmul_rn(b, b), b);
  return __fdiv_rn(__fmul_rn(density, __fsub_rn(e3, b3)), 3.f);
}

// Bin i's term of _quant_error for the range [start, end] of bins.
__device__ __forceinline__ float quant_term(const float* hist, int i, float bin_width,
                                            float safe_dst, float start_f, float dst_nbins,
                                            float width_nz) {
  const float begin = __fmul_rn(__fsub_rn((float)i, start_f), bin_width);
  const float end = __fadd_rn(begin, bin_width);
  const float dmax = __fsub_rn(dst_nbins, 1.f);
  const float dob = fminf(fmaxf(floorf(__fdiv_rn(begin, safe_dst)), 0.f), dmax);
  const float doe = fminf(fmaxf(floorf(__fdiv_rn(end, safe_dst)), 0.f), dmax);
  const float density = __fdiv_rn(hist[i], width_nz);
  const float half = __fdiv_rn(safe_dst, 2.f);
  const float nhalf = __fdiv_rn(-safe_dst, 2.f);
  const float begin_center = __fmul_rn(__fadd_rn(dob, 0.5f), safe_dst);
  float total = l2_norm(density, __fsub_rn(begin, begin_center), half);
  total = __fadd_rn(total, __fmul_rn(__fsub_rn(__fsub_rn(doe, dob), 1.f),
                                     l2_norm(density, nhalf, half)));
  const float end_center = __fadd_rn(__fmul_rn(doe, safe_dst), half);
  return __fadd_rn(total, l2_norm(density, nhalf, __fsub_rn(end, end_center)));
}

__global__ void __launch_bounds__(kSearchThreads)
hist_search_kernel(const float* __restrict__ hist_g, const float* __restrict__ min_p,
                   const float* __restrict__ max_p, const bool* __restrict__ gate,
                   float* __restrict__ out, int* __restrict__ iters, int bins,
                   float dst_nbins) {
  if (gate_off(gate)) return;
  __shared__ float hist[kMaxBins], csum[kMaxBins];
  __shared__ float wsum[kSearchThreads / 32];
  __shared__ int s_start, s_end, s_finished;
  for (int i = threadIdx.x; i < bins; i += kSearchThreads) hist[i] = hist_g[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    double a = 0.0;
    for (int i = 0; i < bins; ++i) {
      a += (double)hist[i];
      csum[i] = (float)a;
    }
  }
  __syncthreads();
  const float omin = *min_p;
  const float bin_width = __fdiv_rn(__fsub_rn(*max_p, omin), (float)bins);
  const float width_nz = bin_width == 0.f ? 1.f : bin_width;
  const float total = csum[bins - 1];
  const float step = 1e-5f;
  // thread 0's loop state
  float alpha = 0.f, beta = 1.f, norm_min = INFINITY;
  int start = 0, end = bins - 1, trips = 0, scored = 0;
  bool done = !(total > 0.f);  // an empty histogram never moves the range
  while (true) {
    int n_start = start, n_end = end;
    if (threadIdx.x == 0) {
      bool moved = false;
      while (alpha < beta && !done) {
        ++trips;
        const float next_alpha = __fadd_rn(alpha, step);
        const float next_beta = __fsub_rn(beta, step);
        int left = search(csum, bins, __fmul_rn(next_alpha, total), false);
        int right = search(csum, bins, __fmul_rn(next_beta, total), true) - 1;
        left = min(max(left, start), end);
        right = min(max(right, start), end);
        const bool move_start = (left - start) > (end - right);
        n_start = move_start ? left : start;
        n_end = move_start ? end : right;
        if (move_start) alpha = next_alpha; else beta = next_beta;
        if (n_start != start || n_end != end) {
          moved = true;
          break;
        }
      }
      s_start = n_start;
      s_end = n_end;
      s_finished = !moved;
    }
    __syncthreads();
    if (s_finished) break;
    n_start = s_start;
    n_end = s_end;
    const float dst_w = __fdiv_rn(__fmul_rn(bin_width, (float)(n_end - n_start + 1)), dst_nbins);
    const float safe_dst = dst_w == 0.f ? 1.f : dst_w;
    const float start_f = (float)n_start;
    const int i0 = 2 * threadIdx.x;
    const float t0 = i0 < bins ? quant_term(hist, i0, bin_width, safe_dst, start_f,
                                            dst_nbins, width_nz) : 0.f;
    const float t1 = i0 + 1 < bins ? quant_term(hist, i0 + 1, bin_width, safe_dst,
                                                start_f, dst_nbins, width_nz) : 0.f;
    const float t = warp_pairs(__fadd_rn(t0, t1));
    if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = t;
    __syncthreads();
    if (threadIdx.x < 32) {
      const float w = warp_pairs(wsum[threadIdx.x]);
      if (threadIdx.x == 0) {
        ++scored;
        const float nrm = dst_w == 0.f ? 0.f : w;
        if (nrm > norm_min) {
          done = true;
        } else {
          start = n_start;
          end = n_end;
          norm_min = nrm;
        }
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = __fadd_rn(omin, __fmul_rn(bin_width, (float)start));
    out[1] = __fadd_rn(omin, __fmul_rn(bin_width, __fadd_rn((float)end, 1.f)));
    if (iters != nullptr) {
      iters[0] = trips;
      iters[1] = scored;
    }
  }
}

}  // namespace

extern "C" {

// K1: x is the (outer, C, inner) view (n = outer * inner elements a
// channel), bmin/bmax (C,), part (C * bpc * 64) floats, tickets (C,) zeros;
// out_min/out_max (C,); errs (C, 64) and best (C,) may be null.
int jlt_mse_range(const void* x, const void* bmin, const void* bmax, const void* gate,
                  void* part, void* tickets, void* out_min, void* out_max, void* errs,
                  void* best, int C, int inner, int n, int bpc, int chunk, float qmin,
                  float qmax, int sym, float zp_sym, void* stream) {
  QRange q{qmin, qmax, qmax - qmin, (qmax - qmin) / 2.f, zp_sym, sym,
           fabsf(qmin) <= 1000.f && fabsf(qmax) <= 1000.f};
  mse_range_kernel<<<C * bpc, kMseThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)bmin, (const float*)bmax, (const bool*)gate,
      (float*)part, (unsigned*)tickets, (float*)out_min, (float*)out_max, (float*)errs,
      (int*)best, C, inner, n, bpc, chunk, q);
  return (int)cudaGetLastError();
}

// K2: x (n,), hist (bins,) the old histogram over [omin, omax], the new
// range nmin/nmax (1,), seen () int32; work (bins + 1) zeros; out (bins,).
int jlt_hist_update(const void* x, int n, const void* hist, const void* omin,
                    const void* omax, const void* nmin, const void* nmax, const void* seen,
                    const void* gate, void* work, void* out, int bins, int u, int blocks,
                    void* stream) {
  if (bins > kMaxBins || bins < 1 || u < 1) return (int)cudaErrorInvalidValue;
  hist_update_kernel<<<blocks, kHistThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, n, (const float*)hist, (const float*)omin, (const float*)omax,
      (const float*)nmin, (const float*)nmax, (const int*)seen, (const bool*)gate,
      (unsigned*)work, (float*)out, bins, u);
  return (int)cudaGetLastError();
}

// K3: hist (bins,) over [min, max] (1,) each; out (2,) the chosen (min, max);
// iters (2,) int32 the loop's trips and the trips that scored a range, or
// null.
int jlt_hist_search(const void* hist, const void* min_val, const void* max_val,
                    const void* gate, void* out, void* iters, int bins, int dst_nbins,
                    void* stream) {
  if (bins > kMaxBins || bins < 1) return (int)cudaErrorInvalidValue;
  hist_search_kernel<<<1, kSearchThreads, 0, (cudaStream_t)stream>>>(
      (const float*)hist, (const float*)min_val, (const float*)max_val, (const bool*)gate,
      (float*)out, (int*)iters, bins, (float)dst_nbins);
  return (int)cudaGetLastError();
}

// The largest histogram the kernels take.
int jlt_hist_max_bins() { return kMaxBins; }

}  // extern "C"
