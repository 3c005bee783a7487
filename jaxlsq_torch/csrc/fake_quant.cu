// LSQ/LSQ+ fake quantization, forward and backward, f32.
//
//   s   = max(|scale[c]|, FLT_EPSILON)
//   zp  = rint(clamp(-shift[c] / s, tmin, tmax))
//   fwd = (rint(clamp(x / s + zp, qmin, qmax)) - zp) * s
//   bwd: xq = clamp(x / s + zp, qmin, qmax) (unrounded), m = qmin < xq < qmax,
//        dX = g * m (train and eval; init mode writes no dX),
//        geff = init ? 2 (xfq - x) : g,
//        dS = gs * sum(m ? geff (xfq - x) / s : geff ((xq <= qmin ? qmin : qmax) - zp)),
//        dB = gs * sum(m ? 0 : geff) (0 for a symmetric spec); eval writes neither.
// c is the channel: 0 per tensor, (i / inner) % C per channel over the
// tensor's (outer, C, inner) view, so no transpose copy is made.
//
// Each kernel comes in two regimes, one template parameter apart:
// * static (kTraced = false): eval/init are launch arguments chosen on the
//   host.  Replaces the TPU kernels of jaxlsq/ops/pallas_kernels.py:
//   fq_fwd_pt _pt_fwd_kernel (:195), fq_fwd_pc _pc_fwd_kernel (:268),
//   fq_bwd_pt _pt_bwd_kernel (:202) and fq_bwd_pc _pc_bwd_kernel (:275).
// * traced (kTraced = true): the modes are read inside the kernel from a
//   (2,) f32 device tensor flags = [ev, ini], so one captured CUDA graph
//   serves every QAT phase.  The forward writes ini > 0 ? x : fq(x) (a copy
//   in init mode); the backward always writes dX (g in init mode, g * m
//   otherwise) and its partials, and the sum kernel scales by (1 - ev) * gs
//   after the block-ordered sum.  The flags never decide the grid or the
//   partials' size.  Replaces fq_fwd_pt_traced _pt_fwd_traced_kernel (:680),
//   fq_fwd_pc_traced _pc_fwd_traced_kernel (:725), fq_bwd_pt_traced
//   _pt_bwd_traced_kernel (:689) and fq_bwd_pc_traced _pc_bwd_traced_kernel
//   (:734).  In train mode (1 - 0) * gs is gs exactly, so dS and dB have the
//   static kernels' bits.
//
// Numerics: the golden functions (jaxlsq_torch/core/golden.py) run each step
// as its own rounded f32 operation, so every product and sum here is an
// explicit _rn intrinsic (nvcc may not contract them into an FMA), the
// divisions are IEEE (no fast math), and rintf rounds half to even as
// torch.round does.  The forward and dX are therefore bit-exact; dS and dB
// differ from a torch.sum only in summation order.  The qparams are read from
// device memory: no host sync.
//
// What bounds it on an H100: a few operations per 4-byte element, far below
// the card's operations per byte, so each kernel is bound by its bytes: the
// forward reads x and writes out (8 B an element), the training backward
// reads g and x and writes dX (12 B), the fused pair 16 B; the traced kernels
// move the same bytes in every mode.  The TPU kernels carry dS/dB in an
// accumulator resident across their sequential grid; Hopper blocks run in
// parallel, so each block writes a partial and a second small kernel sums the
// partials in block order and applies the gradient scale after the sum, as
// golden does.  The grids depend on the shape alone (never on the SM count),
// so an input gives the same bits on every run.
//
// Per channel, a backward block owns one channel and a 2048-element chunk of
// it, walked by its threads in the contiguous inner runs (an OIHW weight on
// axis 0 is one run per channel; a (K, N) kernel on axis 1 has runs of one
// element, read with a stride of C), and writes one (chunk, C) partial.
//
// The fused forward + backward (kOut = true, train mode only): the static
// backward kernels with one more output, out = (rint(xq) - zp) * s, which the
// backward computes for dS anyway (dequant() below, the forward's own op
// sequence).  One pass reads g and x and writes out and dX (16 B an element
// against the split pair's 20); the grid and the partials are the static
// backward's, so out has fq_fwd_*'s bits and dX, dS, dB have fq_bwd_*'s.
// Replaces fq_fwdbwd_pt _pt_fwdbwd (:607, launching _pt_bwd_kernel with
// emit_out) and fq_fwdbwd_pc _pc_fwdbwd (:639, _pc_bwd_kernel with emit_out)
// of jaxlsq/ops/pallas_kernels.py.
#include <cuda_runtime.h>
#include <algorithm>
#include <cfloat>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPtItems = 8;        // elements a thread takes per block, per tensor
constexpr int kPtMaxBlocks = 1024; // per-tensor backward partials
constexpr int kPcChunk = 2048;     // elements of one channel a block takes
constexpr int kFwdMaxBlocks = 4096;

struct Range {
  float qmin, qmax, tmin, tmax;
};

__device__ __forceinline__ void load_qparams(const float* __restrict__ scale,
                                             const float* __restrict__ shift,
                                             int c, const Range& r, float& s,
                                             float& zp) {
  s = fmaxf(fabsf(scale[c]), FLT_EPSILON);
  zp = rintf(fminf(fmaxf(__fdiv_rn(-shift[c], s), r.tmin), r.tmax));
}

// xq = clamp(x / s + zp, qmin, qmax), unrounded.
__device__ __forceinline__ float clamped(float x, float s, float zp, const Range& r) {
  return fminf(fmaxf(__fadd_rn(__fdiv_rn(x, s), zp), r.qmin), r.qmax);
}

// The fake-quantized value (rint(xq) - zp) * s of a clamped xq.
__device__ __forceinline__ float dequant(float xq, float s, float zp) {
  return __fmul_rn(__fsub_rn(rintf(xq), zp), s);
}

__device__ __forceinline__ float fq_value(float x, float s, float zp, const Range& r) {
  return dequant(clamped(x, s, zp, r), s, zp);
}

// One element of the backward: adds its dS/dB terms to the thread's sums
// (static: unless eval) and writes dX (static: unless init; traced: always,
// g itself in init mode) and, fused (kOut), the forward's out.
template <bool kTraced, bool kOut>
__device__ __forceinline__ void bwd_elem(const float* __restrict__ g,
                                         const float* __restrict__ x,
                                         float* __restrict__ dx,
                                         float* __restrict__ out, int i, float s,
                                         float zp, const Range& r, int sym,
                                         int eval_mode, int init_mode, float& ds,
                                         float& db) {
  const float xv = x[i];
  const float gv = (init_mode && !kTraced) ? 0.f : g[i];
  const float xq = clamped(xv, s, zp, r);
  const bool in = (r.qmin < xq) && (xq < r.qmax);
  const float xfq = dequant(xq, s, zp);
  if (kOut) out[i] = xfq;
  if (kTraced)
    dx[i] = init_mode ? gv : __fmul_rn(gv, in ? 1.f : 0.f);
  else if (!init_mode)
    dx[i] = __fmul_rn(gv, in ? 1.f : 0.f);
  if (eval_mode) return;
  const float d = __fsub_rn(xfq, xv);
  const float geff = init_mode ? __fmul_rn(2.f, d) : gv;
  float dse;
  if (in)
    dse = __fdiv_rn(__fmul_rn(geff, d), s);
  else
    dse = __fmul_rn(geff, __fsub_rn(xq <= r.qmin ? r.qmin : r.qmax, zp));
  ds = __fadd_rn(ds, dse);
  if (!sym && !in) db = __fadd_rn(db, geff);
}

// Fixed-order tree sum of one value per thread; the result is in red[0].
__device__ __forceinline__ void block_sum(float* red, float v) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + off]);
    __syncthreads();
  }
}

// The modes a traced kernel reads from flags = [ev, ini] on the device.
__device__ __forceinline__ int flag_set(const float* __restrict__ flags, int k) {
  return flags[k] > 0.f;
}

// Forward; traced: init mode copies x.
template <bool kTraced>
__global__ void __launch_bounds__(kThreads)
fq_fwd_kernel(const float* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ shift, const float* __restrict__ flags,
              float* __restrict__ out, int n, int C, int inner, Range r) {
  const int stride = gridDim.x * kThreads;
  const int ini = kTraced ? flag_set(flags, 1) : 0;
  if (C == 1) {
    float s, zp;
    load_qparams(scale, shift, 0, r, s, zp);
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride)
      out[i] = ini ? x[i] : fq_value(x[i], s, zp, r);
    return;
  }
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    float s, zp;
    load_qparams(scale, shift, (i / inner) % C, r, s, zp);
    out[i] = ini ? x[i] : fq_value(x[i], s, zp, r);
  }
}

// Per tensor: block b writes part[b] (dS) and part[nblocks + b] (dB).
// Traced: init_mode comes from flags and eval_mode is 0 (ev acts in the sum).
template <bool kTraced, bool kOut>
__global__ void __launch_bounds__(kThreads)
fq_bwd_pt_kernel(const float* __restrict__ g, const float* __restrict__ x,
                 const float* __restrict__ scale, const float* __restrict__ shift,
                 const float* __restrict__ flags, float* __restrict__ dx,
                 float* __restrict__ out, float* __restrict__ part, int n, Range r,
                 int sym, int eval_mode, int init_mode) {
  __shared__ float red[kThreads];
  if (kTraced) {
    eval_mode = 0;
    init_mode = flag_set(flags, 1);
  }
  float s, zp;
  load_qparams(scale, shift, 0, r, s, zp);
  float ds = 0.f, db = 0.f;
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride)
    bwd_elem<kTraced, kOut>(g, x, dx, out, i, s, zp, r, sym, eval_mode, init_mode,
                            ds, db);
  if (eval_mode) return;
  block_sum(red, ds);
  if (threadIdx.x == 0) part[blockIdx.x] = red[0];
  __syncthreads();
  block_sum(red, db);
  if (threadIdx.x == 0) part[gridDim.x + blockIdx.x] = red[0];
}

// Per channel: block b owns channel b / n_chunks, chunk b % n_chunks; writes
// part[chunk * C + c] (dS) and part[(n_chunks + chunk) * C + c] (dB).
template <bool kTraced, bool kOut>
__global__ void __launch_bounds__(kThreads)
fq_bwd_pc_kernel(const float* __restrict__ g, const float* __restrict__ x,
                 const float* __restrict__ scale, const float* __restrict__ shift,
                 const float* __restrict__ flags, float* __restrict__ dx,
                 float* __restrict__ out, float* __restrict__ part, int outer,
                 int C, int inner,
                 int n_chunks, Range r, int sym, int eval_mode, int init_mode) {
  __shared__ float red[kThreads];
  if (kTraced) {
    eval_mode = 0;
    init_mode = flag_set(flags, 1);
  }
  const int c = blockIdx.x / n_chunks, chunk = blockIdx.x % n_chunks;
  float s, zp;
  load_qparams(scale, shift, c, r, s, zp);
  const int m = outer * inner;
  const int t1 = min(m, (chunk + 1) * kPcChunk);
  float ds = 0.f, db = 0.f;
  for (int t = chunk * kPcChunk + threadIdx.x; t < t1; t += kThreads) {
    const int o = t / inner;
    const int i = (o * C + c) * inner + (t - o * inner);
    bwd_elem<kTraced, kOut>(g, x, dx, out, i, s, zp, r, sym, eval_mode,
                            init_mode, ds, db);
  }
  if (eval_mode) return;
  block_sum(red, ds);
  if (threadIdx.x == 0) part[chunk * C + c] = red[0];
  __syncthreads();
  block_sum(red, db);
  if (threadIdx.x == 0) part[(n_chunks + chunk) * C + c] = red[0];
}

// Sum the (n_parts, C) partials of dS and of dB in part order, then * gs
// (traced: * (1 - ev) * gs, with ev read from flags on the device).
// Per tensor (C == 1) one block sums; per channel one thread per channel.
__global__ void __launch_bounds__(kThreads)
fq_bwd_sum_kernel(const float* __restrict__ part, int n_parts, int C, float gs,
                  const float* __restrict__ flags, float* __restrict__ ds,
                  float* __restrict__ db) {
  if (flags) gs = __fmul_rn(__fsub_rn(1.f, flags[0]), gs);
  if (C == 1) {
    __shared__ float red[kThreads];
    for (int which = 0; which < 2; ++which) {
      const float* p = part + which * n_parts;
      float a = 0.f;
      for (int k = threadIdx.x; k < n_parts; k += kThreads) a = __fadd_rn(a, p[k]);
      block_sum(red, a);
      if (threadIdx.x == 0) (which ? db : ds)[0] = __fmul_rn(red[0], gs);
      __syncthreads();
    }
    return;
  }
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, b = 0.f;
  for (int k = 0; k < n_parts; ++k) {
    a = __fadd_rn(a, part[k * C + c]);
    b = __fadd_rn(b, part[(n_parts + k) * C + c]);
  }
  ds[c] = __fmul_rn(a, gs);
  db[c] = __fmul_rn(b, gs);
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

int pt_blocks(int n) { return std::min(kPtMaxBlocks, std::max(1, cdiv(n, kThreads * kPtItems))); }

// Chunks per channel of the per-channel backward.
int pc_chunks(int outer, int inner) { return std::max(1, cdiv(outer * inner, kPcChunk)); }

int fwd_blocks(int n) { return std::min(kFwdMaxBlocks, std::max(1, cdiv(n, kThreads))); }

template <bool kTraced>
int launch_fwd(const void* x, const void* scale, const void* shift,
               const void* flags, void* out, int outer, int C, int inner,
               const Range& r, void* stream) {
  const int n = outer * C * inner;
  fq_fwd_kernel<kTraced><<<fwd_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)scale, (const float*)shift,
      (const float*)flags, (float*)out, n, C, inner, r);
  return (int)cudaGetLastError();
}

// Static: no partials and no sum in eval mode.  Traced: always both.
// kOut (static train mode): out is written too.
template <bool kTraced, bool kOut = false>
int launch_bwd_pt(const void* g, const void* x, const void* scale,
                  const void* shift, const void* flags, void* dx, void* part,
                  void* ds, void* db, int n, const Range& r, int sym,
                  int eval_mode, int init_mode, float gs, void* stream,
                  void* out = nullptr) {
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = pt_blocks(n);
  fq_bwd_pt_kernel<kTraced, kOut><<<blocks, kThreads, 0, st>>>(
      (const float*)g, (const float*)x, (const float*)scale, (const float*)shift,
      (const float*)flags, (float*)dx, (float*)out, (float*)part, n, r, sym,
      eval_mode, init_mode);
  if (kTraced || !eval_mode)
    fq_bwd_sum_kernel<<<1, kThreads, 0, st>>>((const float*)part, blocks, 1, gs,
                                              (const float*)flags, (float*)ds,
                                              (float*)db);
  return (int)cudaGetLastError();
}

template <bool kTraced, bool kOut = false>
int launch_bwd_pc(const void* g, const void* x, const void* scale,
                  const void* shift, const void* flags, void* dx, void* part,
                  void* ds, void* db, int outer, int C, int inner, const Range& r,
                  int sym, int eval_mode, int init_mode, float gs, void* stream,
                  void* out = nullptr) {
  cudaStream_t st = (cudaStream_t)stream;
  const int chunks = pc_chunks(outer, inner);
  fq_bwd_pc_kernel<kTraced, kOut><<<C * chunks, kThreads, 0, st>>>(
      (const float*)g, (const float*)x, (const float*)scale, (const float*)shift,
      (const float*)flags, (float*)dx, (float*)out, (float*)part, outer, C, inner,
      chunks, r, sym, eval_mode, init_mode);
  if (kTraced || !eval_mode)
    fq_bwd_sum_kernel<<<cdiv(C, kThreads), kThreads, 0, st>>>(
        (const float*)part, chunks, C, gs, (const float*)flags, (float*)ds,
        (float*)db);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of partials the backward needs: 2 * jlt_fq_partials(...).
int jlt_fq_partials(int outer, int C, int inner, int per_channel) {
  if (!per_channel) return pt_blocks(outer * C * inner);
  return pc_chunks(outer, inner) * C;
}

// Forward per tensor (scale, shift are (1,)).  Returns cudaGetLastError().
int jlt_fq_fwd_pt(const void* x, const void* scale, const void* shift, void* out,
                  int n, float qmin, float qmax, float tmin, float tmax,
                  void* stream) {
  return launch_fwd<false>(x, scale, shift, nullptr, out, 1, 1, n,
                           Range{qmin, qmax, tmin, tmax}, stream);
}

// Forward per channel over the (outer, C, inner) view; scale, shift are (C,).
int jlt_fq_fwd_pc(const void* x, const void* scale, const void* shift, void* out,
                  int outer, int C, int inner, float qmin, float qmax, float tmin,
                  float tmax, void* stream) {
  return launch_fwd<false>(x, scale, shift, nullptr, out, outer, C, inner,
                           Range{qmin, qmax, tmin, tmax}, stream);
}

// Backward per tensor.  part holds 2 * jlt_fq_partials floats; ds, db are
// (1,).  dx is not written in init mode, part/ds/db not in eval mode.
int jlt_fq_bwd_pt(const void* g, const void* x, const void* scale,
                  const void* shift, void* dx, void* part, void* ds, void* db,
                  int n, float qmin, float qmax, float tmin, float tmax, int sym,
                  int eval_mode, int init_mode, float gs, void* stream) {
  return launch_bwd_pt<false>(g, x, scale, shift, nullptr, dx, part, ds, db, n,
                              Range{qmin, qmax, tmin, tmax}, sym, eval_mode,
                              init_mode, gs, stream);
}

// Backward per channel over the (outer, C, inner) view; ds, db are (C,).
int jlt_fq_bwd_pc(const void* g, const void* x, const void* scale,
                  const void* shift, void* dx, void* part, void* ds, void* db,
                  int outer, int C, int inner, float qmin, float qmax, float tmin,
                  float tmax, int sym, int eval_mode, int init_mode, float gs,
                  void* stream) {
  return launch_bwd_pc<false>(g, x, scale, shift, nullptr, dx, part, ds, db,
                              outer, C, inner, Range{qmin, qmax, tmin, tmax}, sym,
                              eval_mode, init_mode, gs, stream);
}

// Fused forward + backward, train mode: out and dx are (n,) like x; part,
// ds, db as for jlt_fq_bwd_pt.
int jlt_fq_fwdbwd_pt(const void* g, const void* x, const void* scale,
                     const void* shift, void* out, void* dx, void* part, void* ds,
                     void* db, int n, float qmin, float qmax, float tmin,
                     float tmax, int sym, float gs, void* stream) {
  return launch_bwd_pt<false, true>(g, x, scale, shift, nullptr, dx, part, ds, db,
                                    n, Range{qmin, qmax, tmin, tmax}, sym, 0, 0,
                                    gs, stream, out);
}

// Fused forward + backward per channel over the (outer, C, inner) view.
int jlt_fq_fwdbwd_pc(const void* g, const void* x, const void* scale,
                     const void* shift, void* out, void* dx, void* part, void* ds,
                     void* db, int outer, int C, int inner, float qmin, float qmax,
                     float tmin, float tmax, int sym, float gs, void* stream) {
  return launch_bwd_pc<false, true>(g, x, scale, shift, nullptr, dx, part, ds, db,
                                    outer, C, inner, Range{qmin, qmax, tmin, tmax},
                                    sym, 0, 0, gs, stream, out);
}

// The traced twins: flags is a (2,) f32 device tensor [ev, ini]; every
// output (out; dx, part, ds, db) is written in every mode.
int jlt_fq_fwd_pt_traced(const void* x, const void* scale, const void* shift,
                         const void* flags, void* out, int n, float qmin,
                         float qmax, float tmin, float tmax, void* stream) {
  return launch_fwd<true>(x, scale, shift, flags, out, 1, 1, n,
                          Range{qmin, qmax, tmin, tmax}, stream);
}

int jlt_fq_fwd_pc_traced(const void* x, const void* scale, const void* shift,
                         const void* flags, void* out, int outer, int C,
                         int inner, float qmin, float qmax, float tmin,
                         float tmax, void* stream) {
  return launch_fwd<true>(x, scale, shift, flags, out, outer, C, inner,
                          Range{qmin, qmax, tmin, tmax}, stream);
}

int jlt_fq_bwd_pt_traced(const void* g, const void* x, const void* scale,
                         const void* shift, const void* flags, void* dx,
                         void* part, void* ds, void* db, int n, float qmin,
                         float qmax, float tmin, float tmax, int sym, float gs,
                         void* stream) {
  return launch_bwd_pt<true>(g, x, scale, shift, flags, dx, part, ds, db, n,
                             Range{qmin, qmax, tmin, tmax}, sym, 0, 0, gs, stream);
}

int jlt_fq_bwd_pc_traced(const void* g, const void* x, const void* scale,
                         const void* shift, const void* flags, void* dx,
                         void* part, void* ds, void* db, int outer, int C,
                         int inner, float qmin, float qmax, float tmin,
                         float tmax, int sym, float gs, void* stream) {
  return launch_bwd_pc<true>(g, x, scale, shift, flags, dx, part, ds, db, outer,
                             C, inner, Range{qmin, qmax, tmin, tmax}, sym, 0, 0,
                             gs, stream);
}

}  // extern "C"
