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
//   otherwise) and dS/dB, scaled by (1 - ev) * gs after the sum.  The flags
//   never decide the grid or the order.  Replaces fq_fwd_pt_traced
//   _pt_fwd_traced_kernel (:680), fq_fwd_pc_traced _pc_fwd_traced_kernel
//   (:725), fq_bwd_pt_traced _pt_bwd_traced_kernel (:689) and
//   fq_bwd_pc_traced _pc_bwd_traced_kernel (:734).  In train mode (1 - 0) *
//   gs is gs exactly, so dS and dB have the static kernels' bits.
//
// Numerics: the golden functions (jaxlsq_torch/core/golden.py) run each step
// as its own rounded f32 operation, so every product and sum here is an
// explicit _rn intrinsic (nvcc may not contract them into an FMA), the
// divisions are IEEE (no fast math), and rintf rounds half to even as
// torch.round does.  The forward and dX are therefore bit-exact; dS and dB
// differ from a torch.sum only in summation order.  The qparams are read from
// device memory: no host sync.  The three clamps (s, zp, xq) pass a NaN
// through, as torch.clamp and jnp.clip do (max.NaN/min.NaN below; fminf/
// fmaxf would turn it into a bound): a NaN x gives a NaN out, takes the qmax
// branch of dS (xq <= qmin is false) and no dX; a NaN scale or shift makes
// its channel's out and dS NaN.  A sum carries NaN and inf in any order.
//
// What bounds it on an H100: a few operations per 4-byte element, far below
// the card's operations per byte, so each kernel is bound by its bytes: the
// forward reads x and writes out (8 B an element), the training backward
// reads g and x and writes dX (12 B), the fused pair 16 B; the traced kernels
// move the same bytes in every mode.  The TPU kernels carry dS/dB in an
// accumulator resident across their sequential grid; Hopper blocks run in
// parallel.  Every grid and summation order depends on the shape alone (never
// on the SM count or the load width), so an input gives the same bits on
// every run, and the gradient scale is applied after the sum, as golden does.
//
// Per tensor the backward is one launch with no workspace.  x is cut into
// tiles of kPtTile = 2,048 elements; B = tiles / 4 blocks, within [512,
// 2048] and at most one a tile (pt_blocks), block b taking tiles b, b + B,
// ... in turn.  In a tile, lane t of the block's 256 takes the groups of 4
// elements at 4 (256 j + t), j = 0, 1 (a warp reads 512 contiguous bytes a
// group).  The groups reach shared memory by cp.async, a ring of 2 slots a
// lane, each refilled with the block's next tile once computed, so the
// bytes in flight hold no registers and run across tiles; the qparams are
// read while the first copies fly, and dX (and out) are stored with
// evict-first hints.  (Measured on the H100, PERF.md §6: staging in
// registers, 4 groups a lane, held 60-80 registers and took 26.5 us at 4 Mi
// elements; 4-group tiles or a flat 1,024 or 2,048 blocks 22-24 us; a flat
// 512 blocks made the 64 Mi chain slower.)  A lane sums its elements in
// ascending index from +0; then the shuffle tree over the warp's 32 lanes
// (v[l] += v[l + h], h = 16 .. 1) and tree8 over the block's 8 warps give
// block b's partial.  The block stores its (dS, dB) pair in a slot, then
// draws a ticket: an acquire-release atomicInc on the slot's counter (a
// fence before and after a plain one took 0.5 us more a call), which wraps
// the counter to 0 at the last ticket, ready for the next call.  The block
// that draws the last ticket folds the B partials: thread t takes partials
// t + 256 q, q = 0 .. 7 (+0 past B), by the pairwise tree over q (v[q] +=
// v[q + h], h = 4, 2, 1), then the shuffle tree over a warp's lanes and
// tree8 over the warps.  No float atomics: the bits do not depend on which
// block comes last.  16-byte copies and stores where g, x, dX (and out) are
// 16-byte aligned, else 4-byte ones: only how a group is read changes, never
// which lane sums which element in which order.  Static eval mode writes dX
// only: no partials, no ticket.
// Calls in flight at once: the slots (a counter and 2 x kPtMaxBlocks floats
// each) are this library's zero-initialised __device__ memory, so a call
// allocates and clears nothing.  Calls queued on one stream run one after
// another and share that stream's slot; the wrapper gives every stream of a
// device its own slot (ops/fake_quant.py _pt_slot, at most kPtSlots streams,
// then it raises), so calls on two streams never share one.  A captured CUDA
// graph keeps the slot of the stream it was captured on and runs its calls in
// order on every replay; so a replay must not overlap another replay of a
// graph captured on that stream, or an eager call queued on it.
//
// Per channel the backward is one launch with no workspace.  The plan
// (warps, cluster) comes from the shape alone (ops/fake_quant.py pc_plan)
// and fixes the order; how wide a load is (16 B where the layout and the
// pointers allow, else 4 B) never changes it.  Two mappings, by the view
// (outer, C, inner):
// * runs (inner > 1: an OIHW weight on axis 0, an NCHW tensor on axis 1): a
//   channel's m = outer * inner elements in walk order t (o, then the run)
//   are cut into groups of 4, t = 4u .. 4u + 3 (the last may be short).
//   Either `warps` warps of one block take a channel (8 / warps channels a
//   block), or 8 warps of each of `cluster` blocks of a thread-block cluster
//   do (rank k's warp w is warp 8k + w).  Lane G = 32 * warp + lane of P
//   lanes takes the groups u = G, G + P, G + 2P, ...; it sums their
//   elements in ascending t from +0, 2 groups in flight (4 took more
//   registers, fewer blocks fit an SM, and measured slower).  Then the warp's
//   32 lane sums by the shuffle tree (v[l] += v[l + h], h = 16 .. 1), the
//   warps of a block by the same pairwise tree (h = 4, 2, 1), the blocks of
//   a cluster by it too, rank 0 reading the others' shared memory.
// * rows (inner = 1: a (K, N) kernel on axis 1): a block takes a strip of
//   32 neighbouring channels along the contiguous axis, one a lane, so a
//   warp reads one row's strip at a time (128 contiguous bytes; 4 channels
//   a lane and 512 bytes made 4x fewer blocks and measured slower).  The 8
//   warps of each of `cluster` blocks walk the rows: warp w = 8 * rank +
//   warp of R = 8 * cluster takes rows w, w + R, ..., each lane summing its
//   channel over them in ascending row from +0, 8 rows in flight.  Then
//   the 8 warps of a block by the pairwise tree, and the cluster's blocks
//   by it.
// Each channel's sum is then times gs (traced: (1 - ev) * gs).  No sum here
// is ever -0 (each starts at +0; an exact zero sum rounds to +0), so a tree
// padded with +0 to 8 entries is the tree of its power-of-two entries.
//
// The forward per channel is one launch of warp-sized work items over the
// same (outer, C, inner) view; the item's channel, s and zp are worked out
// once an item (one IEEE division for zp), never once an element, and each
// lane issues all its loads of an item before it computes, then computes
// and stores only the item's elements.  The plan (span) comes from the
// shape alone (ops/fake_quant.py fwd_plan); an elementwise result cannot
// depend on the mapping, so only the bytes in flight and the work an item
// decide it.
// * runs (inner > 1): item w is piece w % pieces of run w / pieces, channel
//   (w / pieces) % C; a piece is `span` elements (128, a group of 4 a lane,
//   or on a large tensor 256, two; at most the run), a run's last piece
//   what is left.  16-byte loads and stores where inner % 4 == 0 and x, out
//   are 16-byte aligned (lane l takes groups l and l + 32), else 4-byte ones
//   (lane l the elements l + 32 k); a warp reads 512 contiguous bytes an
//   access.
// * rows (inner == 1, x is (K, C)): lanes sit on neighbouring channels, 4 a
//   lane when C % 4 == 0 (16-byte accesses where aligned), else 1; item w
//   is strip w % strips of 32 lanes and `span` = 2 rows from (w / strips) *
//   span, both in flight at once.
// (Measured on the H100, PERF.md §6: longer items, 4-16 elements a lane on
// rows and 256 on runs, were slower on all but the largest tensors, and
// computing a short item's absent elements cost a small tensor ~0.5 us.)
// Static out is fq(x); traced reads ini = flags[1] > 0 and writes x itself in
// init mode through the same accesses, so every mode moves the same bytes.
// Stores carry the evict-first hint.  Per tensor the forward stays one
// grid-stride loop of 4-byte accesses over at most kFwdMaxBlocks blocks.
//
// The fused forward + backward (kOut = true, train mode only): the static
// backward kernels with one more output, out = (rint(xq) - zp) * s, which the
// backward computes for dS anyway (dequant() below, the forward's own op
// sequence).  One pass reads g and x and writes out and dX (16 B an element
// against the split pair's 20); the grid and the order are the static
// backward's, so out has fq_fwd_*'s bits and dX, dS, dB have fq_bwd_*'s.
// Replaces fq_fwdbwd_pt _pt_fwdbwd (:607, launching _pt_bwd_kernel with
// emit_out) and fq_fwdbwd_pc _pc_fwdbwd (:639, _pc_bwd_kernel with emit_out)
// of jaxlsq/ops/pallas_kernels.py.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <cfloat>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPtGroups = 2;                      // per tensor: groups of 4 a lane takes a tile
constexpr int kPtTile = kThreads * 4 * kPtGroups;  // 2,048 elements
constexpr int kPtTilesABlock = 4;                  // per tensor: tiles a block takes ...
constexpr int kPtMinBlocks = 512;                  // ... unless that leaves fewer blocks
constexpr int kPtMaxBlocks = 2048;                 // per tensor: blocks, hence partials
constexpr int kPtFold = kPtMaxBlocks / kThreads;   // partials a thread folds
constexpr int kPtSlots = 128;                      // per tensor: streams a device
constexpr int kFwdMaxBlocks = 4096;  // per tensor: the forward's grid-stride loop
constexpr int kFwdGroups = 2;        // per channel, runs: groups of 4 a lane takes at most
constexpr int kFwdRound = 32 * 4 * kFwdGroups;  // ... so a piece is at most 256 elements
constexpr int kFwdRows = 2;          // per channel, rows: rows a lane takes at most
constexpr int kRunBatch = 2;       // per channel, runs: groups of 4 a lane has in flight
constexpr int kRowBatch = 8;       // per channel, rows: rows a lane has in flight

struct Range {
  float qmin, qmax, tmin, tmax;
};

// max and min that return NaN when an input is NaN (PTX .NaN, sm_80 on):
// fmaxf/fminf's IEEE maxNum/minNum would return the other input.  On
// numbers they are fmaxf/fminf, one instruction each as those are.
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

// clamp(v, lo, hi) as torch.clamp and jnp.clip: a NaN v stays NaN.
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return min_nan(max_nan(v, lo), hi);
}

__device__ __forceinline__ void load_qparams(const float* __restrict__ scale,
                                             const float* __restrict__ shift,
                                             int c, const Range& r, float& s,
                                             float& zp) {
  s = max_nan(fabsf(scale[c]), FLT_EPSILON);
  zp = rintf(clamp_nan(__fdiv_rn(-shift[c], s), r.tmin, r.tmax));
}

// xq = clamp(x / s + zp, qmin, qmax), unrounded.
__device__ __forceinline__ float clamped(float x, float s, float zp, const Range& r) {
  return clamp_nan(__fadd_rn(__fdiv_rn(x, s), zp), r.qmin, r.qmax);
}

// The fake-quantized value (rint(xq) - zp) * s of a clamped xq.
__device__ __forceinline__ float dequant(float xq, float s, float zp) {
  return __fmul_rn(__fsub_rn(rintf(xq), zp), s);
}

__device__ __forceinline__ float fq_value(float x, float s, float zp, const Range& r) {
  return dequant(clamped(x, s, zp, r), s, zp);
}

// An element's dS/dB terms added to the running sums (not in eval mode),
// given x, g and its clamped xq, in-range flag and fake-quantized xfq.
__device__ __forceinline__ void add_terms(float xv, float gv, float xq, bool in,
                                          float xfq, float s, float zp,
                                          const Range& r, int sym, int init_mode,
                                          float& ds, float& db) {
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

// One element of the backward: dX's value (g * m; traced init mode: g
// itself) and the forward's out returned, its dS/dB terms added to the
// running sums (not in eval mode).
template <bool kTraced>
__device__ __forceinline__ void bwd_val(float xv, float gv, float s, float zp,
                                        const Range& r, int sym, int eval_mode,
                                        int init_mode, float& dxv, float& outv,
                                        float& ds, float& db) {
  const float xq = clamped(xv, s, zp, r);
  const bool in = (r.qmin < xq) && (xq < r.qmax);
  outv = dequant(xq, s, zp);
  dxv = (kTraced && init_mode) ? gv : __fmul_rn(gv, in ? 1.f : 0.f);
  if (!eval_mode) add_terms(xv, gv, xq, in, outv, s, zp, r, sym, init_mode, ds, db);
}

// The modes a traced kernel reads from flags = [ev, ini] on the device.
__device__ __forceinline__ int flag_set(const float* __restrict__ flags, int k) {
  return flags[k] > 0.f;
}

// Forward per tensor; traced: init mode copies x.
template <bool kTraced>
__global__ void __launch_bounds__(kThreads)
fq_fwd_kernel(const float* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ shift, const float* __restrict__ flags,
              float* __restrict__ out, int n, Range r) {
  const int stride = gridDim.x * kThreads;
  const int ini = kTraced ? flag_set(flags, 1) : 0;
  float s, zp;
  load_qparams(scale, shift, 0, r, s, zp);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride)
    out[i] = ini ? x[i] : fq_value(x[i], s, zp, r);
}

// Forward per channel, runs (inner > 1; the mapping in the note at the top):
// warp w = 8 * blockIdx.x + warp takes piece w % pieces of run w / pieces.
// V = 4: lane l's groups of 4 at 4 (l + 32 j), one 16-byte access each
// (inner % 4 == 0, x and out 16-byte aligned); V = 1: its elements l + 32 k.
template <bool kTraced, int V>
__global__ void __launch_bounds__(kThreads)
fq_fwd_pc_runs_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ shift, const float* __restrict__ flags,
                      float* __restrict__ out, int runs, int C, int inner, int span,
                      int pieces, Range r) {
  constexpr int kE = 4 * kFwdGroups;  // elements a lane takes
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int run = w / pieces;
  if (run >= runs) return;
  const int p = w - run * pieces;
  const int start = p * span, len = min(span, inner - start);
  const float* __restrict__ xs = x + (run * inner + start);
  float* __restrict__ os = out + (run * inner + start);
  float v[kE];
  if (V == 4) {
#pragma unroll
    for (int j = 0; j < kFwdGroups; ++j) {
      const int e = 4 * (lane + 32 * j);
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < len) a = *reinterpret_cast<const float4*>(xs + e);
      v[4 * j] = a.x; v[4 * j + 1] = a.y; v[4 * j + 2] = a.z; v[4 * j + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      const int e = lane + 32 * k;
      v[k] = e < len ? xs[e] : 0.f;
    }
  }
  const int ini = kTraced ? flag_set(flags, 1) : 0;
  float s = 0.f, zp = 0.f;
  if (!ini) load_qparams(scale, shift, run % C, r, s, zp);  // after the loads
  // only the elements of the piece are computed and stored
  if (V == 4) {
#pragma unroll
    for (int j = 0; j < kFwdGroups; ++j) {
      const int e = 4 * (lane + 32 * j);
      if (e >= len) continue;
      float* u = v + 4 * j;
      if (!ini)
#pragma unroll
        for (int t = 0; t < 4; ++t) u[t] = fq_value(u[t], s, zp, r);
      __stcs(reinterpret_cast<float4*>(os + e), make_float4(u[0], u[1], u[2], u[3]));
    }
  } else {
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      const int e = lane + 32 * k;
      if (e < len) __stcs(os + e, ini ? v[k] : fq_value(v[k], s, zp, r));
    }
  }
}

// Forward per channel, rows (inner == 1, x is (K, C); the mapping in the
// note at the top): warp w takes strip w % strips, rows (w / strips) * kR
// .. + kR.  L = 4 channels a lane (C % 4 == 0); V = 4 one 16-byte access a
// row (x and out 16-byte aligned), else four 4-byte ones.  L = 1: one
// channel a lane.
template <bool kTraced, int L, int V>
__global__ void __launch_bounds__(kThreads)
fq_fwd_pc_rows_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ shift, const float* __restrict__ flags,
                      float* __restrict__ out, int K, int C, int strips, Range r) {
  constexpr int kR = kFwdRows;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int q = w % strips, k0 = (w / strips) * kR;
  const int c0 = (32 * q + lane) * L;
  if (k0 >= K || c0 >= C) return;
  const int kend = min(K, k0 + kR);
  float v[kR][L];
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const int k = k0 + j;
    if constexpr (V == 4) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < kend) a = *reinterpret_cast<const float4*>(x + (k * C + c0));
      v[j][0] = a.x; v[j][1] = a.y; v[j][2] = a.z; v[j][3] = a.w;
    } else {
#pragma unroll
      for (int e = 0; e < L; ++e) v[j][e] = k < kend ? x[k * C + c0 + e] : 0.f;
    }
  }
  const int ini = kTraced ? flag_set(flags, 1) : 0;
  float s[L], zp[L];
#pragma unroll
  for (int e = 0; e < L; ++e) {  // after the loads
    s[e] = zp[e] = 0.f;
    if (!ini) load_qparams(scale, shift, c0 + e, r, s[e], zp[e]);
  }
  // only the item's rows are computed and stored
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const int k = k0 + j;
    if (k >= kend) break;
    if (!ini)
#pragma unroll
      for (int e = 0; e < L; ++e) v[j][e] = fq_value(v[j][e], s[e], zp[e], r);
    float* __restrict__ orow = out + (k * C + c0);
    if constexpr (V == 4) {
      __stcs(reinterpret_cast<float4*>(orow), make_float4(v[j][0], v[j][1], v[j][2], v[j][3]));
    } else {
#pragma unroll
      for (int e = 0; e < L; ++e) __stcs(orow + e, v[j][e]);
    }
  }
}

// dS/dB's scale after the sum: gs, or traced (1 - ev) * gs, ev from flags.
template <bool kTraced>
__device__ __forceinline__ float grad_scale(const float* __restrict__ flags, float gs) {
  return kTraced ? __fmul_rn(__fsub_rn(1.f, flags[0]), gs) : gs;
}

// The pairwise tree of v[0..8): v[k] += v[k + h] for h = 4, 2, 1.
__device__ __forceinline__ float tree8(float (&v)[8]) {
#pragma unroll
  for (int h = 4; h > 0; h >>= 1)
#pragma unroll
    for (int k = 0; k < h; ++k) v[k] = __fadd_rn(v[k], v[k + h]);
  return v[0];
}

// The shuffle tree of a warp's 32 values: v[l] += v[l + h] for h = 16 .. 1;
// lane 0 holds the sum.
__device__ __forceinline__ float warp_tree(float v) {
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, h));
  return v;
}

// The per-tensor backward's slots (the note at the top): slot k's ticket
// counter and its blocks' (dS, dB) partials.
__device__ unsigned int pt_ticket[kPtSlots];
__device__ float pt_part[kPtSlots][2][kPtMaxBlocks];

// Copies src[i .. i + 4) (+0 past n) to the shared-memory group at dst
// with cp.async: the bytes are in flight without holding registers.  V = 4:
// one 16-byte copy (src 16-byte aligned), else four 4-byte ones.
template <int V>
__device__ __forceinline__ void stage_group(float4* dst, const float* __restrict__ src,
                                            unsigned i, unsigned n) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(dst);
  if (V == 4) {
    const unsigned left = i < n ? min(4u, n - i) : 0u;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
                 "l"(src + (left ? i : 0u)), "r"(4u * left) : "memory");
  } else {
#pragma unroll
    for (unsigned e = 0; e < 4; ++e) {
      const bool ok = i + e < n;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sa + 4 * e),
                   "l"(src + (ok ? i + e : 0u)), "r"(ok ? 4u : 0u) : "memory");
    }
  }
}

// Per tensor (the order in the note at the top).  Block b takes tiles b, b +
// B, ...  A lane's kPtGroups groups of x and g are a ring in shared memory
// (its own slots, so no barrier): slot j holds group j of the tile at hand
// and, once computed, is refilled with group j of the block's next tile, so
// copies stay in flight across tiles without holding registers.  V = 4: a
// group is one 16-byte copy and one 16-byte store (every pointer 16-byte
// aligned).  Traced: init_mode comes from flags and eval_mode is 0 (ev acts
// in the scale after the sum).
template <bool kTraced, bool kOut, int V>
__global__ void __launch_bounds__(kThreads)
fq_bwd_pt_kernel(const float* __restrict__ g, const float* __restrict__ x,
                 const float* __restrict__ scale, const float* __restrict__ shift,
                 const float* __restrict__ flags, float* __restrict__ dx,
                 float* __restrict__ out, float* __restrict__ ds_out,
                 float* __restrict__ db_out, unsigned n, int slot, Range r, int sym,
                 int eval_mode, int init_mode, float gs) {
  __shared__ float4 xs[kPtGroups][kThreads], gsh[kPtGroups][kThreads];
  __shared__ float wsum[2][kWarps];  // the warps' sums
  __shared__ bool last;
  if (kTraced) {
    eval_mode = 0;
    init_mode = flag_set(flags, 1);
  }
  const bool use_g = kTraced || !init_mode;  // static init mode reads no g, writes no dX
  const unsigned tiles = (n + kPtTile - 1) / kPtTile;
  // copy group j of `tile` (none past the last tile) into slot j, one
  // commit group a call, so the oldest of kPtGroups pending is slot j's
  auto fill = [&](unsigned tile, int j) {
    if (tile < tiles) {
      const unsigned i = tile * kPtTile + 4 * (j * kThreads + threadIdx.x);
      stage_group<V>(&xs[j][threadIdx.x], x, i, n);
      if (use_g) stage_group<V>(&gsh[j][threadIdx.x], g, i, n);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
#pragma unroll
  for (int j = 0; j < kPtGroups; ++j) fill(blockIdx.x, j);
  float s, zp, ds = 0.f, db = 0.f;
  load_qparams(scale, shift, 0, r, s, zp);  // while the first copies are in flight
  for (unsigned tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
#pragma unroll
    for (int j = 0; j < kPtGroups; ++j) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kPtGroups - 1) : "memory");
      const unsigned i = tile * kPtTile + 4 * (j * kThreads + threadIdx.x);
      const float4 xa = xs[j][threadIdx.x];
      const float4 ga = use_g ? gsh[j][threadIdx.x] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float xv[4] = {xa.x, xa.y, xa.z, xa.w}, gv[4] = {ga.x, ga.y, ga.z, ga.w};
      float xq[4], xfq[4], dxv[4];
      bool in[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xq[e] = clamped(xv[e], s, zp, r);
        in[e] = (r.qmin < xq[e]) && (xq[e] < r.qmax);
        xfq[e] = dequant(xq[e], s, zp);
        dxv[e] = (kTraced && init_mode) ? gv[e] : __fmul_rn(gv[e], in[e] ? 1.f : 0.f);
      }
      // out and dX stored before the dS/dB arithmetic
      if (V == 4 && i + 3 < n) {
        if (use_g) __stcs(reinterpret_cast<float4*>(dx + i), make_float4(dxv[0], dxv[1], dxv[2], dxv[3]));
        if (kOut) __stcs(reinterpret_cast<float4*>(out + i), make_float4(xfq[0], xfq[1], xfq[2], xfq[3]));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (i + e >= n) break;
          if (use_g) __stcs(dx + i + e, dxv[e]);
          if (kOut) __stcs(out + i + e, xfq[e]);
        }
      }
      if (!eval_mode) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (i + e < n)
            add_terms(xv[e], gv[e], xq[e], in[e], xfq[e], s, zp, r, sym, init_mode, ds, db);
      }
      fill(tile + gridDim.x, j);  // after the slot's values are used
    }
  }
  if (eval_mode) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ds = warp_tree(ds);
  db = warp_tree(db);
  if (lane == 0) {
    wsum[0][warp] = ds;
    wsum[1][warp] = db;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float p[8], q[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      p[k] = wsum[0][k];
      q[k] = wsum[1][k];
    }
    pt_part[slot][0][blockIdx.x] = tree8(p);
    pt_part[slot][1][blockIdx.x] = tree8(q);
    // the ticket (atomicInc, wrapping to 0 at the last): its release orders
    // these partials before it, its acquire the other blocks' before the fold
    unsigned ticket;
    asm volatile("atom.acq_rel.gpu.inc.u32 %0, [%1], %2;\n"
                 : "=r"(ticket) : "l"(&pt_ticket[slot]), "r"(gridDim.x - 1) : "memory");
    last = ticket == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  float v[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float p[kPtFold];
#pragma unroll
    for (int k = 0; k < kPtFold; ++k) {
      const unsigned b = threadIdx.x + k * kThreads;
      p[k] = b < gridDim.x ? __ldcg(&pt_part[slot][h][b]) : 0.f;
    }
#pragma unroll
    for (int w = kPtFold / 2; w > 0; w >>= 1)
#pragma unroll
      for (int k = 0; k < w; ++k) p[k] = __fadd_rn(p[k], p[k + w]);
    v[h] = warp_tree(p[0]);
  }
  if (lane == 0) {  // thread 0 read wsum before the barrier above
    wsum[0][warp] = v[0];
    wsum[1][warp] = v[1];
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float p[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k] = wsum[threadIdx.x][k];
    (threadIdx.x ? db_out : ds_out)[0] = __fmul_rn(tree8(p), grad_scale<kTraced>(flags, gs));
  }
}

// A cluster of cs > 1 blocks, each with its partials in part[0..n): rank 0's
// threads e < n fold entry e of ranks 0 .. cs - 1 by tree8 over distributed
// shared memory and return true with it in v.  Every thread of every block
// calls it: one cluster barrier before the reads (the partials have landed),
// one after (no block leaves while rank 0 reads its shared memory).
__device__ __forceinline__ bool cluster_fold(float* part, int n, int cs, float& v) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const bool mine = blockIdx.x % cs == 0 && (int)threadIdx.x < n;
  if (mine) {
    float p[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      p[k] = k < cs ? *cluster.map_shared_rank(part + threadIdx.x, k) : 0.f;
    v = tree8(p);
  }
  cluster.sync();
  return mine;
}

// Element t of channel c's walk over the (outer, C, inner) view.
__device__ __forceinline__ int run_index(int t, int c, int C, int outer, int inner) {
  if (outer == 1) return c * inner + t;
  const int o = t / inner;
  return (o * C + c) * inner + (t - o * inner);
}

// Per channel, runs (inner > 1; the order in the note at the top).  Block b
// is rank b % cs of its cluster and holds channels (b / cs) * (8 / wpc) ...;
// V = 4: one 16-byte load a group (inner % 4 == 0, aligned pointers).
template <bool kTraced, bool kOut, int V>
__global__ void __launch_bounds__(kThreads)
fq_bwd_pc_runs_kernel(const float* __restrict__ g, const float* __restrict__ x,
                      const float* __restrict__ scale, const float* __restrict__ shift,
                      const float* __restrict__ flags, float* __restrict__ dx,
                      float* __restrict__ out, float* __restrict__ ds_out,
                      float* __restrict__ db_out, int outer, int C, int inner, int wpc,
                      int cs, Range r, int sym, int eval_mode, int init_mode, float gs) {
  __shared__ float wsum[2][kWarps];  // the warps' sums
  __shared__ float bsum[2 * kWarps];  // slot k's dS at 2k, dB at 2k + 1
  if (kTraced) {
    eval_mode = 0;
    init_mode = flag_set(flags, 1);
  }
  const bool use_g = kTraced || !init_mode;  // static init mode reads no g, writes no dX
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cpb = kWarps / wpc;
  const int c = (blockIdx.x / cs) * cpb + warp / wpc;
  const int m = outer * inner, ng = (m + 3) >> 2, P = 32 * wpc * cs;
  const int G = ((blockIdx.x % cs) * wpc + warp % wpc) * 32 + lane;
  float ds = 0.f, db = 0.f;
  if (c < C) {
    float s = 0.f, zp = 0.f;
    bool have_q = false;
    for (int u = G; u < ng; u += kRunBatch * P) {
      float xv[kRunBatch][4], gv[kRunBatch][4];
      int at[kRunBatch][4];  // V = 4: the group's first index; -1: none
#pragma unroll
      for (int j = 0; j < kRunBatch; ++j) {
        const int uj = u + j * P;
        const int t0 = uj < ng ? 4 * uj : m;
        if (V == 4) {
          at[j][0] = t0 < m ? run_index(t0, c, C, outer, inner) : -1;
          float4 xa = make_float4(0.f, 0.f, 0.f, 0.f), ga = xa;
          if (at[j][0] >= 0) {
            xa = *reinterpret_cast<const float4*>(x + at[j][0]);
            if (use_g) ga = *reinterpret_cast<const float4*>(g + at[j][0]);
          }
          xv[j][0] = xa.x; xv[j][1] = xa.y; xv[j][2] = xa.z; xv[j][3] = xa.w;
          gv[j][0] = ga.x; gv[j][1] = ga.y; gv[j][2] = ga.z; gv[j][3] = ga.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            at[j][e] = e < m - t0 ? run_index(t0 + e, c, C, outer, inner) : -1;
            xv[j][e] = at[j][e] >= 0 ? x[at[j][e]] : 0.f;
            gv[j][e] = (use_g && at[j][e] >= 0) ? g[at[j][e]] : 0.f;
          }
        }
      }
      if (!have_q) {  // after the first loads are in flight
        load_qparams(scale, shift, c, r, s, zp);
        have_q = true;
      }
#pragma unroll
      for (int j = 0; j < kRunBatch; ++j) {
        float dxv[4], ov[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (at[j][V == 4 ? 0 : e] >= 0)
            bwd_val<kTraced>(xv[j][e], gv[j][e], s, zp, r, sym, eval_mode, init_mode,
                             dxv[e], ov[e], ds, db);
        if (V == 4) {
          if (at[j][0] < 0) continue;
          if (use_g)
            *reinterpret_cast<float4*>(dx + at[j][0]) = make_float4(dxv[0], dxv[1], dxv[2], dxv[3]);
          if (kOut)
            *reinterpret_cast<float4*>(out + at[j][0]) = make_float4(ov[0], ov[1], ov[2], ov[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (at[j][e] < 0) continue;
            if (use_g) dx[at[j][e]] = dxv[e];
            if (kOut) out[at[j][e]] = ov[e];
          }
        }
      }
    }
  }
  if (eval_mode) return;
  ds = warp_tree(ds);
  db = warp_tree(db);
  if (lane == 0) {
    wsum[0][warp] = ds;
    wsum[1][warp] = db;
  }
  __syncthreads();
  float v = 0.f;
  if ((int)threadIdx.x < 2 * cpb) {  // slot threadIdx.x / 2: tree of its wpc warps
    const int q = threadIdx.x & 1, w0 = (threadIdx.x >> 1) * wpc;
    float p[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k] = k < wpc ? wsum[q][w0 + k] : 0.f;
    v = tree8(p);
    bsum[threadIdx.x] = v;
  }
  if (cs > 1 ? !cluster_fold(bsum, 2, cs, v) : (int)threadIdx.x >= 2 * cpb) return;
  const int cc = (blockIdx.x / cs) * cpb + (threadIdx.x >> 1);
  if (cc < C) ((threadIdx.x & 1) ? db_out : ds_out)[cc] = __fmul_rn(v, grad_scale<kTraced>(flags, gs));
}

// Per channel, rows (inner == 1, x is (K, C); the order in the note at the
// top).  Block b is rank b % cs of its cluster and holds the strip of 32
// channels from (b / cs) * 32, lane l channel l: a warp reads one row's
// strip, 128 contiguous bytes.
template <bool kTraced, bool kOut>
__global__ void __launch_bounds__(kThreads)
fq_bwd_pc_rows_kernel(const float* __restrict__ g, const float* __restrict__ x,
                      const float* __restrict__ scale, const float* __restrict__ shift,
                      const float* __restrict__ flags, float* __restrict__ dx,
                      float* __restrict__ out, float* __restrict__ ds_out,
                      float* __restrict__ db_out, int K, int C, int cs, Range r, int sym,
                      int eval_mode, int init_mode, float gs) {
  __shared__ float wpart[2][kWarps][32];  // each warp's sums
  __shared__ float bsum[2 * 32];  // dS of strip channel e at e, dB at 32 + e
  if (kTraced) {
    eval_mode = 0;
    init_mode = flag_set(flags, 1);
  }
  const bool use_g = kTraced || !init_mode;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = (blockIdx.x / cs) * 32 + lane;
  const int R = kWarps * cs, w = (blockIdx.x % cs) * kWarps + warp;
  float ds = 0.f, db = 0.f;
  if (c < C) {
    float s = 0.f, zp = 0.f;
    bool have_q = false;
    for (int o = w; o < K; o += kRowBatch * R) {
      float xv[kRowBatch], gv[kRowBatch];
#pragma unroll
      for (int j = 0; j < kRowBatch; ++j) {
        const int oj = o + j * R;
        xv[j] = oj < K ? x[oj * C + c] : 0.f;
        gv[j] = (use_g && oj < K) ? g[oj * C + c] : 0.f;
      }
      if (!have_q) {  // after the first loads are in flight
        load_qparams(scale, shift, c, r, s, zp);
        have_q = true;
      }
#pragma unroll
      for (int j = 0; j < kRowBatch; ++j) {
        const int oj = o + j * R;
        if (oj >= K) continue;
        float dxv, ov;
        bwd_val<kTraced>(xv[j], gv[j], s, zp, r, sym, eval_mode, init_mode, dxv, ov, ds, db);
        if (use_g) dx[oj * C + c] = dxv;
        if (kOut) out[oj * C + c] = ov;
      }
    }
  }
  if (eval_mode) return;
  wpart[0][warp][lane] = ds;
  wpart[1][warp][lane] = db;
  __syncthreads();
  float v = 0.f;
  if (threadIdx.x < 64) {  // entry threadIdx.x: tree of the 8 warps
    const int q = threadIdx.x >> 5, e = threadIdx.x & 31;
    float p[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k] = wpart[q][k][e];
    v = tree8(p);
    bsum[threadIdx.x] = v;
  }
  if (cs > 1 ? !cluster_fold(bsum, 64, cs, v) : threadIdx.x >= 64) return;
  const int cc = (blockIdx.x / cs) * 32 + (threadIdx.x & 31);
  if (cc < C) (threadIdx.x >= 32 ? db_out : ds_out)[cc] = __fmul_rn(v, grad_scale<kTraced>(flags, gs));
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// Per tensor: tiles / kPtTilesABlock blocks, within [kPtMinBlocks,
// kPtMaxBlocks] and at most one a tile.
int pt_blocks(int n) {
  const int tiles = std::max(1, cdiv(n, kPtTile));
  return std::min(tiles, std::min(kPtMaxBlocks, std::max(kPtMinBlocks, tiles / kPtTilesABlock)));
}

int fwd_blocks(int n) { return std::min(kFwdMaxBlocks, std::max(1, cdiv(n, kThreads))); }

template <bool kTraced>
int launch_fwd_pt(const void* x, const void* scale, const void* shift,
                  const void* flags, void* out, int n, const Range& r, void* stream) {
  fq_fwd_kernel<kTraced><<<fwd_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)scale, (const float*)shift,
      (const float*)flags, (float*)out, n, r);
  return (int)cudaGetLastError();
}

// Per channel: one launch, runs or rows by the view, with fwd_plan's span
// (16-byte accesses where the layout and x, out allow).
template <bool kTraced>
int launch_fwd_pc(const void* x, const void* scale, const void* shift,
                  const void* flags, void* out, int outer, int C, int inner, int span,
                  const Range& r, void* stream) {
  const float *xp = (const float*)x, *sp = (const float*)scale, *hp = (const float*)shift,
              *fp = (const float*)flags;
  float* op = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool aligned = ((uintptr_t)x | (uintptr_t)out) % 16 == 0;
  if (outer < 1 || C < 1 || inner < 1) return (int)cudaErrorInvalidValue;
  if (inner == 1) {
    const int lanes_c = C % 4 == 0 ? 4 : 1;  // channels a lane
    if (span != kFwdRows) return (int)cudaErrorInvalidValue;
    const int strips = cdiv(C, 32 * lanes_c);
    const int blocks = (int)(((long long)strips * cdiv(outer, span) + kWarps - 1) / kWarps);
    if (lanes_c == 1)
      fq_fwd_pc_rows_kernel<kTraced, 1, 1><<<blocks, kThreads, 0, st>>>(
          xp, sp, hp, fp, op, outer, C, strips, r);
    else if (aligned)
      fq_fwd_pc_rows_kernel<kTraced, 4, 4><<<blocks, kThreads, 0, st>>>(
          xp, sp, hp, fp, op, outer, C, strips, r);
    else
      fq_fwd_pc_rows_kernel<kTraced, 4, 1><<<blocks, kThreads, 0, st>>>(
          xp, sp, hp, fp, op, outer, C, strips, r);
  } else {
    if (span < 4 || span % 4 != 0 || span > kFwdRound) return (int)cudaErrorInvalidValue;
    const int pieces = cdiv(inner, span), runs = outer * C;
    const int blocks = (int)(((long long)runs * pieces + kWarps - 1) / kWarps);
    if (aligned && inner % 4 == 0)
      fq_fwd_pc_runs_kernel<kTraced, 4><<<blocks, kThreads, 0, st>>>(
          xp, sp, hp, fp, op, runs, C, inner, span, pieces, r);
    else
      fq_fwd_pc_runs_kernel<kTraced, 1><<<blocks, kThreads, 0, st>>>(
          xp, sp, hp, fp, op, runs, C, inner, span, pieces, r);
  }
  return (int)cudaGetLastError();
}

// One launch in the stream's slot (16-byte loads where every pointer
// allows).  kOut (static train mode): out is written too.
template <bool kTraced, bool kOut = false>
int launch_bwd_pt(const void* g, const void* x, const void* scale,
                  const void* shift, const void* flags, void* dx, void* ds, void* db,
                  int n, int slot, const Range& r, int sym, int eval_mode,
                  int init_mode, float gs, void* stream, void* out = nullptr) {
  if (n < 1 || slot < 0 || slot >= kPtSlots) return (int)cudaErrorInvalidValue;
  const uintptr_t ptrs = (uintptr_t)g | (uintptr_t)x | (uintptr_t)dx | (uintptr_t)out;
  auto kernel = ptrs % 16 == 0 ? fq_bwd_pt_kernel<kTraced, kOut, 4>
                               : fq_bwd_pt_kernel<kTraced, kOut, 1>;
  kernel<<<pt_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)x, (const float*)scale, (const float*)shift,
      (const float*)flags, (float*)dx, (float*)out, (float*)ds, (float*)db,
      (unsigned)n, slot, r, sym, eval_mode, init_mode, gs);
  return (int)cudaGetLastError();
}

// One launch: runs or rows by the view (runs: 16-byte loads where the layout
// and every pointer allow), the plan's cluster when it is > 1.  Static eval
// mode writes dX only.
template <bool kTraced, bool kOut = false>
int launch_bwd_pc(const void* g, const void* x, const void* scale,
                  const void* shift, const void* flags, void* dx, void* ds, void* db,
                  int outer, int C, int inner, int warps, int cluster, const Range& r,
                  int sym, int eval_mode, int init_mode, float gs, void* stream,
                  void* out = nullptr) {
  const bool rows = inner == 1;
  const bool pow2 = warps > 0 && warps <= kWarps && !(warps & (warps - 1)) &&
                    cluster > 0 && cluster <= 8 && !(cluster & (cluster - 1));
  if (!pow2 || ((rows || cluster > 1) && warps != kWarps)) return (int)cudaErrorInvalidValue;
  const uintptr_t ptrs = (uintptr_t)g | (uintptr_t)x | (uintptr_t)dx | (uintptr_t)out;
  const bool wide = ptrs % 16 == 0 && inner % 4 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1] = {};
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const float *gp = (const float*)g, *xp = (const float*)x, *sp = (const float*)scale,
              *hp = (const float*)shift, *fp = (const float*)flags;
  float *dxp = (float*)dx, *op = (float*)out, *dsp = (float*)ds, *dbp = (float*)db;
  cudaError_t err;
  if (rows) {
    cfg.gridDim = dim3(cdiv(C, 32) * cluster, 1, 1);
    err = cudaLaunchKernelEx(&cfg, fq_bwd_pc_rows_kernel<kTraced, kOut>, gp, xp, sp, hp, fp,
                             dxp, op, dsp, dbp, outer, C, cluster, r, sym, eval_mode,
                             init_mode, gs);
  } else {
    cfg.gridDim = dim3(cdiv(C, kWarps / warps) * cluster, 1, 1);
    err = wide ? cudaLaunchKernelEx(&cfg, fq_bwd_pc_runs_kernel<kTraced, kOut, 4>, gp, xp,
                                    sp, hp, fp, dxp, op, dsp, dbp, outer, C, inner, warps,
                                    cluster, r, sym, eval_mode, init_mode, gs)
               : cudaLaunchKernelEx(&cfg, fq_bwd_pc_runs_kernel<kTraced, kOut, 1>, gp, xp,
                                    sp, hp, fp, dxp, op, dsp, dbp, outer, C, inner, warps,
                                    cluster, r, sym, eval_mode, init_mode, gs);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Streams a device the per-tensor backward keeps apart: its slots.
int jlt_fq_pt_slots() { return kPtSlots; }

// Forward per tensor (scale, shift are (1,)).  Returns cudaGetLastError().
int jlt_fq_fwd_pt(const void* x, const void* scale, const void* shift, void* out,
                  int n, float qmin, float qmax, float tmin, float tmax,
                  void* stream) {
  return launch_fwd_pt<false>(x, scale, shift, nullptr, out, n,
                              Range{qmin, qmax, tmin, tmax}, stream);
}

// Forward per channel over the (outer, C, inner) view, one launch, the span
// of fwd_plan; scale, shift are (C,).
int jlt_fq_fwd_pc(const void* x, const void* scale, const void* shift, void* out,
                  int outer, int C, int inner, int span, float qmin, float qmax,
                  float tmin, float tmax, void* stream) {
  return launch_fwd_pc<false>(x, scale, shift, nullptr, out, outer, C, inner, span,
                              Range{qmin, qmax, tmin, tmax}, stream);
}

// Backward per tensor, one launch in slot `slot` (0 .. jlt_fq_pt_slots() - 1,
// one a stream); ds, db are (1,).  dx is not written in init mode, ds/db not
// in eval mode.
int jlt_fq_bwd_pt(const void* g, const void* x, const void* scale,
                  const void* shift, void* dx, void* ds, void* db, int n, int slot,
                  float qmin, float qmax, float tmin, float tmax, int sym,
                  int eval_mode, int init_mode, float gs, void* stream) {
  return launch_bwd_pt<false>(g, x, scale, shift, nullptr, dx, ds, db, n, slot,
                              Range{qmin, qmax, tmin, tmax}, sym, eval_mode,
                              init_mode, gs, stream);
}

// Backward per channel over the (outer, C, inner) view, one launch, the
// plan (warps, cluster) of pc_plan; ds, db are (C,).  dx is not written in
// init mode, ds/db not in eval mode.
int jlt_fq_bwd_pc(const void* g, const void* x, const void* scale,
                  const void* shift, void* dx, void* ds, void* db, int outer, int C,
                  int inner, int warps, int cluster, float qmin, float qmax,
                  float tmin, float tmax, int sym, int eval_mode, int init_mode,
                  float gs, void* stream) {
  return launch_bwd_pc<false>(g, x, scale, shift, nullptr, dx, ds, db, outer, C,
                              inner, warps, cluster, Range{qmin, qmax, tmin, tmax},
                              sym, eval_mode, init_mode, gs, stream);
}

// Fused forward + backward, train mode: out and dx are (n,) like x; ds,
// db and the slot as for jlt_fq_bwd_pt.
int jlt_fq_fwdbwd_pt(const void* g, const void* x, const void* scale,
                     const void* shift, void* out, void* dx, void* ds, void* db,
                     int n, int slot, float qmin, float qmax, float tmin,
                     float tmax, int sym, float gs, void* stream) {
  return launch_bwd_pt<false, true>(g, x, scale, shift, nullptr, dx, ds, db, n, slot,
                                    Range{qmin, qmax, tmin, tmax}, sym, 0, 0, gs,
                                    stream, out);
}

// Fused forward + backward per channel over the (outer, C, inner) view, the
// plan of jlt_fq_bwd_pc.
int jlt_fq_fwdbwd_pc(const void* g, const void* x, const void* scale,
                     const void* shift, void* out, void* dx, void* ds, void* db,
                     int outer, int C, int inner, int warps, int cluster, float qmin,
                     float qmax, float tmin, float tmax, int sym, float gs,
                     void* stream) {
  return launch_bwd_pc<false, true>(g, x, scale, shift, nullptr, dx, ds, db, outer,
                                    C, inner, warps, cluster,
                                    Range{qmin, qmax, tmin, tmax}, sym, 0, 0, gs,
                                    stream, out);
}

// The traced twins: flags is a (2,) f32 device tensor [ev, ini]; every
// output (out; dx, ds, db) is written in every mode.
int jlt_fq_fwd_pt_traced(const void* x, const void* scale, const void* shift,
                         const void* flags, void* out, int n, float qmin,
                         float qmax, float tmin, float tmax, void* stream) {
  return launch_fwd_pt<true>(x, scale, shift, flags, out, n,
                             Range{qmin, qmax, tmin, tmax}, stream);
}

int jlt_fq_fwd_pc_traced(const void* x, const void* scale, const void* shift,
                         const void* flags, void* out, int outer, int C,
                         int inner, int span, float qmin, float qmax, float tmin,
                         float tmax, void* stream) {
  return launch_fwd_pc<true>(x, scale, shift, flags, out, outer, C, inner, span,
                             Range{qmin, qmax, tmin, tmax}, stream);
}

int jlt_fq_bwd_pt_traced(const void* g, const void* x, const void* scale,
                         const void* shift, const void* flags, void* dx, void* ds,
                         void* db, int n, int slot, float qmin, float qmax,
                         float tmin, float tmax, int sym, float gs, void* stream) {
  return launch_bwd_pt<true>(g, x, scale, shift, flags, dx, ds, db, n, slot,
                             Range{qmin, qmax, tmin, tmax}, sym, 0, 0, gs, stream);
}

int jlt_fq_bwd_pc_traced(const void* g, const void* x, const void* scale,
                         const void* shift, const void* flags, void* dx, void* ds,
                         void* db, int outer, int C, int inner, int warps,
                         int cluster, float qmin, float qmax, float tmin,
                         float tmax, int sym, float gs, void* stream) {
  return launch_bwd_pc<true>(g, x, scale, shift, flags, dx, ds, db, outer, C, inner,
                             warps, cluster, Range{qmin, qmax, tmin, tmax}, sym, 0, 0,
                             gs, stream);
}

}  // extern "C"
