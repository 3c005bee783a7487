// Weight-only int8 / int4 matmul with the dequant fused in:
//   out[m, n] = s[n] * sum_k x[m, k] * (w[k, n] - z[n])
// x f32 (M, K) row-major; w int8 (K, N), or int4 split-half bytes (ceil(K/2), N)
// whose byte row r holds k = r (low nibble) and k = r + ceil(K/2) (high nibble);
// s f32 / z int32 per output channel (N,) or per tensor (1,).
//
// Group-wise int4 (wo4g): s f32 (G, N), one row per group of gs rows of K,
// no zero point (symmetric):
//   out[m, n] = sum_k x[m, k] * w[k, n] * s[k / gs, n]
//
// Replaces the TPU kernels jaxlsq/serve/matmul.py:_wo8_kernel (launched at
// :255), _wo4_kernel (:317) and _wo4g_kernel (:147, launched at :298).
//
// ---- wo8 (int8): one launch a call, one summation order for every M ----
//
// The order, which depends on K and kSlice only:
//   1. K is cut into slices of kSlice = 32 consecutive rows, padded with zero
//      rows (x = 0, w - z = 0) to a whole slice;
//   2. a slice partial is one fmaf chain over the slice's k in ascending
//      order from +0, the factor (float)(w - z) (exact);
//   3. the slice partials are left-folded in ascending slice order from +0
//      (total = 0; total += p0; total += p1; ...);
//   4. out = total * s[n].
// So a row gives the same bits at any M, in any row tile and in either form
// below: at B = 1 and B = 8, and in prefill and decode.
//
// What bounds it on an H100: at decode M every weight byte is used M times,
// far below the card's ~20 f32 operations per byte of bandwidth, so it is
// bound by streaming the K*N weight bytes once; at prefill M (M = 256 and up)
// by the f32 FMAs.  Two forms, chosen by M (thresholds from card runs):
//
// Split form (M <= 64 and M * N <= 256K: decode and short chunks).  A thread
// owns CPT int8 columns (8 for up to 4 rows, else 4) and one slice at a time:
// it issues all 32 row loads of the slice before it uses any, so even the
// 1 MB d1024 proj weight is all in flight at once.  A block is 8 column
// threads x up to 32 slice threads; the K slices of a column tile are spread
// over a thread-block cluster of C blocks (Hopper's distributed shared
// memory; C a power of two <= 8, the fewest that give the card a wave and fit
// in shared memory), block r owning the tile's r-th C-th of the columns.
// Each thread stores its slice partials straight into the shared memory of
// the block that owns their columns; after one cluster barrier every block
// folds its columns in slice order from its own shared memory and writes out
// with the scale.  One launch, no workspace, no second kernel.  The row count
// is a template (1, 2, 4, 8, 16), so M = 1 holds 8 accumulators a thread;
// rows past 16 go to further row tiles (gridDim.y).  (float)(w - z) is two
// instructions: the byte + 128 as the mantissa of 2^23 (a byte permute), less
// 2^23 + 128 + z (exact for |z| < 2^22, which holds for every 8-bit zero
// point).
//
// Tiled form (larger M: prefill).  A register-tiled product: a block owns a
// BM x BN output tile; x (f32) and the weight (raw int8) arrive slice by
// slice through a ring of 4 shared-memory stages by cp.async, each slice's
// weights become f32 (w - z) once, and each thread keeps a per-slice
// accumulator that it adds into its running total at every slice's end: the
// split form's bits.  The tile (128 x 128, 64 x 64) is the largest that
// gives the card most of a wave of blocks; where neither does (N = 1024 up
// to M = 320), 32 x 32 tiles of 2 x 4 a thread take the K slices in rounds
// over a cluster of up to 8 blocks (slice j * C + r to block r), which fold
// each round's C consecutive partials in slice order: the same bits again.
// A 32 x 32 tile alone is one block of 4 warps walking 128 slices at K =
// 4096; split, its slices spread over 8 blocks.
//
// ---- wo4 / wo4g (int4) and the int4 lab ----
//
// The design reads each weight byte once per block of 16 activation rows: a
// block owns 128 output columns (a warp's 32 lanes x 4 adjacent columns, so a
// warp loads one contiguous 128-byte segment of a weight row) and one 128-row
// chunk of K, its 8 warps take the chunk's rows in turn (four row loads in
// flight per warp), and the activations of the chunk sit in shared memory.
// Splitting K into chunks gives enough blocks to spread the weight stream over
// the SMs (N/128 column tiles alone would be 8 blocks for N = 1024).  A second kernel sums the chunk partials in chunk
// order and applies the epilogue: the zero point as acc - rowsum(x) * z[n]
// (as _wo4_kernel does), then * s[n].
//
// Reduction order: every output element is summed in the same order whatever
// M, the row's place in the batch, or the row tile it falls in, so a row gives
// the same bits at B = 1 and B = 8 and in prefill and decode.
//
// Large M (prefill) re-reads the weights once per 16 rows; the rows are done in
// slabs of 256 so the partial-sum workspace stays n_chunks * 256 * N floats.
//
// wo4g runs the wo4 blocks: a 128-row chunk's low nibbles (k in [r0, r0 +
// 128)) and high nibbles (k in [K/2 + r0, ...)) each lie inside one group
// when gs and K/2 are multiples of 128, so a thread loads its 4 columns of
// the chunk's two group-scale rows once and multiplies each decoded nibble
// by its row's scale before the FMAs; the chunk partials then need no
// epilogue but their chunk-ordered sum.  The wrapper refuses other group
// sizes.  A first form kept the low- and high-nibble sums in two
// accumulators and scaled the warp-summed partials: 174 registers a thread,
// one block an SM, twice wo4's time at M = 256 on an H100 (PERF.md).
//
// A first form with one row load in flight per warp took about 20 us per
// M = 1 call on an H100 whatever the shape (load latency x 32 rows per warp).
//
// The int4 kernel lab's two candidates (lab/int4_kernel_lab.py) run these wo4
// blocks with another staging of x and no zero point (zp == nullptr: no
// rowsum, no zero-point term), so they differ from wo4 only in what the lab
// measures:
//   wo4_bf16:   out[m, n] = s[n] * sum_k bf16(x[m, k]) * w[k, n]
//     the split-half bytes, x rounded to bf16 (round to nearest even) as it
//     is staged; a nibble is exact in bf16, so each product is exact in f32
//     and the sums are f32, as _wo4_bf16_kernel's bf16 dot with an f32
//     accumulator.  Replaces examples/_int4_kernel_lab.py:_wo4_bf16_kernel
//     (:50, launched at :106 in run_bf16).
//   wo4_native: out[m, n] = s[n] * sum_k x[m, k] * w[k, n]
//     int4 with K contiguous (the port's layout for the lab's jnp.int4 array,
//     whose bytes it cannot see): byte (r, n) holds k = 2r in its low nibble
//     and k = 2r + 1 in its high nibble, K even.  Replaces
//     _wo4_native_kernel (:72, launched at :136 in run_native, plane f32).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace cg = cooperative_groups;

namespace {

using jlt::copy_async;
using jlt::copy_commit;
using jlt::copy_wait;

constexpr int kCols = 128;        // output columns per block (32 lanes x 4)
constexpr int kWarps = 8;         // warps sharing a K chunk
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;         // activation rows per block
constexpr int kChunk = 128;       // weight rows (int8) or byte rows (int4) per block
constexpr int kUnroll = 4;        // weight rows a warp loads before using them
constexpr int kSlab = 256;        // activation rows per launch pair

// How a block stages its chunk's activations: f32 split halves (wo4, wo4g),
// split halves rounded to bf16 (wo4_bf16), K contiguous (wo4_native: byte
// row r meets x[m, 2r] and x[m, 2r + 1]).
enum Stage { kStageF32, kStageBf16, kStageKContig };

// One (column tile, K chunk, row tile) block: partial sums of its chunk.
// part is (n_chunks, mslab, N); rowsum is (n_chunks, mslab).
// GROUPED: gscale is (G, N); each nibble is scaled by its group.
// rowsum == nullptr (no zero point): no rowsum is written.
template <bool GROUPED, Stage STAGE = kStageF32>
__global__ void __launch_bounds__(kThreads)
wo_partial_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                  const int* __restrict__ zp, const float* __restrict__ gscale,
                  float* __restrict__ part, float* __restrict__ rowsum, int M,
                  int K, int N, int KR, int per_channel, int gs) {
  __shared__ float xs[kRows][kChunk];
  __shared__ float xh[kRows][kChunk];
  __shared__ float red[kWarps][kCols];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kCols + lane * 4;
  const int chunk = blockIdx.y;
  const int r0 = chunk * kChunk;
  const int rc = min(kChunk, KR - r0);
  const int m0 = blockIdx.z * kRows;
  const int mt = min(kRows, M - m0);

  // stage this chunk's activations (the low and the high half, or for K
  // contiguous the even and the odd k)
  for (int i = threadIdx.x; i < kRows * kChunk; i += kThreads) {
    const int m = i / kChunk, r = i % kChunk;
    float lo = 0.f, hi = 0.f;
    if (m < mt && r < rc) {
      const float* row = x + (size_t)(m0 + m) * K;
      if (STAGE == kStageKContig) {
        lo = row[2 * (r0 + r)];
        hi = row[2 * (r0 + r) + 1];
      } else {
        lo = row[r0 + r];
        if (r0 + r + KR < K) hi = row[r0 + r + KR];
        if (STAGE == kStageBf16) {
          lo = __bfloat162float(__float2bfloat16_rn(lo));
          hi = __bfloat162float(__float2bfloat16_rn(hi));
        }
      }
    }
    xs[m][r] = lo;
    xh[m][r] = hi;
  }
  __syncthreads();

  const bool vec = ((N & 3) == 0) && (n0 + 3 < N);

  // the chunk's two groups (grouped only): low nibbles k = r0 + r, high
  // nibbles k = KR + r0 + r
  float slo[4], shi[4];
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + j;
    const bool live = GROUPED && n < N;
    slo[j] = live ? gscale[(size_t)(r0 / gs) * N + n] : 0.f;
    shi[j] = live ? gscale[(size_t)((KR + r0) / gs) * N + n] : 0.f;
  }

  float acc[kRows][4];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  // Each warp takes rows warp, warp + 8, ... of the chunk, in that order; it
  // issues kUnroll row loads before using any, so their latencies overlap.
  for (int rb = warp; rb < rc; rb += kWarps * kUnroll) {
    int8_t b[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = rb + u * kWarps;
      const int8_t* wrow = w + (size_t)(r0 + r) * N + n0;
      if (r < rc && vec) {
        const char4 c = *reinterpret_cast<const char4*>(wrow);
        b[u][0] = c.x; b[u][1] = c.y; b[u][2] = c.z; b[u][3] = c.w;
      } else {
        for (int j = 0; j < 4; ++j) b[u][j] = (r < rc && n0 + j < N) ? wrow[j] : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = rb + u * kWarps;
      if (r >= rc) break;
      float wlo[4], whi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int v = b[u][j];
        wlo[j] = (float)((int)((unsigned)v << 28) >> 28);  // sign-extended low nibble
        whi[j] = (float)(v >> 4);  // arithmetic shift: sign-extended high nibble
        if (GROUPED) {
          wlo[j] *= slo[j];
          whi[j] *= shi[j];
        }
      }
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        if (m < mt) {
          const float xl = xs[m][r];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xl, wlo[j], acc[m][j]);
          const float xu = xh[m][r];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xu, whi[j], acc[m][j]);
        }
      }
    }
  }

  // rowsum(x) over this chunk, for the zero-point epilogue
  if (!GROUPED && rowsum && blockIdx.x == 0 && threadIdx.x < mt) {
    float s = 0.f;
    for (int r = 0; r < rc; ++r) s += xs[threadIdx.x][r] + xh[threadIdx.x][r];
    rowsum[(size_t)chunk * M + m0 + threadIdx.x] = s;
  }

  // sum the 8 warps' partials, in warp order, one row at a time
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    if (m >= mt) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][lane * 4 + j] = acc[m][j];
    __syncthreads();
    if (threadIdx.x < kCols) {
      const int n = blockIdx.x * kCols + threadIdx.x;
      if (n < N) {
        float s = 0.f;
        for (int q = 0; q < kWarps; ++q) s += red[q][threadIdx.x];
        part[((size_t)chunk * M + m0 + m) * N + n] = s;
      }
    }
    __syncthreads();
  }
}

// Sum the chunk partials in chunk order and apply the dequant epilogue (the
// grouped partials are scaled already: their sum is the output; zp ==
// nullptr: no zero-point term).
template <bool GROUPED>
__global__ void wo_epilogue_kernel(const float* __restrict__ part,
                                   const float* __restrict__ rowsum,
                                   const float* __restrict__ scale,
                                   const int* __restrict__ zp,
                                   float* __restrict__ out, int M, int N,
                                   int n_chunks, int per_channel) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  const int m = i / N, n = i % N;
  float acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) acc += part[((size_t)c * M + m) * N + n];
  if (GROUPED) {
    out[i] = acc;
    return;
  }
  const int ch = per_channel ? n : 0;
  if (zp) {
    float rs = 0.f;
    for (int c = 0; c < n_chunks; ++c) rs += rowsum[(size_t)c * M + m];
    acc = acc - rs * (float)zp[ch];
  }
  out[i] = acc * scale[ch];
}

template <bool GROUPED, Stage STAGE = kStageF32>
void launch(const float* x, const int8_t* w, const float* scale, const int* zp,
            float* out, float* part, float* rowsum, int M, int K, int N,
            int per_channel, int gs, cudaStream_t stream) {
  const int KR = (K + 1) / 2;
  const int n_chunks = (KR + kChunk - 1) / kChunk;
  for (int ms = 0; ms < M; ms += kSlab) {
    const int mslab = min(kSlab, M - ms);
    dim3 grid((N + kCols - 1) / kCols, n_chunks, (mslab + kRows - 1) / kRows);
    wo_partial_kernel<GROUPED, STAGE><<<grid, kThreads, 0, stream>>>(
        x + (size_t)ms * K, w, zp, scale, part, rowsum, mslab, K, N, KR,
        per_channel, gs);
    const size_t total = (size_t)mslab * N;
    wo_epilogue_kernel<GROUPED>
        <<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
            part, rowsum, scale, zp, out + (size_t)ms * N, mslab, N, n_chunks,
            per_channel);
  }
}

// ---------------------------------------------------------------- wo8 ----

constexpr int kSlice = 32;          // K rows a slice (the summation order)
constexpr int kColThreads = 8;      // split form: column threads a block row
constexpr int kMaxCluster = 8;      // portable cluster size
constexpr int kSplitMaxRows = 64;   // the split form up to this M ...
constexpr long kSplitMaxOut = 256 * 1024;  // ... and M * N (card runs)
constexpr int kSplitThreads = 256;  // split form: at most 32 slice threads a block
constexpr size_t kSplitMaxSmem = 200 * 1024;
constexpr int kXPad = kSlice + 4;   // a padded slice row of x in shared memory

// (float)(w - z) for byte j of a word of four int8 weights: the byte + 128
// as the low mantissa bits of 2^23, less zc = 2^23 + 128 + z.  Exact.
__device__ __forceinline__ float w8_minus_z(unsigned word, int j, float zc) {
  const unsigned bits = __byte_perm(word ^ 0x80808080u, 0x4B000000u, 0x7650u | j);
  return __fsub_rn(__uint_as_float(bits), zc);
}

__device__ __forceinline__ float w8_zc(const int* zp, int n, int N, int per_channel) {
  return __int2float_rn(8388736 + (n < N ? zp[per_channel ? n : 0] : 0));
}

// CPT int8 columns of one weight row as CPT / 4 words: one vector load
// (the caller has checked alignment and range) or, at a ragged edge, bytes,
// with 0 past N and for rows at or past K (their factor is set to 0 where it
// is used).
template <int CPT>
__device__ __forceinline__ void w8_row_vec(const int8_t* __restrict__ src, unsigned* out) {
  if (CPT == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
    out[0] = v.x; out[1] = v.y;
  } else {
    out[0] = __ldg(reinterpret_cast<const unsigned*>(src));
  }
}

template <int CPT>
__device__ __forceinline__ void w8_row(const int8_t* __restrict__ w, int k, int K,
                                       int n, int N, bool vec, unsigned* out) {
  if (k < K && vec && n + CPT <= N) {
    w8_row_vec<CPT>(w + (size_t)k * N + n, out);
    return;
  }
#pragma unroll
  for (int q = 0; q < CPT / 4; ++q) {
    unsigned word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n + 4 * q + j;
      const unsigned b = (k < K && c < N) ? (uint8_t)w[(size_t)k * N + c] : 0u;
      word |= b << (8 * j);
    }
    out[q] = word;
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Split form.  grid ((K-range blocks C) x column tiles, row tiles of MR),
// cluster (C, 1, 1), C a power of two <= 8; block 8 x min(sb, 32) threads;
// block rank sums sb slices (slices rank * sb ...) and owns columns
// [rank * cw, (rank + 1) * cw) of the tile, cw = NC / C.  Each thread stores
// its slice partials straight into the shared memory of the block that owns
// their columns; after one cluster barrier every block folds its columns from
// its own shared memory.  Dynamic shared memory: x as [MR][sb][kXPad], the
// cluster's partials of this block's columns as [C * sb][MR][cw].
template <int MR, int CPT>
__global__ void __launch_bounds__(kSplitThreads)
wo8_split_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, const int* __restrict__ zp,
                 float* __restrict__ out, int M, int K, int N, int per_channel,
                 int sb, int vec) {
  constexpr int kWords = CPT / 4;
  constexpr int NC = kColThreads * CPT;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* gat = xs + (size_t)MR * sb * kXPad;

  cluster_arrive_relaxed();  // this block has started (its shared memory exists)
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.dim_blocks().x;
  const int rank = (int)cluster.block_rank();
  const int cw = NC / C;
  const int n0 = (blockIdx.x / C) * NC;
  const int m0 = blockIdx.y * MR;
  const int mt = min(MR, M - m0);
  const int S = (K + kSlice - 1) / kSlice;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int ct = tid % kColThreads, step = nthreads / kColThreads;
  const int n = n0 + ct * CPT;
  const int kb = rank * sb * kSlice;  // first k of this block
  const int dst = ct * CPT / cw, dcol = ct * CPT - dst * cw;  // owner of my columns

  unsigned wv[kSlice][kWords];
  auto load = [&](int ls) {
    const int k0 = kb + ls * kSlice;
    if (vec && n + CPT <= N && k0 + kSlice <= K) {  // the whole slice: 32 loads in flight
#pragma unroll
      for (int r = 0; r < kSlice; ++r) w8_row_vec<CPT>(w + (size_t)(k0 + r) * N + n, wv[r]);
    } else {
#pragma unroll
      for (int r = 0; r < kSlice; ++r) w8_row<CPT>(w, k0 + r, K, n, N, vec, wv[r]);
    }
  };
  int ls = tid / kColThreads;  // this thread's first slice in the block
  if (ls < sb) load(ls);       // in flight while x is staged

  for (int i = tid; i < MR * sb * kSlice; i += nthreads) {
    const int m = i / (sb * kSlice), j = i - m * (sb * kSlice);
    const int k = kb + j;
    xs[((size_t)m * sb + j / kSlice) * kXPad + j % kSlice] =
        (m < mt && k < K) ? x[(size_t)(m0 + m) * K + k] : 0.f;
  }
  float zc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) zc[j] = w8_zc(zp, n + j, N, per_channel);
  __syncthreads();
  cluster_wait();  // every block of the cluster has started
  float* dgat = cluster.map_shared_rank(gat, dst);

  while (ls < sb) {
    const int k0 = kb + ls * kSlice;
    float acc[MR][CPT];
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[m][j] = 0.f;
    if (k0 < K) {
#pragma unroll
      for (int r4 = 0; r4 < kSlice / 4; ++r4) {
        float4 xv[MR];
#pragma unroll
        for (int m = 0; m < MR; ++m)
          xv[m] = *reinterpret_cast<const float4*>(
              xs + ((size_t)m * sb + ls) * kXPad + 4 * r4);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = 4 * r4 + u;
          const bool live = k0 + r < K;
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const float wf = live ? w8_minus_z(wv[r][j / 4], j % 4, zc[j]) : 0.f;
#pragma unroll
            for (int m = 0; m < MR; ++m) {
              const float xm = u == 0 ? xv[m].x : u == 1 ? xv[m].y : u == 2 ? xv[m].z : xv[m].w;
              acc[m][j] = fmaf(xm, wf, acc[m][j]);
            }
          }
        }
      }
      const size_t sl = (size_t)rank * sb + ls;
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int j = 0; j < CPT; j += 4)
          *reinterpret_cast<float4*>(dgat + (sl * MR + m) * cw + dcol + j) =
              make_float4(acc[m][j], acc[m][j + 1], acc[m][j + 2], acc[m][j + 3]);
    }
    ls += step;
    if (ls < sb) load(ls);
  }
  cluster.sync();  // every partial has landed in its owner's shared memory

  for (int i = tid; i < mt * cw; i += nthreads) {
    const int m = i / cw, c = i - m * cw, nn = n0 + rank * cw + c;
    if (nn >= N) continue;
    float total = 0.f;
#pragma unroll 8
    for (int sl = 0; sl < S; ++sl) total = __fadd_rn(total, gat[((size_t)sl * MR + m) * cw + c]);
    out[(size_t)(m0 + m) * N + nn] = __fmul_rn(total, scale[per_channel ? nn : 0]);
  }
}

constexpr int kStages = 4;  // tiled form: slices in flight

// bytes of the tiled form's dynamic shared memory: the ring of x and weight
// stages and the converted slice; with a cluster of C > 1 also the gather of
// two rounds' partials (2 x BM x BN floats) and the running totals of this
// block's BM / C rows
template <int BM, int BN>
size_t tiled_smem(int C) {
  return (size_t)kStages * (sizeof(float) * BM * kXPad + kSlice * BN) +
         sizeof(float) * kSlice * BN +
         (C > 1 ? sizeof(float) * (2 * BM * BN + BM / C * BN) : 0);
}

// Tiled form: a BM x BN output tile a block, a TM x TN register tile a thread
// (columns in groups of 4, BN / (TN / 4) apart; rows in groups of 4, BM /
// (TM / 4) apart, or TM < 4 adjacent rows).  x (f32) and the weight (raw
// int8) arrive slice by slice in a ring of kStages shared-memory stages by
// cp.async (xch, wch: copy widths the strides and alignments allow); each
// slice's weights become (w - z) in f32 once, in a tile of their own, before
// the product.
//
// SPLIT: a cluster of C blocks shares one output tile and takes its slices
// in rounds: in round j block r sums slice j * C + r, so a round's C slice
// partials are consecutive in the order.  Each thread stores its partials
// into the shared memory of the block that owns their rows (block q owns
// rows [q, q + 1) * BM / C of the tile), one cluster barrier a round
// publishes them (two gather buffers: a buffer is written again two rounds
// later, after its owner has folded it), and every owner adds the round's C
// partials into its running totals in slice order: the unsplit tile's bits.
template <int BM, int BN, int TM, int TN, bool SPLIT>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
wo8_tiled_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, const int* __restrict__ zp,
                 float* __restrict__ out, int M, int K, int N, int per_channel,
                 int xch, int wch) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int RG = BM / (TM >= 4 ? TM / 4 : 1), CG = BN / (TN / 4);
  constexpr int XS = BM * kXPad;   // floats of an x stage
  constexpr int WS = kSlice * BN;  // bytes of a weight stage
  constexpr int CW = kSlice * BN / 4 / NT;  // weight words a thread converts a slice
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* wf = xs + kStages * XS;   // the slice's (w - z), [kSlice][BN]
  uint8_t* wsb = reinterpret_cast<uint8_t*>(wf + kSlice * BN);
  float* gat = reinterpret_cast<float*>(wsb + kStages * WS);  // SPLIT: [2][C][BM / C][BN]

  int C = 1, rank = 0;
  if (SPLIT) {
    cluster_arrive_relaxed();  // this block has started (its shared memory exists)
    C = (int)cg::this_cluster().dim_blocks().x;
    rank = (int)cg::this_cluster().block_rank();
  }
  const int OR = BM / C;            // SPLIT: rows a block owns
  float* tots = gat + 2 * BM * BN;  // SPLIT: this block's totals, [OR][BN]
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = (blockIdx.x / C) * BN;
  const int S = (K + kSlice - 1) / kSlice;
  const int R = (S + C - 1) / C;  // rounds: this block's slice of round j is j * C + rank
  const int lc = tid % (BN / 4), lr = tid / (BN / 4);  // converter word column, row
  auto row = [&](int i) { return TM >= 4 ? (i / 4) * RG + ty * 4 + i % 4 : ty * TM + i; };
  auto col = [&](int j) { return (j / 4) * CG + tx * 4 + j % 4; };

  auto issue = [&](int j) {
    const int s = j * C + rank;
    if (j < R && s < S) {
      const int k0 = s * kSlice;
      float* xd = xs + (j % kStages) * XS;
      uint8_t* wd = wsb + (j % kStages) * WS;
      const int xe = xch / 4, xcpr = kSlice / xe;
      for (int i = tid; i < BM * xcpr; i += NT) {
        const int m = i / xcpr, k = k0 + (i % xcpr) * xe;
        const bool live = m0 + m < M && k < K;
        copy_async(xd + m * kXPad + (i % xcpr) * xe,
                   live ? x + (size_t)(m0 + m) * K + k : x, xch, live);
      }
      const int wcpr = BN / wch;
      for (int i = tid; i < kSlice * wcpr; i += NT) {
        const int r = i / wcpr, nn = n0 + (i % wcpr) * wch;
        const bool live = k0 + r < K && nn < N;
        copy_async(wd + r * BN + (i % wcpr) * wch,
                   live ? w + (size_t)(k0 + r) * N + nn : w, wch, live);
      }
    }
    copy_commit();  // an empty group past the last slice keeps the count
  };

  float zc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) zc[j] = w8_zc(zp, n0 + 4 * lc + j, N, per_channel);
  float tot[TM][TN], acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) tot[i][j] = 0.f;
  if (SPLIT) {
    for (int o = tid; o < OR * BN; o += NT) tots[o] = 0.f;
    cluster_wait();  // every block of the cluster has started
  }

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue(j);
  for (int j = 0; j < R; ++j) {
    copy_wait<kStages - 2>();
    __syncthreads();  // round j's slice landed; every thread is done with the last one
    issue(j + kStages - 1);
    const int s = j * C + rank;
    if (s < S) {
      const int k0 = s * kSlice;
      const uint8_t* wt = wsb + (j % kStages) * WS;
#pragma unroll
      for (int p = 0; p < CW; ++p) {
        const int r = lr + p * (NT / (BN / 4));
        const unsigned word = *reinterpret_cast<const unsigned*>(wt + r * BN + 4 * lc);
        const bool live = k0 + r < K;
        float4 v;
        v.x = live ? w8_minus_z(word, 0, zc[0]) : 0.f;
        v.y = live ? w8_minus_z(word, 1, zc[1]) : 0.f;
        v.z = live ? w8_minus_z(word, 2, zc[2]) : 0.f;
        v.w = live ? w8_minus_z(word, 3, zc[3]) : 0.f;
        *reinterpret_cast<float4*>(wf + r * BN + 4 * lc) = v;
      }
      __syncthreads();
      const float* xt = xs + (j % kStages) * XS;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) acc[i][jj] = 0.f;
#pragma unroll
      for (int kq = 0; kq < kSlice / 4; ++kq) {
        float4 xv[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          xv[i] = *reinterpret_cast<const float4*>(xt + row(i) * kXPad + 4 * kq);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float wv[TN];
#pragma unroll
          for (int jj = 0; jj < TN; jj += 4) {
            const float4 v = *reinterpret_cast<const float4*>(
                wf + (4 * kq + u) * BN + (jj / 4) * CG + tx * 4);
            wv[jj] = v.x; wv[jj + 1] = v.y; wv[jj + 2] = v.z; wv[jj + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float xm = u == 0 ? xv[i].x : u == 1 ? xv[i].y : u == 2 ? xv[i].z : xv[i].w;
#pragma unroll
            for (int jj = 0; jj < TN; ++jj) acc[i][jj] = fmaf(xm, wv[jj], acc[i][jj]);
          }
        }
      }
      if (!SPLIT) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int jj = 0; jj < TN; ++jj) tot[i][jj] = __fadd_rn(tot[i][jj], acc[i][jj]);
      } else {
        cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int q = row(i) / OR;
          float* dst = cluster.map_shared_rank(gat, q) +
                       ((size_t)((j & 1) * C + rank) * OR + row(i) - q * OR) * BN;
#pragma unroll
          for (int jj = 0; jj < TN; jj += 4)
            *reinterpret_cast<float4*>(dst + col(jj)) =
                make_float4(acc[i][jj], acc[i][jj + 1], acc[i][jj + 2], acc[i][jj + 3]);
        }
      }
    }
    if (SPLIT) {
      cg::this_cluster().sync();  // round j's partials have landed in their owners
      const float* g = gat + (size_t)(j & 1) * C * OR * BN;
      const int live = min(C, S - j * C);
      for (int o = tid; o < OR * BN; o += NT) {
        float t = tots[o];
        for (int p = 0; p < live; ++p) t = __fadd_rn(t, g[(size_t)p * OR * BN + o]);
        tots[o] = t;
      }
    }
  }

  if (SPLIT) {
    for (int o = tid; o < OR * BN; o += NT) {
      const int m = m0 + rank * OR + o / BN, nn = n0 + o % BN;
      if (m < M && nn < N) out[(size_t)m * N + nn] = __fmul_rn(tots[o], scale[per_channel ? nn : 0]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + row(i);
    if (m >= M) continue;
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int nn = n0 + col(jj);
      if (nn < N) out[(size_t)m * N + nn] = __fmul_rn(tot[i][jj], scale[per_channel ? nn : 0]);
    }
  }
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

size_t split_smem(int mr, int cpt, int K, int C) {
  const int S = (K + kSlice - 1) / kSlice, sb = (S + C - 1) / C;
  return sizeof(float) * ((size_t)mr * sb * kXPad + (size_t)sb * mr * kColThreads * cpt);
}

// the split form's cluster: the fewest blocks (a power of two <= 8) a column
// tile that give the card a wave and fit in shared memory
int split_cluster(int M, int K, int N, int mr, int cpt) {
  const long tiles = (long)((N + kColThreads * cpt - 1) / (kColThreads * cpt)) * ((M + mr - 1) / mr);
  int C = 1;
  while (C < kMaxCluster && (C * tiles < sm_count() || split_smem(mr, cpt, K, C) > kSplitMaxSmem))
    C *= 2;
  return C;
}

template <int MR, int CPT>
cudaError_t launch_split(const float* x, const int8_t* w, const float* scale,
                         const int* zp, float* out, int M, int K, int N,
                         int per_channel, int C, cudaStream_t stream) {
  const int S = (K + kSlice - 1) / kSlice;
  const int sb = (S + C - 1) / C;
  const size_t smem = split_smem(MR, CPT, K, C);
  if (smem > kSplitMaxSmem) return cudaErrorInvalidValue;
  static size_t smem_set = 48 * 1024;  // this instance's dynamic shared memory limit
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        wo8_split_kernel<MR, CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const int vec = (N % CPT == 0) && ((uintptr_t)w % CPT == 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((N + kColThreads * CPT - 1) / (kColThreads * CPT)),
                     (M + MR - 1) / MR, 1);
  cfg.blockDim = dim3(kColThreads * min(sb, kSplitThreads / kColThreads), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, wo8_split_kernel<MR, CPT>, x, w, scale, zp, out,
                            M, K, N, per_channel, sb, vec);
}

// the tiled form, its K split over a cluster of C blocks (a power of two <= 8
// that divides BM) when C > 1
template <int BM, int BN, int TM, int TN>
cudaError_t launch_tiled(const float* x, const int8_t* w, const float* scale,
                         const int* zp, float* out, int M, int K, int N,
                         int per_channel, int C, cudaStream_t stream) {
  const size_t smem = tiled_smem<BM, BN>(C);
  const int xch = min(jlt::copy_width((uintptr_t)x | (uintptr_t)K * 4), 16);
  const int wch = min(jlt::copy_width((uintptr_t)w | (uintptr_t)N), BN);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((N + BN - 1) / BN), (M + BM - 1) / BM, 1);
  cfg.blockDim = dim3((BM / TM) * (BN / TN), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  if (C == 1) {
    auto kernel = wo8_tiled_kernel<BM, BN, TM, TN, false>;
    static bool smem_set = smem <= 48 * 1024;
    if (!smem_set) {
      cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      smem_set = true;
    }
    return cudaLaunchKernelEx(&cfg, kernel, x, w, scale, zp, out, M, K, N, per_channel, xch,
                              wch);
  }
  auto kernel = wo8_tiled_kernel<BM, BN, TM, TN, true>;
  static size_t smem_set = 48 * 1024;  // this instance's dynamic shared memory limit
  if (smem > smem_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, x, w, scale, zp, out, M, K, N, per_channel, xch, wch);
}

// the form by M: split for decode and short chunks, else tiled
cudaError_t launch_wo8(const float* x, const int8_t* w, const float* scale,
                       const int* zp, float* out, int M, int K, int N,
                       int per_channel, cudaStream_t stream) {
  const int mr = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : M <= 8 ? 8 : 16;
  const int cpt = mr <= 4 ? 8 : 4;
  const int C = split_cluster(M, K, N, mr, cpt);
  if (M <= kSplitMaxRows && (long)M * N <= kSplitMaxOut &&
      split_smem(mr, cpt, K, C) <= kSplitMaxSmem) {
    switch (mr) {
      case 1: return launch_split<1, 8>(x, w, scale, zp, out, M, K, N, per_channel, C, stream);
      case 2: return launch_split<2, 8>(x, w, scale, zp, out, M, K, N, per_channel, C, stream);
      case 4: return launch_split<4, 8>(x, w, scale, zp, out, M, K, N, per_channel, C, stream);
      case 8: return launch_split<8, 4>(x, w, scale, zp, out, M, K, N, per_channel, C, stream);
      default: return launch_split<16, 4>(x, w, scale, zp, out, M, K, N, per_channel, C, stream);
    }
  }
  // the largest tile that gives the card most of a wave of blocks; the
  // smallest tile's K split over the fewest blocks (up to 8) that give it 8
  // blocks an SM (thresholds from card runs)
  auto blocks = [&](int t) { return (long)((M + t - 1) / t) * ((N + t - 1) / t); };
  const long wave = sm_count();
  if (blocks(128) * 10 >= wave * 9)
    return launch_tiled<128, 128, 8, 8>(x, w, scale, zp, out, M, K, N, per_channel, 1, stream);
  if (blocks(64) * 10 >= wave * 7)
    return launch_tiled<64, 64, 4, 4>(x, w, scale, zp, out, M, K, N, per_channel, 1, stream);
  int tc = 1;
  while (tc < kMaxCluster && blocks(32) * tc < 8 * wave) tc *= 2;
  return launch_tiled<32, 32, 2, 4>(x, w, scale, zp, out, M, K, N, per_channel, tc, stream);
}

}  // namespace

extern "C" {

// int4 (wo4, wo4g).  Workspace: part holds n_chunks * min(M, 256) * N
// floats, rowsum n_chunks * min(M, 256) floats, n_chunks = ceil(ceil(K / 2)
// / 128).  group_size > 0 selects wo4g (int4 only, K
// even, group_size and K / 2 multiples of 128; scale (G, N), zp unread);
// anything else it refuses with cudaErrorInvalidValue.  Returns
// cudaGetLastError().
int jlt_wo_matmul(const void* x, const void* w, const void* scale,
                  const void* zp, void* out, void* part, void* rowsum, int M,
                  int K, int N, int per_channel, int int4, int group_size,
                  void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* xf = (const float*)x;
  const int8_t* wb = (const int8_t*)w;
  const float* sf = (const float*)scale;
  const int* zi = (const int*)zp;
  if (group_size > 0) {
    if (!int4 || K % 2 || group_size % kChunk || (K / 2) % kChunk)
      return (int)cudaErrorInvalidValue;
    launch<true>(xf, wb, sf, zi, (float*)out, (float*)part, (float*)rowsum, M, K,
                 N, per_channel, group_size, s);
  } else if (int4) {
    launch<false>(xf, wb, sf, zi, (float*)out, (float*)part, (float*)rowsum, M, K,
                  N, per_channel, 0, s);
  } else {
    return (int)cudaErrorInvalidValue;  // int8: jlt_wo8
  }
  return (int)cudaGetLastError();
}

// wo8: x f32 (M, K), w int8 (K, N), scale f32 / zp int32 (N,) or (1,), out
// f32 (M, N); one kernel launch, no workspace, the form chosen by M (the
// same bits in either).  Returns the launch's error, else cudaGetLastError().
int jlt_wo8(const void* x, const void* w, const void* scale, const void* zp,
            void* out, int M, int K, int N, int per_channel, void* stream) {
  cudaError_t err = launch_wo8((const float*)x, (const int8_t*)w, (const float*)scale,
                               (const int*)zp, (float*)out, M, K, N, per_channel,
                               reinterpret_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The int4 lab: x f32 (M, K); w int8 bytes (ceil(K / 2), N) split-half
// (native = 0, wo4_bf16) or (K / 2, N) K-contiguous (native = 1, wo4_native;
// odd K: cudaErrorInvalidValue); scale f32 (N,); out f32 (M, N); part as
// for jlt_wo_matmul's int4.  Returns cudaGetLastError().
int jlt_wo4_lab(const void* x, const void* w, const void* scale, void* out,
                void* part, int M, int K, int N, int native, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* xf = (const float*)x;
  const int8_t* wb = (const int8_t*)w;
  const float* sf = (const float*)scale;
  if (native) {
    if (K % 2) return (int)cudaErrorInvalidValue;
    launch<false, kStageKContig>(xf, wb, sf, nullptr, (float*)out, (float*)part,
                                 nullptr, M, K, N, 1, 0, s);
  } else {
    launch<false, kStageBf16>(xf, wb, sf, nullptr, (float*)out, (float*)part,
                              nullptr, M, K, N, 1, 0, s);
  }
  return (int)cudaGetLastError();
}

int jlt_wo_chunk_rows() { return kChunk; }
int jlt_wo_slab_rows() { return kSlab; }

const char* jlt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
