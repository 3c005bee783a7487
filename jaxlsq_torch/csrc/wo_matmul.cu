// Weight-only int8 / int4 matmul with the dequant fused in:
//   out[m, n] = s[n] * sum_k x[m, k] * (w[k, n] - z[n])
// x f32 (M, K) row-major; w int8 (K, N) (wo8), or int4 split-half bytes
// (ceil(K/2), N) (wo4) whose byte row r holds k = r (low nibble) and
// k = r + ceil(K/2) (high nibble); s f32 / z int32 per output channel (N,) or
// per tensor (1,), z in the int8 carrier's [-128, 127] (as the pack's
// _fold_qparams clamps it).
//
// Group-wise int4 (wo4g): the same bytes, s f32 (G, N), one row per group of
// gs rows of K, no zero point (symmetric):
//   out[m, n] = sum_k x[m, k] * (w[k, n] * s[k / gs, n])
//
// Replaces the TPU kernels jaxlsq/serve/matmul.py:_wo8_kernel (launched at
// :255), _wo4_kernel (:93, launched at :317) and _wo4g_kernel (:147, launched
// at :298).  One launch a call, no workspace.
//
// ---- wo8 and wo4: the tensor cores, one order for every M ----
//
// wo8 and wo4 run mma_bf16.cuh's body (bf16 mma.sync m16n8k16 -> f32, the
// weight as the A operand decoded in registers; its header maps the
// operands).  Their order depends on K alone, never on M, the form, the tile
// or the cluster size:
//   1. x[m, k] = hi + mid + lo, each bf16_rn of the remainder (exact for |x|
//      in [2^-110, 2^127) and 0).
//   2. The factor is (w - z) as an exact bf16: wo8 w - z in [-255, 255], wo4
//      v - z in [-135, 136], every integer up to 256 in magnitude being a
//      bf16.  So every product is exact.
//   3. The k-steps (16 values of k: wo8 16 weight rows, wo4 8 byte rows, low
//      nibbles then high) are cut into slices of kWoSliceSteps = 4 (64 k), the
//      last padded with zero bytes and x = 0.
//   4. A slice partial is the tensor cores' chain from +0 over its k-steps in
//      order, with hi, mid and lo at each k-step.
//   5. The even slices' partials are left-folded in slice order from +0 in
//      f32 (__fadd_rn) into q0, the odd slices' into q1.
//   6. out = (q0 + q1) * s[n].
//   7. Odd K (wo4): the dead high nibble of the last byte row has x = 0.
// So a row gives the same bits at any M, in any row tile, in either form and
// at any cluster size: at B = 1 and B = 8, in prefill and decode.
//
// What bounds them on an H100: at decode M the weight bytes streamed once; at
// prefill M the tensor cores, 3 x 2 M K N at 989 TFLOP/s bf16 (a fifth of
// the f32 CUDA cores' bound; mma.sync reaches part of it).  M alone picks the
// form (thresholds from card runs): the decode form up to M = 16 (one or two
// n8 tiles of rows, K over a cluster; the widest column tile and block that
// still spread over most of the card), the tiled form above it with 64-row
// tiles where they give the card most of a wave of blocks, else 16-row tiles
// (the N = 1024 and 3072 shapes at M = 256: four times the blocks).
//
// ---- wo4g: f32 FMAs on the CUDA cores ----
//
// Its order depends on K and kSlice alone.  The ceil(K/2) byte rows are cut
// into slices of kSlice = 32 consecutive rows, padded with zero rows to a
// whole slice.
//   1. A slice partial is one fmaf chain from +0 over the slice's factors in
//      order: for each byte row r ascending its low nibble (factor times
//      x[m, r]) and then its high nibble (times x[m, r + ceil(K/2)]): 64
//      terms a slice.
//   2. The factors are exact f32 values (float)w * s[k / gs, n], rounded
//      once: the plain dequant's element, bit for bit.  A slice's low nibbles
//      lie in one group and its high nibbles in one, because the wrapper
//      keeps gs and K / 2 multiples of 128 (a multiple of 32 would do; 128 is
//      the TPU kernel's lane tile).
//   3. Padding (rows past the weight's) has x = 0 and factor 0.
//   4. The slice partials are left-folded in ascending slice order from +0
//      (total = 0; total += p0; total += p1; ...): out = total.
// So a row gives the same bits at any M, in any row tile and in either form
// below.
//
// At decode M every weight byte is used M times (2M multiply-adds), far below
// the card's ~20 f32 operations per byte of bandwidth, so it is bound by
// streaming the weight bytes once; at prefill M (M = 256 and up) by the f32
// FMAs.  Two forms, chosen by M (thresholds from card runs):
//
// Split form (M <= 64 and M * N <= 256K: decode and short chunks).  A thread
// owns CPT byte columns (8 or 4: 4 for up to 4 rows where a thread then walks
// no more slices) and one slice at a time: it issues all 32 row loads of the
// slice before it uses any.  A block is 8 column threads x up to 32 slice
// threads; the K slices of a column tile are spread over a thread-block
// cluster of C blocks (Hopper's distributed shared memory; C a power of two
// <= 8, the fewest that give the card a wave and fit in shared memory), block
// r owning the tile's r-th C-th of the columns.  The block's x sits in shared
// memory in the order of the chain (x[r], x[r + ceil(K/2)], x[r + 1], ...).
// Each thread stores its slice partials straight into the shared memory of
// the block that owns their columns; after one cluster barrier every block
// folds its columns in slice order from its own shared memory and writes out.
// The row count is a template (1, 2, 4, 8; at most 4 up to M = 8 and 8
// above), so M = 1 holds 8 accumulators a thread; further rows go to further
// row tiles (gridDim.y).
//
// A factor is three instructions: the nibble ^ 8 (one xor and one mask a
// word of 8 nibbles) as the low mantissa bits of 2^23 (a byte permute), less
// 2^23 + 8, exact for every 4-bit value, times the group's scale.
//
// Tiled form (larger M: prefill).  A register-tiled product: a block owns a
// BM x BN output tile; x (f32, both K ranges interleaved as in the chain, by
// 4-byte copies), the raw weight bytes and the slice's two rows of group
// scales arrive slice by slice through a ring of 2 shared-memory stages by
// cp.async, each slice's bytes become f32 factors once (two rows of factors
// a byte row), and each thread keeps a per-slice accumulator that it adds
// into its running total at every slice's end: the split form's bits.  The
// tile (128 x 128, 64 x 64) is the largest that gives the card most of a
// wave of blocks; where neither does (N = 1024 up to M = 320), 32 x 32 tiles
// of 2 x 4 a thread take the K slices in rounds over a cluster of up to 8
// blocks (slice j * C + r to block r), which fold each round's C consecutive
// partials in slice order: the same bits again.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"
#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

// ------------------------------------------------------------- wo4g ----

constexpr int kSlice = 32;          // byte rows a slice
constexpr int kFactors = 2 * kSlice;  // factors (and x values) a slice
constexpr int kXPad = kFactors + 4;   // a slice's row of x in shared memory, padded
constexpr int kStages = 2;          // the tiled form's ring stages
constexpr int kColThreads = 8;      // split form: column threads a block row
constexpr int kMaxCluster = 8;      // portable cluster size
constexpr int kSplitMaxRows = 64;   // the split form up to this M ...
constexpr long kSplitMaxOut = 256 * 1024;  // ... and M * N (card runs)
constexpr int kSplitThreads = 256;  // split form: at most 32 slice threads a block
constexpr size_t kSplitMaxSmem = 200 * 1024;
constexpr int kGroupRows = 128;     // wo4g: gs and K / 2 multiples of this
constexpr float kNibbleBias = 8388616.f;  // 2^23 + 8

// A call's arguments, as the launch code passes them on.  The kernels take
// them as separate __restrict__ parameters (passed as this struct, the tiled
// form ran 4% slower in card runs).
struct WoArgs {
  const float* x;
  const int8_t* w;
  const float* scale;  // (N,) or (1,); wo4g (G, N)
  const int* zp;       // (N,) or (1,); wo4g: not read
  float* out;
  int M, K, N, per_channel, gs;
};

// The unsigned value of byte j of a word (< 256) as the low mantissa bits of
// 2^23, less 2^23 + 8: (float)w, exact.
__device__ __forceinline__ float mant_minus(unsigned word, int j) {
  const unsigned bits = __byte_perm(word, 0x4B000000u, 0x7650u | j);
  return __fsub_rn(__uint_as_float(bits), kNibbleBias);
}

// the 4 low / high nibbles of a weight word as unsigned values: the nibble + 8
__device__ __forceinline__ unsigned biased4(unsigned word, int high) {
  const unsigned t = word ^ 0x88888888u;
  return (high ? t >> 4 : t) & 0x0F0F0F0Fu;
}

// factor v of a slice's byte row word (v = 2 * row + nibble) for byte j; slo,
// shi: the slice's low- and high-nibble group scales of that column
__device__ __forceinline__ float factor(unsigned word, int v, int j, float slo, float shi) {
  return __fmul_rn(mant_minus(biased4(word, v & 1), j), (v & 1) ? shi : slo);
}

// the group scale of row k of K and column n (0 past N)
__device__ __forceinline__ float group_scale(const float* __restrict__ scale, int gs, int k,
                                             int n, int N) {
  return n < N ? __ldg(scale + (size_t)(k / gs) * N + n) : 0.f;
}

// CPT byte columns of one weight row as CPT / 4 words: one vector load
// (the caller has checked alignment and range) or, at a ragged edge, bytes,
// with 0 past N and for rows at or past R.
template <int CPT>
__device__ __forceinline__ void w_row_vec(const int8_t* __restrict__ src, unsigned* out) {
  if (CPT == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
    out[0] = v.x; out[1] = v.y;
  } else {
    out[0] = __ldg(reinterpret_cast<const unsigned*>(src));
  }
}

template <int CPT>
__device__ __forceinline__ void w_row(const int8_t* __restrict__ w, int r, int R,
                                      int n, int N, bool vec, unsigned* out) {
  if (r < R && vec && n + CPT <= N) {
    w_row_vec<CPT>(w + (size_t)r * N + n, out);
    return;
  }
#pragma unroll
  for (int q = 0; q < CPT / 4; ++q) {
    unsigned word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n + 4 * q + j;
      const unsigned b = (r < R && c < N) ? (uint8_t)w[(size_t)r * N + c] : 0u;
      word |= b << (8 * j);
    }
    out[q] = word;
  }
}

// is factor v of the slice starting at byte row r0 inside the weight (not
// padding); K is even
__device__ __forceinline__ bool live(int r0, int v, int K) { return r0 + v / 2 < K / 2; }

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
wo_split_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, float* __restrict__ out, int M, int K,
                int N, int gs, int sb, int vec) {
  constexpr int kWords = CPT / 4;
  constexpr int NC = kColThreads * CPT;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* gat = xs + (size_t)MR * sb * kXPad;

  jlt::mma::cluster_arrive_relaxed();  // this block has started (its shared memory exists)
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.dim_blocks().x;
  const int rank = (int)cluster.block_rank();
  const int cw = NC / C;
  const int KR = K / 2;  // byte rows
  const int n0 = (blockIdx.x / C) * NC;
  const int m0 = blockIdx.y * MR;
  const int mt = min(MR, M - m0);
  const int S = (KR + kSlice - 1) / kSlice;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int ct = tid % kColThreads, step = nthreads / kColThreads;
  const int n = n0 + ct * CPT;
  const int rb = rank * sb * kSlice;  // first byte row of this block
  const int dst = ct * CPT / cw, dcol = ct * CPT - dst * cw;  // owner of my columns

  unsigned wv[kSlice][kWords];
  float slo[CPT] = {}, shi[CPT] = {};  // the slice's group scales
  auto load = [&](int ls) {
    const int r0 = rb + ls * kSlice;
    if (vec && n + CPT <= N && r0 + kSlice <= KR) {  // the whole slice: 32 loads in flight
#pragma unroll
      for (int r = 0; r < kSlice; ++r) w_row_vec<CPT>(w + (size_t)(r0 + r) * N + n, wv[r]);
    } else {
#pragma unroll
      for (int r = 0; r < kSlice; ++r) w_row<CPT>(w, r0 + r, KR, n, N, vec, wv[r]);
    }
    if (r0 < KR) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        slo[j] = group_scale(scale, gs, r0, n + j, N);
        shi[j] = group_scale(scale, gs, r0 + KR, n + j, N);
      }
    }
  };
  int ls = tid / kColThreads;  // this thread's first slice in the block
  if (ls < sb) load(ls);       // in flight while x is staged

  for (int i = tid; i < MR * sb * kFactors; i += nthreads) {
    const int m = i / (sb * kFactors), j = i - m * (sb * kFactors), v = j % kFactors;
    const int r = rb + (j / kFactors) * kSlice + v / 2;
    const int k = r + (v & 1) * KR;
    xs[((size_t)m * sb + j / kFactors) * kXPad + v] =
        (m < mt && r < KR) ? x[(size_t)(m0 + m) * K + k] : 0.f;
  }
  __syncthreads();
  jlt::mma::cluster_wait();  // every block of the cluster has started
  float* dgat = cluster.map_shared_rank(gat, dst);

  float acc[MR][CPT];
  // the slice's chain; GUARDED zeroes the padding's factors
  auto product = [&](int r0, auto guarded) {
    constexpr bool GUARDED = decltype(guarded)::value;
#pragma unroll
    for (int v4 = 0; v4 < kFactors / 4; ++v4) {
      float4 xv[MR];
#pragma unroll
      for (int m = 0; m < MR; ++m)
        xv[m] = *reinterpret_cast<const float4*>(xs + ((size_t)m * sb + ls) * kXPad + 4 * v4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int v = 4 * v4 + u;
        const unsigned* word = wv[v / 2];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          float wf = factor(word[j / 4], v, j % 4, slo[j], shi[j]);
          if (GUARDED && !live(r0, v, K)) wf = 0.f;
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            const float xm = u == 0 ? xv[m].x : u == 1 ? xv[m].y : u == 2 ? xv[m].z : xv[m].w;
            acc[m][j] = fmaf(xm, wf, acc[m][j]);
          }
        }
      }
    }
  };

  while (ls < sb) {
    const int r0 = rb + ls * kSlice;
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[m][j] = 0.f;
    if (r0 < KR) {
      if (r0 + kSlice <= KR)
        product(r0, std::false_type());
      else
        product(r0, std::true_type());
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
    out[(size_t)(m0 + m) * N + nn] = total;
  }
}

// bytes of the tiled form's dynamic shared memory: the ring of x, weight and
// group-scale stages and the slice's factors; with a cluster of C > 1 also
// the gather of two rounds' partials (2 x BM x BN floats) and the running
// totals of this block's BM / C rows
template <int BM, int BN>
size_t tiled_smem(int C) {
  return (size_t)kStages * (sizeof(float) * BM * kXPad + kSlice * BN + sizeof(float) * 2 * BN) +
         sizeof(float) * kFactors * BN +
         (C > 1 ? sizeof(float) * (2 * BM * BN + BM / C * BN) : 0);
}

// Tiled form: a BM x BN output tile a block, a TM x TN register tile a thread
// (columns in groups of 4, BN / (TN / 4) apart; rows in groups of 4, BM /
// (TM / 4) apart, or TM < 4 adjacent rows).  x (f32), the weight (raw bytes)
// and the slice's two rows of group scales arrive slice by slice in a ring of
// kStages shared-memory stages by cp.async (wch: the copy width the stride
// and alignment allow; the interleaved x and the scales by 4 bytes); each
// slice's bytes become f32 factors once, in a tile of their own
// ([factors][BN], in the chain's order), before the product.
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
wo_tiled_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, float* __restrict__ out, int M, int K,
                int N, int gs, int wch) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int RG = BM / (TM >= 4 ? TM / 4 : 1), CG = BN / (TN / 4);
  constexpr int XS = BM * kXPad;   // floats of an x stage
  constexpr int WS = kSlice * BN;  // bytes of a weight stage
  constexpr int CW = kSlice * BN / 4 / NT;  // weight words a thread converts a slice
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* wf = xs + kStages * XS;   // the slice's factors, [kFactors][BN]
  uint8_t* wsb = reinterpret_cast<uint8_t*>(wf + kFactors * BN);
  float* sgs = reinterpret_cast<float*>(wsb + kStages * WS);  // [kStages][2][BN] group scales
  float* gat = sgs + kStages * 2 * BN;  // SPLIT: [2][C][BM / C][BN]

  int C = 1, rank = 0;
  if (SPLIT) {
    jlt::mma::cluster_arrive_relaxed();  // this block has started (its shared memory exists)
    C = (int)cg::this_cluster().dim_blocks().x;
    rank = (int)cg::this_cluster().block_rank();
  }
  const int KR = K / 2;  // byte rows
  const int OR = BM / C;            // SPLIT: rows a block owns
  float* tots = gat + 2 * BM * BN;  // SPLIT: this block's totals, [OR][BN]
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = (blockIdx.x / C) * BN;
  const int S = (KR + kSlice - 1) / kSlice;
  const int nr = (S + C - 1) / C;  // rounds: this block's slice of round j is j * C + rank
  const int lc = tid % (BN / 4), lr = tid / (BN / 4);  // converter word column, row
  auto row = [&](int i) { return TM >= 4 ? (i / 4) * RG + ty * 4 + i % 4 : ty * TM + i; };
  auto col = [&](int j) { return (j / 4) * CG + tx * 4 + j % 4; };

  auto issue = [&](int j) {
    const int s = j * C + rank;
    if (j < nr && s < S) {
      const int r0 = s * kSlice;
      float* xd = xs + (j % kStages) * XS;
      uint8_t* wd = wsb + (j % kStages) * WS;
      // x[r], x[r + KR] interleaved, as the chain takes them
      for (int i = tid; i < BM * kFactors; i += NT) {
        const int m = i / kFactors, v = i % kFactors, r = r0 + v / 2, k = r + (v & 1) * KR;
        const bool ok = m0 + m < M && r < KR;
        jlt::copy_async(xd + m * kXPad + v, ok ? x + (size_t)(m0 + m) * K + k : x, 4, ok);
      }
      const int wcpr = BN / wch;
      for (int i = tid; i < kSlice * wcpr; i += NT) {
        const int r = i / wcpr, nn = n0 + (i % wcpr) * wch;
        const bool ok = r0 + r < KR && nn < N;
        jlt::copy_async(wd + r * BN + (i % wcpr) * wch,
                        ok ? w + (size_t)(r0 + r) * N + nn : w, wch, ok);
      }
      // the low nibbles' group row, then the high nibbles'
      float* sd = sgs + (j % kStages) * 2 * BN;
      for (int i = tid; i < 2 * BN; i += NT) {
        const int k = r0 + (i / BN) * KR, nn = n0 + i % BN;
        const bool ok = nn < N;
        jlt::copy_async(sd + i, ok ? scale + (size_t)(k / gs) * N + nn : scale, 4, ok);
      }
    }
    jlt::copy_commit();  // an empty group past the last slice keeps the count
  };

  float tot[TM][TN], acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) tot[i][j] = 0.f;
  if (SPLIT) {
    for (int o = tid; o < OR * BN; o += NT) tots[o] = 0.f;
    jlt::mma::cluster_wait();  // every block of the cluster has started
  }

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue(j);
  for (int j = 0; j < nr; ++j) {
    jlt::copy_wait<kStages - 2>();
    __syncthreads();  // round j's slice landed; every thread is done with the last one
    issue(j + kStages - 1);
    const int s = j * C + rank;
    if (s < S) {
      const int r0 = s * kSlice;
      const uint8_t* wt = wsb + (j % kStages) * WS;
      float slo[4], shi[4];  // this converter's columns' group scales
      const float* sg = sgs + (j % kStages) * 2 * BN + 4 * lc;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        slo[q] = sg[q];
        shi[q] = sg[BN + q];
      }
#pragma unroll
      for (int p = 0; p < CW; ++p) {
        const int r = lr + p * (NT / (BN / 4));
        const unsigned word = *reinterpret_cast<const unsigned*>(wt + r * BN + 4 * lc);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int v = 2 * r + h;
          const bool ok = live(r0, v, K);
          float4 f;
          f.x = ok ? factor(word, v, 0, slo[0], shi[0]) : 0.f;
          f.y = ok ? factor(word, v, 1, slo[1], shi[1]) : 0.f;
          f.z = ok ? factor(word, v, 2, slo[2], shi[2]) : 0.f;
          f.w = ok ? factor(word, v, 3, slo[3], shi[3]) : 0.f;
          *reinterpret_cast<float4*>(wf + v * BN + 4 * lc) = f;
        }
      }
      __syncthreads();
      const float* xt = xs + (j % kStages) * XS;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) acc[i][jj] = 0.f;
#pragma unroll
      for (int kq = 0; kq < kFactors / 4; ++kq) {
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
      const int nlive = min(C, S - j * C);
      for (int o = tid; o < OR * BN; o += NT) {
        float t = tots[o];
        for (int p = 0; p < nlive; ++p) t = __fadd_rn(t, g[(size_t)p * OR * BN + o]);
        tots[o] = t;
      }
    }
  }

  if (SPLIT) {
    for (int o = tid; o < OR * BN; o += NT) {
      const int m = m0 + rank * OR + o / BN, nn = n0 + o % BN;
      if (m < M && nn < N) out[(size_t)m * N + nn] = tots[o];
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
      if (nn < N) out[(size_t)m * N + nn] = tot[i][jj];
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
  const int S = (K / 2 + kSlice - 1) / kSlice, sb = (S + C - 1) / C;
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

cudaLaunchAttribute cluster_attr(int C) {
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

template <int MR, int CPT>
cudaError_t launch_split(const WoArgs& a, int C, cudaStream_t stream) {
  const int S = (a.K / 2 + kSlice - 1) / kSlice;
  const int sb = (S + C - 1) / C;
  const size_t smem = split_smem(MR, CPT, a.K, C);
  if (smem > kSplitMaxSmem) return cudaErrorInvalidValue;
  static size_t smem_set = 48 * 1024;  // this instance's dynamic shared memory limit
  cudaError_t err = jlt::mma::allow_smem(wo_split_kernel<MR, CPT>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const int vec = (a.N % CPT == 0) && ((uintptr_t)a.w % CPT == 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((a.N + kColThreads * CPT - 1) / (kColThreads * CPT)),
                     (a.M + MR - 1) / MR, 1);
  cfg.blockDim = dim3(kColThreads * min(sb, kSplitThreads / kColThreads), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1] = {cluster_attr(C)};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, wo_split_kernel<MR, CPT>, a.x, a.w, a.scale, a.out, a.M, a.K,
                            a.N, a.gs, sb, vec);
}

// the tiled form, its K split over a cluster of C blocks (a power of two <= 8
// that divides BM) when C > 1
template <int BM, int BN, int TM, int TN>
cudaError_t launch_tiled(const WoArgs& a, int C, cudaStream_t stream) {
  const size_t smem = tiled_smem<BM, BN>(C);
  const int wch = min(jlt::copy_width((uintptr_t)a.w | (uintptr_t)a.N), BN);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((a.N + BN - 1) / BN), (a.M + BM - 1) / BM, 1);
  cfg.blockDim = dim3((BM / TM) * (BN / TN), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  if (C == 1) {
    auto kernel = wo_tiled_kernel<BM, BN, TM, TN, false>;
    static size_t smem_set = 48 * 1024;
    cudaError_t err = jlt::mma::allow_smem(kernel, smem, smem_set);
    if (err != cudaSuccess) return err;
    return cudaLaunchKernelEx(&cfg, kernel, a.x, a.w, a.scale, a.out, a.M, a.K, a.N, a.gs, wch);
  }
  auto kernel = wo_tiled_kernel<BM, BN, TM, TN, true>;
  static size_t smem_set = 48 * 1024;  // this instance's dynamic shared memory limit
  cudaError_t err = jlt::mma::allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1] = {cluster_attr(C)};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a.x, a.w, a.scale, a.out, a.M, a.K, a.N, a.gs, wch);
}

// wo4g: the form by M, split for decode and short chunks, else tiled
cudaError_t launch_wo4g(const WoArgs& a, cudaStream_t stream) {
  const int M = a.M, N = a.N;
  // rows a block: at most 4 up to M = 8 and 8 above (card runs)
  const int mr = M <= 1 ? 1 : M <= 2 ? 2 : M <= 8 ? 4 : 8;
  int cpt = mr <= 4 ? 8 : 4;
  // up to 4 rows: 4 columns a thread (twice the threads) unless that makes a
  // thread walk more slices one after another than 8 columns do (card runs:
  // faster at the d1024 shapes, slower at K = N = 8192)
  auto walk = [&](int c) {
    const int C = split_cluster(M, a.K, N, mr, c);
    const int S = (a.K / 2 + kSlice - 1) / kSlice, sb = (S + C - 1) / C;
    return (sb + kSplitThreads / kColThreads - 1) / (kSplitThreads / kColThreads);
  };
  if (cpt == 8 && walk(4) <= walk(8)) cpt = 4;
  const int C = split_cluster(M, a.K, N, mr, cpt);
  if (M <= kSplitMaxRows && (long)M * N <= kSplitMaxOut &&
      split_smem(mr, cpt, a.K, C) <= kSplitMaxSmem) {
    if (cpt == 4) {
      switch (mr) {
        case 1: return launch_split<1, 4>(a, C, stream);
        case 2: return launch_split<2, 4>(a, C, stream);
        case 4: return launch_split<4, 4>(a, C, stream);
        default: return launch_split<8, 4>(a, C, stream);
      }
    }
    switch (mr) {
      case 1: return launch_split<1, 8>(a, C, stream);
      case 2: return launch_split<2, 8>(a, C, stream);
      default: return launch_split<4, 8>(a, C, stream);
    }
  }
  // the largest tile that gives the card most of a wave of blocks; the
  // smallest tile's K split over the fewest blocks (up to 8) that give it 8
  // blocks an SM (thresholds from card runs)
  auto blocks = [&](int t) { return (long)((M + t - 1) / t) * ((N + t - 1) / t); };
  const long wave = sm_count();
  if (blocks(128) * 10 >= wave * 9) return launch_tiled<128, 128, 8, 8>(a, 1, stream);
  if (blocks(64) * 10 >= wave * 7) return launch_tiled<64, 64, 4, 4>(a, 1, stream);
  int tc = 1;
  while (tc < kMaxCluster && blocks(32) * tc < 8 * wave) tc *= 2;
  return launch_tiled<32, 32, 2, 4>(a, tc, stream);
}

// ------------------------------------------------------------ wo8, wo4 ----

namespace mma = jlt::mma;

constexpr int kWoSliceSteps = 4;  // k-steps (64 k) a slice of wo8 and wo4
using Wo8 = mma::Op<mma::kInt8, 3, kWoSliceSteps, true>;
using Wo4 = mma::Op<mma::kSplitHalf4, 3, kWoSliceSteps, true>;

template <class F, int NT, int WT, int DW>
__global__ void __launch_bounds__(32 * DW)
wo_mma_decode_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ scale, const int* __restrict__ zp,
                     float* __restrict__ out, int M, int K, int N, int per_channel, int wch) {
  mma::decode_body<F, NT, WT, DW>(x, w, scale, zp, out, M, K, N, per_channel, wch);
}

template <class F, int TR>
__global__ void __launch_bounds__(mma::kThreads)
wo_mma_tiled_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, const int* __restrict__ zp,
                    float* __restrict__ out, int M, int K, int N, int per_channel, int xvec,
                    int wch) {
  mma::tiled_body<F, TR>(x, w, scale, zp, out, M, K, N, per_channel, xvec, wch);
}

template <class F, int NT, int WT, int DW>
cudaError_t launch_mma_decode(const WoArgs& a, cudaStream_t stream) {
  return mma::launch_decode<F, NT, WT, DW>(wo_mma_decode_kernel<F, NT, WT, DW>, a.x, a.w, a.scale,
                                           a.zp, a.out, a.M, a.K, a.N, a.per_channel, stream);
}

template <class F, int TR>
cudaError_t launch_mma_tiled(const WoArgs& a, cudaStream_t stream) {
  return mma::launch_tiled<F, TR>(wo_mma_tiled_kernel<F, TR>, a.x, a.w, a.scale, a.zp, a.out,
                                  a.M, a.K, a.N, a.per_channel, stream);
}

// wo8 / wo4: the form by M (thresholds from card runs).  The decode form up
// to 16 rows, K over clusters of up to 8 blocks, a part a slice: up to 8
// rows the first of (wo4 only: 128-column tiles, 8 warps a block), (64
// columns, 8 warps), (64 columns, 4 warps) that gives the card 0.6 of a
// wave of blocks; above, the tiled form with 64-row tiles where they give
// the card 0.9 of a wave of blocks, else 16-row tiles.
template <class F>
cudaError_t launch_wo_mma(const WoArgs& a, cudaStream_t stream) {
  const long sms = sm_count();
  if (a.M > 8 && a.M <= 16) return launch_mma_decode<F, 2, 4, 8>(a, stream);
  if (a.M <= 8) {
    // does a choice fill 0.6 of the card: its column tiles times the largest
    // cluster the slices allow
    auto fills = [&](int wt, int dw) {
      int c = 1;
      while (2 * c <= mma::kMaxCluster && dw * 2 * c <= mma::slices<F>(a.K)) c *= 2;
      return (long)((a.N + 16 * wt - 1) / (16 * wt)) * c * 10 >= sms * 6;
    };
    if constexpr (F::kLayout == mma::kSplitHalf4)
      if (fills(8, 8)) return launch_mma_decode<F, 1, 8, 8>(a, stream);
    if (fills(4, 8)) return launch_mma_decode<F, 1, 4, 8>(a, stream);
    return launch_mma_decode<F, 1, 4, 4>(a, stream);
  }
  const long blocks64 = (long)((a.N + mma::kTCols - 1) / mma::kTCols) * ((a.M + 63) / 64);
  if (blocks64 * 10 >= sms * 9) return launch_mma_tiled<F, 64>(a, stream);
  return launch_mma_tiled<F, 16>(a, stream);
}

}  // namespace

extern "C" {

// wo8: x f32 (M, K), w int8 (K, N), scale f32 / zp int32 (N,) or (1,), out
// f32 (M, N); one kernel launch, no workspace, the form chosen by M (the
// same bits in either).  Returns the launch's error, else cudaGetLastError().
int jlt_wo8(const void* x, const void* w, const void* scale, const void* zp,
            void* out, int M, int K, int N, int per_channel, void* stream) {
  const WoArgs a = {(const float*)x, (const int8_t*)w, (const float*)scale, (const int*)zp,
                    (float*)out, M, K, N, per_channel, 0};
  cudaError_t err = launch_wo_mma<Wo8>(a, reinterpret_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// wo4 / wo4g: x f32 (M, K), w int8 split-half bytes (ceil(K / 2), N), out
// f32 (M, N).  group_size == 0: wo4, scale f32 / zp int32 (N,) or (1,);
// group_size > 0: wo4g, scale f32 (K / group_size, N), zp not read; K even and
// group_size and K / 2 multiples of 128, else cudaErrorInvalidValue.  One
// kernel launch, no workspace, the form chosen by M.  Returns the launch's
// error, else cudaGetLastError().
int jlt_wo4(const void* x, const void* w, const void* scale, const void* zp,
            void* out, int M, int K, int N, int per_channel, int group_size,
            void* stream) {
  const WoArgs a = {(const float*)x, (const int8_t*)w, (const float*)scale, (const int*)zp,
                    (float*)out, M, K, N, per_channel, group_size};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (group_size > 0) {
    if (K % 2 || group_size % kGroupRows || (K / 2) % kGroupRows)
      return (int)cudaErrorInvalidValue;
    err = launch_wo4g(a, s);
  } else {
    err = launch_wo_mma<Wo4>(a, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int jlt_wo4_group_rows() { return kGroupRows; }

const char* jlt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
