// Weight-only int8 / int4 matmul with the dequant fused in:
//   out[m, n] = s[n] * sum_k x[m, k] * (w[k, n] - z[n])
// x f32 (M, K) row-major; w int8 (K, N) (wo8), or int4 split-half bytes
// (ceil(K/2), N) (wo4) whose byte row r holds k = r (low nibble) and
// k = r + ceil(K/2) (high nibble); s f32 / z int32 per output channel (N,) or
// per tensor (1,).
//
// Group-wise int4 (wo4g): the same bytes, s f32 (G, N), one row per group of
// gs rows of K, no zero point (symmetric):
//   out[m, n] = sum_k x[m, k] * (w[k, n] * s[k / gs, n])
//
// Replaces the TPU kernels jaxlsq/serve/matmul.py:_wo8_kernel (launched at
// :255), _wo4_kernel (:93, launched at :317) and _wo4g_kernel (:147, launched
// at :298).  One body serves the three weight formats (a template parameter):
// one launch a call, no workspace.
//
// ---- the summation order: one for every M, in both forms ----
//
// It depends on K and kSlice alone.  The weight's rows (int8: the K rows;
// int4: the ceil(K/2) byte rows) are cut into slices of kSlice = 32
// consecutive rows, padded with zero rows to a whole slice.
//   1. A slice partial is one fmaf chain from +0 over the slice's factors in
//      order: int8, row r's factor times x[m, r] for r ascending; int4, for
//      each byte row r ascending its low nibble (factor times x[m, r]) and
//      then its high nibble (times x[m, r + ceil(K/2)]): 64 terms a slice.
//   2. The factors are exact f32 values: wo8 and wo4 (float)(w - z), the zero
//      point applied to each byte or nibble (so the TPU kernel's epilogue
//      acc - rowsum(x) * z is not needed and there is no rowsum); wo4g
//      (float)w * s[k / gs, n], rounded once: the plain dequant's element,
//      bit for bit.  A slice's low nibbles lie in one group and its high
//      nibbles in one, because the wrapper keeps gs and K / 2 multiples of
//      128 (a multiple of 32 would do; 128 is the TPU kernel's lane tile).
//   3. Padding (rows past the weight's, and for odd K the last byte row's high
//      nibble) has x = 0 and factor 0.
//   4. The slice partials are left-folded in ascending slice order from +0
//      (total = 0; total += p0; total += p1; ...).
//   5. out = total * s[n] (wo8, wo4); out = total (wo4g).
// So a row gives the same bits at any M, in any row tile and in either form
// below: at B = 1 and B = 8, and in prefill and decode.
//
// What bounds it on an H100: at decode M every weight byte is used M times
// (int4: 2M multiply-adds), far below the card's ~20 f32 operations per byte
// of bandwidth, so it is bound by streaming the weight bytes once; at
// prefill M (M = 256 and up) by the f32 FMAs.  Two forms, chosen by M
// (thresholds from card runs):
//
// Split form (M <= 64 and M * N <= 256K: decode and short chunks).  A thread
// owns CPT byte columns (8 for up to 4 rows, else 4; int4 also 4 for up to 4
// rows where a thread then walks no more slices) and one slice at a time: it
// issues all 32 row loads of the slice before it uses any, so even the 1 MB
// d1024 proj weight is all in flight at once.  A block is 8 column
// threads x up to 32 slice threads; the K slices of a column tile are spread
// over a thread-block cluster of C blocks (Hopper's distributed shared
// memory; C a power of two <= 8, the fewest that give the card a wave and fit
// in shared memory), block r owning the tile's r-th C-th of the columns.
// The block's x sits in shared memory in the order of the chain (int4:
// x[r], x[r + ceil(K/2)], x[r + 1], ...).  Each thread stores its slice
// partials straight into the shared memory of the block that owns their
// columns; after one cluster barrier every block folds its columns in slice
// order from its own shared memory and writes out with the scale.  The row
// count is a template (1, 2, 4, 8, 16; int4, whose slice is twice the
// multiply-adds a thread, at most 4 up to M = 8 and 8 above), so M = 1 holds
// 8 accumulators a thread; further rows go to further row tiles
// (gridDim.y).
//
// A factor is two instructions: the unsigned value (int8: the byte ^ 0x80;
// int4: the nibble ^ 8, one xor and one mask a word of 8 nibbles) as the low
// mantissa bits of 2^23 (a byte permute), less 2^23 + 128 + z (int4: 2^23 +
// 8 + z), exact for every 8-bit and 4-bit value and zero point; wo4g then
// multiplies by the group's scale.
//
// Tiled form (larger M: prefill).  A register-tiled product: a block owns a
// BM x BN output tile; x (f32; int4: both K ranges interleaved as in the
// chain, by 4-byte copies) and the raw weight bytes arrive slice by slice
// through a ring of shared-memory stages by cp.async (4 for int8; 2 for int4,
// whose slice holds twice the factors: more blocks an SM, faster in card
// runs), each slice's bytes become f32 factors once (int4: two rows of
// factors a byte row), and each thread keeps a per-slice accumulator that it
// adds into its running total at every slice's end: the split form's bits.
// The tile (128 x 128, 64 x 64) is the largest that gives the card most of a
// wave of blocks; where neither does (N = 1024 up to M = 320), 32 x 32 tiles
// of 2 x 4 a thread take the K slices in rounds over a cluster of up to 8
// blocks (slice j * C + r to block r), which fold each round's C consecutive
// partials in slice order: the same bits again.
//
// ---- the int4 lab (wo4_bf16, wo4_native): the chunked blocks ----
//
// The lab's two candidates (lab/int4_kernel_lab.py) keep the int4 kernels'
// first design, an in-run baseline for the body above: a block owns 128
// output columns (a warp's 32 lanes x 4 adjacent columns) and one 128-row
// chunk of K, its 8 warps take the chunk's rows in turn (four row loads in
// flight per warp) against 16 activation rows staged in shared memory, and
// writes partials to a workspace; a second kernel sums them in chunk order
// and applies the scale.  Large M re-reads the weights once per 16 rows, in
// slabs of 256 rows (a launch pair each).  No zero point:
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

#include <type_traits>

#include "cp_async.cuh"

namespace cg = cooperative_groups;

namespace {

using jlt::copy_async;
using jlt::copy_commit;
using jlt::copy_wait;

// ---------------------------------------------------- wo8, wo4, wo4g ----

enum Format { kInt8, kInt4, kInt4G };

constexpr int kSlice = 32;          // weight rows (int8) or byte rows (int4) a slice
constexpr int kColThreads = 8;      // split form: column threads a block row
constexpr int kMaxCluster = 8;      // portable cluster size
constexpr int kSplitMaxRows = 64;   // the split form up to this M ...
constexpr long kSplitMaxOut = 256 * 1024;  // ... and M * N (card runs)
constexpr int kSplitThreads = 256;  // split form: at most 32 slice threads a block
constexpr size_t kSplitMaxSmem = 200 * 1024;
constexpr int kGroupRows = 128;     // wo4g: gs and K / 2 multiples of this

// factors (and x values) a slice; a slice's row of x in shared memory, padded;
// the tiled form's ring stages
__host__ __device__ constexpr int factors(int fmt) { return fmt == kInt8 ? kSlice : 2 * kSlice; }
__host__ __device__ constexpr int xpad(int fmt) { return factors(fmt) + 4; }
__host__ __device__ constexpr int stages(int fmt) { return fmt == kInt8 ? 4 : 2; }

// weight rows: K for int8, ceil(K / 2) byte rows for int4
__host__ __device__ __forceinline__ int weight_rows(int fmt, int K) {
  return fmt == kInt8 ? K : (K + 1) / 2;
}

// A call's arguments, as the launch code passes them on.  The kernels take
// them as separate __restrict__ parameters (passed as this struct, wo8's
// tiled form ran 4% slower in card runs).
struct WoArgs {
  const float* x;
  const int8_t* w;
  const float* scale;  // (N,) or (1,); wo4g (G, N)
  const int* zp;       // (N,) or (1,); wo4g: not read
  float* out;
  int M, K, N, per_channel, gs;
};

// The unsigned value of byte j of a word (< 256) as the low mantissa bits of
// 2^23, less zc = 2^23 + bias + z: (float)(w - z), exact.
__device__ __forceinline__ float mant_minus(unsigned word, int j, float zc) {
  const unsigned bits = __byte_perm(word, 0x4B000000u, 0x7650u | j);
  return __fsub_rn(__uint_as_float(bits), zc);
}

// the 4 bytes (int8) or the 4 low / high nibbles (int4) of a weight word as
// unsigned values: the byte + 128, the nibble + 8
__device__ __forceinline__ unsigned biased8(unsigned word) { return word ^ 0x80808080u; }
__device__ __forceinline__ unsigned biased4(unsigned word, int high) {
  const unsigned t = word ^ 0x88888888u;
  return (high ? t >> 4 : t) & 0x0F0F0F0Fu;
}

// factor v of a slice's byte row word (int8: v = the row; int4: v = 2 * row +
// nibble) for byte j; slo, shi: the slice's low- and high-nibble group scales
// of that column (wo4g)
template <int FMT>
__device__ __forceinline__ float factor(unsigned word, int v, int j, float zc, float slo,
                                        float shi) {
  if (FMT == kInt8) return mant_minus(biased8(word), j, zc);
  const float f = mant_minus(biased4(word, v & 1), j, zc);
  return FMT == kInt4G ? __fmul_rn(f, (v & 1) ? shi : slo) : f;
}

template <int FMT>
__device__ __forceinline__ float zero_const(const int* zp, int n, int N, int per_channel) {
  const int bias = FMT == kInt8 ? 8388736 : 8388616;  // 2^23 + 128, 2^23 + 8
  if (FMT == kInt4G) return __int2float_rn(bias);
  return __int2float_rn(bias + (n < N ? zp[per_channel ? n : 0] : 0));
}

// wo4g: the group scale of row k of K and column n (0 past N)
__device__ __forceinline__ float group_scale(const float* __restrict__ scale, int gs, int k,
                                             int n, int N) {
  return n < N ? __ldg(scale + (size_t)(k / gs) * N + n) : 0.f;
}

template <int FMT>
__device__ __forceinline__ float out_value(const float* __restrict__ scale, int per_channel,
                                           float total, int n) {
  return FMT == kInt4G ? total : __fmul_rn(total, scale[per_channel ? n : 0]);
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

// is factor v of the slice starting at row r0 inside the weight (not padding)
template <int FMT>
__device__ __forceinline__ bool live(int r0, int v, int K) {
  if (FMT == kInt8) return r0 + v < K;
  const int KR = (K + 1) / 2, r = r0 + v / 2;
  return (v & 1) ? r + KR < K : r < KR;
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
// its own shared memory.  Dynamic shared memory: x as [MR][sb][xpad], the
// cluster's partials of this block's columns as [C * sb][MR][cw].
template <int FMT, int MR, int CPT>
__global__ void __launch_bounds__(kSplitThreads)
wo_split_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, const int* __restrict__ zp,
                float* __restrict__ out, int M, int K, int N, int per_channel, int gs,
                int sb, int vec) {
  constexpr int kWords = CPT / 4;
  constexpr int NC = kColThreads * CPT;
  constexpr int VR = factors(FMT), XP = xpad(FMT);
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* gat = xs + (size_t)MR * sb * XP;

  cluster_arrive_relaxed();  // this block has started (its shared memory exists)
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.dim_blocks().x;
  const int rank = (int)cluster.block_rank();
  const int cw = NC / C;
  const int R = weight_rows(FMT, K), KR = (K + 1) / 2;
  const int n0 = (blockIdx.x / C) * NC;
  const int m0 = blockIdx.y * MR;
  const int mt = min(MR, M - m0);
  const int S = (R + kSlice - 1) / kSlice;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int ct = tid % kColThreads, step = nthreads / kColThreads;
  const int n = n0 + ct * CPT;
  const int rb = rank * sb * kSlice;  // first weight row of this block
  const int dst = ct * CPT / cw, dcol = ct * CPT - dst * cw;  // owner of my columns
  // rows whose every factor is live: a slice below this needs no padding test
  const int full = FMT == kInt8 ? K : K / 2;

  unsigned wv[kSlice][kWords];
  float slo[CPT] = {}, shi[CPT] = {};  // wo4g: the slice's group scales
  auto load = [&](int ls) {
    const int r0 = rb + ls * kSlice;
    if (vec && n + CPT <= N && r0 + kSlice <= R) {  // the whole slice: 32 loads in flight
#pragma unroll
      for (int r = 0; r < kSlice; ++r) w_row_vec<CPT>(w + (size_t)(r0 + r) * N + n, wv[r]);
    } else {
#pragma unroll
      for (int r = 0; r < kSlice; ++r) w_row<CPT>(w, r0 + r, R, n, N, vec, wv[r]);
    }
    if (FMT == kInt4G && r0 < R) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        slo[j] = group_scale(scale, gs, r0, n + j, N);
        shi[j] = group_scale(scale, gs, r0 + KR, n + j, N);
      }
    }
  };
  int ls = tid / kColThreads;  // this thread's first slice in the block
  if (ls < sb) load(ls);       // in flight while x is staged

  for (int i = tid; i < MR * sb * VR; i += nthreads) {
    const int m = i / (sb * VR), j = i - m * (sb * VR), v = j % VR;
    const int r = rb + (j / VR) * kSlice + (FMT == kInt8 ? v : v / 2);
    const int k = FMT == kInt8 ? r : r + (v & 1) * KR;
    xs[((size_t)m * sb + j / VR) * XP + v] =
        (m < mt && r < R && k < K) ? x[(size_t)(m0 + m) * K + k] : 0.f;
  }
  float zc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) zc[j] = zero_const<FMT>(zp, n + j, N, per_channel);
  __syncthreads();
  cluster_wait();  // every block of the cluster has started
  float* dgat = cluster.map_shared_rank(gat, dst);

  float acc[MR][CPT];
  // the slice's chain; GUARDED zeroes the padding's factors
  auto product = [&](int r0, auto guarded) {
    constexpr bool GUARDED = decltype(guarded)::value;
#pragma unroll
    for (int v4 = 0; v4 < VR / 4; ++v4) {
      float4 xv[MR];
#pragma unroll
      for (int m = 0; m < MR; ++m)
        xv[m] = *reinterpret_cast<const float4*>(xs + ((size_t)m * sb + ls) * XP + 4 * v4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int v = 4 * v4 + u;
        const unsigned* word = wv[FMT == kInt8 ? v : v / 2];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          float wf = factor<FMT>(word[j / 4], v, j % 4, zc[j], slo[j], shi[j]);
          if (GUARDED && !live<FMT>(r0, v, K)) wf = 0.f;
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
    if (r0 < R) {
      if (r0 + kSlice <= full)
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
    out[(size_t)(m0 + m) * N + nn] = out_value<FMT>(scale, per_channel, total, nn);
  }
}

// bytes of the tiled form's dynamic shared memory: the ring of x, weight
// and (wo4g) group-scale stages and the slice's factors; with a cluster of
// C > 1 also the gather of two rounds' partials (2 x BM x BN floats) and the
// running totals of this block's BM / C rows
template <int FMT, int BM, int BN>
size_t tiled_smem(int C) {
  return (size_t)stages(FMT) * (sizeof(float) * BM * xpad(FMT) + kSlice * BN +
                                (FMT == kInt4G ? sizeof(float) * 2 * BN : 0)) +
         sizeof(float) * factors(FMT) * BN +
         (C > 1 ? sizeof(float) * (2 * BM * BN + BM / C * BN) : 0);
}

// Tiled form: a BM x BN output tile a block, a TM x TN register tile a thread
// (columns in groups of 4, BN / (TN / 4) apart; rows in groups of 4, BM /
// (TM / 4) apart, or TM < 4 adjacent rows).  x (f32), the weight (raw
// bytes) and for wo4g the slice's two rows of group scales arrive slice by
// slice in a ring of stages(FMT) shared-memory stages by cp.async (xch, wch:
// copy widths the strides and alignments allow; int4's interleaved x and the
// scales by 4 bytes); each slice's bytes become f32 factors once, in a tile
// of their own ([factors][BN], in the chain's order), before the product.
//
// SPLIT: a cluster of C blocks shares one output tile and takes its slices
// in rounds: in round j block r sums slice j * C + r, so a round's C slice
// partials are consecutive in the order.  Each thread stores its partials
// into the shared memory of the block that owns their rows (block q owns
// rows [q, q + 1) * BM / C of the tile), one cluster barrier a round
// publishes them (two gather buffers: a buffer is written again two rounds
// later, after its owner has folded it), and every owner adds the round's C
// partials into its running totals in slice order: the unsplit tile's bits.
template <int FMT, int BM, int BN, int TM, int TN, bool SPLIT>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
wo_tiled_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, const int* __restrict__ zp,
                float* __restrict__ out, int M, int K, int N, int per_channel, int gs,
                int xch, int wch) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int RG = BM / (TM >= 4 ? TM / 4 : 1), CG = BN / (TN / 4);
  constexpr int VR = factors(FMT), XP = xpad(FMT), ST = stages(FMT);
  constexpr int XS = BM * XP;      // floats of an x stage
  constexpr int WS = kSlice * BN;  // bytes of a weight stage
  constexpr int CW = kSlice * BN / 4 / NT;  // weight words a thread converts a slice
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* wf = xs + ST * XS;        // the slice's factors, [VR][BN]
  uint8_t* wsb = reinterpret_cast<uint8_t*>(wf + VR * BN);
  float* sgs = reinterpret_cast<float*>(wsb + ST * WS);  // wo4g: [ST][2][BN] group scales
  float* gat = sgs + (FMT == kInt4G ? ST * 2 * BN : 0);  // SPLIT: [2][C][BM / C][BN]

  int C = 1, rank = 0;
  if (SPLIT) {
    cluster_arrive_relaxed();  // this block has started (its shared memory exists)
    C = (int)cg::this_cluster().dim_blocks().x;
    rank = (int)cg::this_cluster().block_rank();
  }
  const int R = weight_rows(FMT, K), KR = (K + 1) / 2;
  const int OR = BM / C;            // SPLIT: rows a block owns
  float* tots = gat + 2 * BM * BN;  // SPLIT: this block's totals, [OR][BN]
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = (blockIdx.x / C) * BN;
  const int S = (R + kSlice - 1) / kSlice;
  const int nr = (S + C - 1) / C;  // rounds: this block's slice of round j is j * C + rank
  const int lc = tid % (BN / 4), lr = tid / (BN / 4);  // converter word column, row
  auto row = [&](int i) { return TM >= 4 ? (i / 4) * RG + ty * 4 + i % 4 : ty * TM + i; };
  auto col = [&](int j) { return (j / 4) * CG + tx * 4 + j % 4; };

  auto issue = [&](int j) {
    const int s = j * C + rank;
    if (j < nr && s < S) {
      const int r0 = s * kSlice;
      float* xd = xs + (j % ST) * XS;
      uint8_t* wd = wsb + (j % ST) * WS;
      if (FMT == kInt8) {
        const int xe = xch / 4, xcpr = kSlice / xe;
        for (int i = tid; i < BM * xcpr; i += NT) {
          const int m = i / xcpr, k = r0 + (i % xcpr) * xe;
          const bool ok = m0 + m < M && k < K;
          copy_async(xd + m * XP + (i % xcpr) * xe,
                     ok ? x + (size_t)(m0 + m) * K + k : x, xch, ok);
        }
      } else {  // x[r], x[r + KR] interleaved, as the chain takes them
        for (int i = tid; i < BM * VR; i += NT) {
          const int m = i / VR, v = i % VR, r = r0 + v / 2, k = r + (v & 1) * KR;
          const bool ok = m0 + m < M && r < R && k < K;
          copy_async(xd + m * XP + v, ok ? x + (size_t)(m0 + m) * K + k : x, 4, ok);
        }
      }
      const int wcpr = BN / wch;
      for (int i = tid; i < kSlice * wcpr; i += NT) {
        const int r = i / wcpr, nn = n0 + (i % wcpr) * wch;
        const bool ok = r0 + r < R && nn < N;
        copy_async(wd + r * BN + (i % wcpr) * wch,
                   ok ? w + (size_t)(r0 + r) * N + nn : w, wch, ok);
      }
      if (FMT == kInt4G) {  // the low nibbles' group row, then the high nibbles'
        float* sd = sgs + (j % ST) * 2 * BN;
        for (int i = tid; i < 2 * BN; i += NT) {
          const int k = r0 + (i / BN) * KR, nn = n0 + i % BN;
          const bool ok = nn < N;
          copy_async(sd + i, ok ? scale + (size_t)(k / gs) * N + nn : scale, 4, ok);
        }
      }
    }
    copy_commit();  // an empty group past the last slice keeps the count
  };

  float zc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) zc[j] = zero_const<FMT>(zp, n0 + 4 * lc + j, N, per_channel);
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
  for (int j = 0; j < ST - 1; ++j) issue(j);
  for (int j = 0; j < nr; ++j) {
    copy_wait<ST - 2>();
    __syncthreads();  // round j's slice landed; every thread is done with the last one
    issue(j + ST - 1);
    const int s = j * C + rank;
    if (s < S) {
      const int r0 = s * kSlice;
      const uint8_t* wt = wsb + (j % ST) * WS;
      float slo[4] = {0.f, 0.f, 0.f, 0.f}, shi[4] = {0.f, 0.f, 0.f, 0.f};
      if (FMT == kInt4G) {  // this converter's columns' group scales
        const float* sg = sgs + (j % ST) * 2 * BN + 4 * lc;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          slo[q] = sg[q];
          shi[q] = sg[BN + q];
        }
      }
#pragma unroll
      for (int p = 0; p < CW; ++p) {
        const int r = lr + p * (NT / (BN / 4));
        const unsigned word = *reinterpret_cast<const unsigned*>(wt + r * BN + 4 * lc);
#pragma unroll
        for (int h = 0; h < (FMT == kInt8 ? 1 : 2); ++h) {
          const int v = FMT == kInt8 ? r : 2 * r + h;
          const bool ok = live<FMT>(r0, v, K);
          float4 f;
          f.x = ok ? factor<FMT>(word, v, 0, zc[0], slo[0], shi[0]) : 0.f;
          f.y = ok ? factor<FMT>(word, v, 1, zc[1], slo[1], shi[1]) : 0.f;
          f.z = ok ? factor<FMT>(word, v, 2, zc[2], slo[2], shi[2]) : 0.f;
          f.w = ok ? factor<FMT>(word, v, 3, zc[3], slo[3], shi[3]) : 0.f;
          *reinterpret_cast<float4*>(wf + v * BN + 4 * lc) = f;
        }
      }
      __syncthreads();
      const float* xt = xs + (j % ST) * XS;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) acc[i][jj] = 0.f;
#pragma unroll
      for (int kq = 0; kq < VR / 4; ++kq) {
        float4 xv[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          xv[i] = *reinterpret_cast<const float4*>(xt + row(i) * XP + 4 * kq);
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
      if (m < M && nn < N)
        out[(size_t)m * N + nn] = out_value<FMT>(scale, per_channel, tots[o], nn);
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
      if (nn < N) out[(size_t)m * N + nn] = out_value<FMT>(scale, per_channel, tot[i][jj], nn);
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

template <int FMT>
size_t split_smem(int mr, int cpt, int K, int C) {
  const int S = (weight_rows(FMT, K) + kSlice - 1) / kSlice, sb = (S + C - 1) / C;
  return sizeof(float) * ((size_t)mr * sb * xpad(FMT) + (size_t)sb * mr * kColThreads * cpt);
}

// the split form's cluster: the fewest blocks (a power of two <= 8) a column
// tile that give the card a wave and fit in shared memory
template <int FMT>
int split_cluster(int M, int K, int N, int mr, int cpt) {
  const long tiles = (long)((N + kColThreads * cpt - 1) / (kColThreads * cpt)) * ((M + mr - 1) / mr);
  int C = 1;
  while (C < kMaxCluster &&
         (C * tiles < sm_count() || split_smem<FMT>(mr, cpt, K, C) > kSplitMaxSmem))
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

template <int FMT, int MR, int CPT>
cudaError_t launch_split(const WoArgs& a, int C, cudaStream_t stream) {
  const int S = (weight_rows(FMT, a.K) + kSlice - 1) / kSlice;
  const int sb = (S + C - 1) / C;
  const size_t smem = split_smem<FMT>(MR, CPT, a.K, C);
  if (smem > kSplitMaxSmem) return cudaErrorInvalidValue;
  static size_t smem_set = 48 * 1024;  // this instance's dynamic shared memory limit
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        wo_split_kernel<FMT, MR, CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
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
  return cudaLaunchKernelEx(&cfg, wo_split_kernel<FMT, MR, CPT>, a.x, a.w, a.scale, a.zp,
                            a.out, a.M, a.K, a.N, a.per_channel, a.gs, sb, vec);
}

// the tiled form, its K split over a cluster of C blocks (a power of two <= 8
// that divides BM) when C > 1
template <int FMT, int BM, int BN, int TM, int TN>
cudaError_t launch_tiled(const WoArgs& a, int C, cudaStream_t stream) {
  const size_t smem = tiled_smem<FMT, BM, BN>(C);
  const int xch = min(jlt::copy_width((uintptr_t)a.x | (uintptr_t)a.K * 4), 16);
  const int wch = min(jlt::copy_width((uintptr_t)a.w | (uintptr_t)a.N), BN);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((a.N + BN - 1) / BN), (a.M + BM - 1) / BM, 1);
  cfg.blockDim = dim3((BM / TM) * (BN / TN), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  if (C == 1) {
    auto kernel = wo_tiled_kernel<FMT, BM, BN, TM, TN, false>;
    static bool smem_set = smem <= 48 * 1024;
    if (!smem_set) {
      cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      smem_set = true;
    }
    return cudaLaunchKernelEx(&cfg, kernel, a.x, a.w, a.scale, a.zp, a.out, a.M, a.K, a.N,
                              a.per_channel, a.gs, xch, wch);
  }
  auto kernel = wo_tiled_kernel<FMT, BM, BN, TM, TN, true>;
  static size_t smem_set = 48 * 1024;  // this instance's dynamic shared memory limit
  if (smem > smem_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  cudaLaunchAttribute attr[1] = {cluster_attr(C)};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a.x, a.w, a.scale, a.zp, a.out, a.M, a.K, a.N,
                            a.per_channel, a.gs, xch, wch);
}

// the form by M: split for decode and short chunks, else tiled
template <int FMT>
cudaError_t launch_wo(const WoArgs& a, cudaStream_t stream) {
  const int M = a.M, N = a.N;
  // rows a block: int4, whose slice is twice the multiply-adds a thread,
  // takes at most 4 up to M = 8 and 8 above (card runs)
  const int mr = FMT == kInt8 ? (M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : M <= 8 ? 8 : 16)
                              : (M <= 1 ? 1 : M <= 2 ? 2 : M <= 8 ? 4 : 8);
  int cpt = mr <= 4 ? 8 : 4;
  // int4 up to 4 rows: 4 columns a thread (twice the threads) unless that
  // makes a thread walk more slices one after another than 8 columns do
  // (card runs: faster at the d1024 shapes, slower at K = N = 8192)
  auto walk = [&](int c) {
    const int C = split_cluster<FMT>(M, a.K, N, mr, c);
    const int S = (weight_rows(FMT, a.K) + kSlice - 1) / kSlice, sb = (S + C - 1) / C;
    return (sb + kSplitThreads / kColThreads - 1) / (kSplitThreads / kColThreads);
  };
  if (FMT != kInt8 && cpt == 8 && walk(4) <= walk(8)) cpt = 4;
  const int C = split_cluster<FMT>(M, a.K, N, mr, cpt);
  if (M <= kSplitMaxRows && (long)M * N <= kSplitMaxOut &&
      split_smem<FMT>(mr, cpt, a.K, C) <= kSplitMaxSmem) {
    if constexpr (FMT == kInt8) {
      switch (mr) {
        case 1: return launch_split<FMT, 1, 8>(a, C, stream);
        case 2: return launch_split<FMT, 2, 8>(a, C, stream);
        case 4: return launch_split<FMT, 4, 8>(a, C, stream);
        case 8: return launch_split<FMT, 8, 4>(a, C, stream);
        default: return launch_split<FMT, 16, 4>(a, C, stream);
      }
    } else if (cpt == 4) {
      switch (mr) {
        case 1: return launch_split<FMT, 1, 4>(a, C, stream);
        case 2: return launch_split<FMT, 2, 4>(a, C, stream);
        case 4: return launch_split<FMT, 4, 4>(a, C, stream);
        default: return launch_split<FMT, 8, 4>(a, C, stream);
      }
    } else {
      switch (mr) {
        case 1: return launch_split<FMT, 1, 8>(a, C, stream);
        case 2: return launch_split<FMT, 2, 8>(a, C, stream);
        default: return launch_split<FMT, 4, 8>(a, C, stream);
      }
    }
  }
  // the largest tile that gives the card most of a wave of blocks; the
  // smallest tile's K split over the fewest blocks (up to 8) that give it 8
  // blocks an SM (thresholds from card runs)
  auto blocks = [&](int t) { return (long)((M + t - 1) / t) * ((N + t - 1) / t); };
  const long wave = sm_count();
  if (blocks(128) * 10 >= wave * 9) return launch_tiled<FMT, 128, 128, 8, 8>(a, 1, stream);
  if (blocks(64) * 10 >= wave * 7) return launch_tiled<FMT, 64, 64, 4, 4>(a, 1, stream);
  int tc = 1;
  while (tc < kMaxCluster && blocks(32) * tc < 8 * wave) tc *= 2;
  return launch_tiled<FMT, 32, 32, 2, 4>(a, tc, stream);
}

// --------------------------------------------------------- the int4 lab ----

constexpr int kCols = 128;        // output columns per block (32 lanes x 4)
constexpr int kWarps = 8;         // warps sharing a K chunk
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;         // activation rows per block
constexpr int kChunk = 128;       // byte rows per block
constexpr int kUnroll = 4;        // byte rows a warp loads before using them
constexpr int kSlab = 256;        // activation rows per launch pair

// How a block stages its chunk's activations: split halves rounded to bf16
// (wo4_bf16), K contiguous (wo4_native: byte row r meets x[m, 2r] and
// x[m, 2r + 1]).
enum Stage { kStageBf16, kStageKContig };

// One (column tile, K chunk, row tile) block: partial sums of its chunk,
// part (n_chunks, mslab, N).
template <Stage STAGE>
__global__ void __launch_bounds__(kThreads)
wo_partial_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                  float* __restrict__ part, int M, int K, int N, int KR) {
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
        lo = __bfloat162float(__float2bfloat16_rn(row[r0 + r]));
        if (r0 + r + KR < K) hi = __bfloat162float(__float2bfloat16_rn(row[r0 + r + KR]));
      }
    }
    xs[m][r] = lo;
    xh[m][r] = hi;
  }
  __syncthreads();

  const bool vec = ((N & 3) == 0) && (n0 + 3 < N);
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

// Sum the chunk partials in chunk order, times the column's scale.
__global__ void wo_epilogue_kernel(const float* __restrict__ part,
                                   const float* __restrict__ scale,
                                   float* __restrict__ out, int M, int N, int n_chunks) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  const int m = i / N, n = i % N;
  float acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) acc += part[((size_t)c * M + m) * N + n];
  out[i] = acc * scale[n];
}

template <Stage STAGE>
void launch_lab(const float* x, const int8_t* w, const float* scale, float* out,
                float* part, int M, int K, int N, cudaStream_t stream) {
  const int KR = (K + 1) / 2;
  const int n_chunks = (KR + kChunk - 1) / kChunk;
  for (int ms = 0; ms < M; ms += kSlab) {
    const int mslab = min(kSlab, M - ms);
    dim3 grid((N + kCols - 1) / kCols, n_chunks, (mslab + kRows - 1) / kRows);
    wo_partial_kernel<STAGE><<<grid, kThreads, 0, stream>>>(x + (size_t)ms * K, w, part,
                                                            mslab, K, N, KR);
    const size_t total = (size_t)mslab * N;
    wo_epilogue_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        part, scale, out + (size_t)ms * N, mslab, N, n_chunks);
  }
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
  cudaError_t err = launch_wo<kInt8>(a, reinterpret_cast<cudaStream_t>(stream));
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
    err = launch_wo<kInt4G>(a, s);
  } else {
    err = launch_wo<kInt4>(a, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int jlt_wo4_group_rows() { return kGroupRows; }

// The int4 lab: x f32 (M, K); w int8 bytes (ceil(K / 2), N) split-half
// (native = 0, wo4_bf16) or (K / 2, N) K-contiguous (native = 1, wo4_native;
// odd K: cudaErrorInvalidValue); scale f32 (N,); out f32 (M, N); part holds
// n_chunks * min(M, 256) * N floats, n_chunks = ceil(byte rows / 128).
// Returns cudaGetLastError().
int jlt_wo4_lab(const void* x, const void* w, const void* scale, void* out,
                void* part, int M, int K, int N, int native, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* xf = (const float*)x;
  const int8_t* wb = (const int8_t*)w;
  const float* sf = (const float*)scale;
  if (native) {
    if (K % 2) return (int)cudaErrorInvalidValue;
    launch_lab<kStageKContig>(xf, wb, sf, (float*)out, (float*)part, M, K, N, s);
  } else {
    launch_lab<kStageBf16>(xf, wb, sf, (float*)out, (float*)part, M, K, N, s);
  }
  return (int)cudaGetLastError();
}

int jlt_wo_chunk_rows() { return kChunk; }
int jlt_wo_slab_rows() { return kSlab; }

const char* jlt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
