// The tensor-core body of the weight-only matmuls: bf16 mma.sync with the
// weight decoded in registers as the A operand, one launch, no workspace,
// one summation order for every M and cluster size.  int4_lab.cu (the int4
// lab's wo4_bf16 and wo4_native) and wo_matmul.cu (wo8 and wo4) instantiate
// it; each instance is an Op: a weight layout, the passes of x, the slice
// length and whether a zero point is subtracted.
//
//   out[m, n] = s[n] * sum_k x[m, k] * (w[k, n] - z[n])
//
// ---- the operands ----
//
// mma.sync m16n8k16 bf16 -> f32 with the operands swapped: the weight is the
// A operand (16 output columns x 16 k, decoded in registers) and the
// activation rows are the n8 side (B), so M = 1 pads to 8 rows, not 16.  A
// k-step covers 16 values of k, mapped onto mma's k index j so that a lane's
// A fragment (j = 2t, 2t + 1, 2t + 8, 2t + 9 for lane (g, t)) comes from
// whole bytes of a few weight rows (kStepRows rows a k-step, kLaneRows of
// them a lane):
//   kSplitHalf4 (the serving pack's int4, (ceil(K/2), N) bytes; byte row r
//     holds k = r in its low nibble and k = r + ceil(K/2) in its high one):
//     8 byte rows a k-step; j < 8 is the low nibble of byte row r0 + j, j >=
//     8 the high nibble of byte row r0 + j - 8 (lane rows r0 + 2t, + 1); x
//     is staged as x[r0 .. r0 + 7] then x[KR + r0 .. KR + r0 + 7], KR =
//     ceil(K/2);
//   kNative4 (int4 K-contiguous, (K/2, N) bytes; byte row r holds k = 2r and
//     2r + 1): 8 byte rows a k-step; j is byte row r0 + j / 2, nibble j % 2
//     (lane rows r0 + t, r0 + 4 + t); x[16 ks .. 16 ks + 15];
//   kInt8 (one value a byte, (K, N)): 16 rows a k-step, j is row r0 + j
//     (lane rows r0 + 2t, + 1, + 8, + 9); x[16 ks .. 16 ks + 15].
// A warp's WT m16 tiles take permuted output columns: tile q's row i is
// column (i % 8) * 2 WT + 2q + i / 8, so lane g's rows g and g + 8 of every
// tile are 2 WT adjacent columns, one 32-bit word a row for two tiles (the
// decode form: WT = 8 or 4, 16 or 8 bytes; the tiled form: WT = 2, 4 bytes).
//
// The decode of a byte row word into exact bf16 factors, two at a time:
//   int4, no zero point: a byte permute puts the two bytes' nibbles at bits
//     0-3 and 16-19, one lop3 masks them and sets 0x43 (bf16 128.0) above
//     each with the nibble ^ 8 as its mantissa (136 + v), and one bf16x2
//     subtract of 136 gives v, exact for every v in [-8, 7];
//   int4 with a zero point z: the nibble ^ 8 goes to mantissa bits 3-6 of
//     bf16 16.0 (24 + v), less the column's 24 + z: v - z, exact (every
//     integer up to 256 in magnitude is a bf16, and 24 + z and v - z are
//     such integers for every z in the carrier's [-128, 127]; 136 + z would
//     not be for z >= 121);
//   int8: the byte ^ 0x80 as the low mantissa bits of 2^23 less 2^23 + 128
//     + z in f32 gives w - z exactly (wo_matmul.cu's f32 decode); w - z is
//     an integer in [-255, 255], so its f32 bits below the top 16 are zero
//     and a byte permute takes the two bf16 halves without rounding.
// x takes PS passes: 1, bf16_rn(x); 3, its exact split hi = bf16_rn(x), mid =
// bf16_rn(x - hi), lo = bf16_rn(x - hi - mid), hi + mid + lo == x for |x| in
// [2^-110, 2^127) and 0, each pass an MMA against the same weight fragment.
// So every product is exact and only the tensor cores' f32 accumulation
// differs from an f32 chain.
//
// ---- the summation order: one for every M and every cluster size ----
//
// It depends on K alone.  The k-steps are cut into slices of SS k-steps (the
// lab 16, wo8 and wo4 4), the last padded with zero bytes and x = 0.  A
// slice partial is the tensor cores' chain from +0 over its k-steps in order
// (three passes: hi, mid, lo at each k-step).  The even slices' partials are
// left-folded in slice order from +0 in f32 (__fadd_rn) into q0, the odd
// slices' into q1, and out = (q0 + q1) * s[n].  Padding (rows past the
// weight's; odd split-half K's dead high nibble; rows past M) has a zero
// byte or x = 0.  So a row has the same bits in either form below, at every
// M and cluster size (an MMA's output element depends on its own A row, B
// column and accumulator only).  The two lanes let the tiled form split K
// over two warps with no cross-warp fold until the end.
//
// ---- the two forms ----
//
// Decode form (NT = 1 or 2 n8 tiles, BM = 8 NT rows).  A block is DW warps
// (8 or 4) on one 16 WT-column tile (WT m16 tiles a warp: 2 WT bytes a lane
// and weight row); every warp is one part of the K split and a thread-block
// cluster of C blocks (a power of two <= 8: the largest whose clusters are
// all resident at once, no more parts than slices) splits it further: in
// round j part p (= rank * DW + warp) sums slice j * DW C + p.  Each lane
// streams its own weight bytes kDAhead k-steps ahead by cp.async into a ring
// in shared memory, with a quarter k-step of an x row beside them (a lane's
// B values come from its neighbours' slots; a warp barrier a k-step, a slot
// refilled as soon as the warp has read it; no block barrier).  The stream
// starts before the cluster's first barrier and runs on across rounds.  A
// lane converts x in registers and stores its partial into the shared
// memory of the block that owns its columns (block r owns columns [r, r + 1)
// * 16 WT / C of the tile; only the rows that hold x); after one cluster
// barrier a round every block folds its columns (two gather buffers when
// there is more than one round).
//
// Tiled form (TR rows a block).  A block owns a 128 x TR (columns x rows)
// tile and all of K; 8 warps, each 32 columns x TR rows (2 m16 x TR / 8 n8)
// of one lane (the even or the odd slices).  The weight bytes arrive by
// cp.async in a 4-stage ring; x is loaded into registers an iteration ahead
// and staged once a block as bf16 (three passes: split once) in a double
// buffer that the warps read with ldmatrix; one barrier an iteration.  Each
// warp adds its slice accumulator into its lane's running total at every
// slice's end, and the odd lane's totals reach the even lane's warps through
// shared memory at the end: the decode form's bits.  x traffic from L2 is
// (N / 128) x the bytes of x.
#pragma once
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace jlt {
namespace mma {
namespace {  // each including source keeps its own instances

namespace cg = cooperative_groups;

enum Layout { kSplitHalf4, kNative4, kInt8 };

// One instance's weight layout (L), passes of x (PS: 1 or 3), k-steps a
// slice (SS) and zero point (ZP).
template <int L, int PS, int SS, bool ZP>
struct Op {
  static constexpr int kLayout = L, kPasses = PS, kSliceSteps = SS;
  static constexpr bool kZero = ZP;
  static constexpr int kStepRows = L == kInt8 ? 16 : 8;  // weight rows a k-step
  static constexpr int kLaneRows = L == kInt8 ? 4 : 2;   // of them, a lane's
};

constexpr int kThreads = 256;   // 8 warps: the tiled form, the lab's decode form
constexpr int kMaxCluster = 8;
constexpr int kDTiles = 8;      // decode form: m16 tiles a warp (16 kDTiles columns), the lab's
constexpr int kDAhead = 4;      // decode form: k-steps in flight a lane
constexpr int kTCols = 128;     // tiled form: the block's columns
constexpr int kTChunk = 4;      // tiled form: k-steps a lane an iteration
constexpr int kTStages = 4;     // tiled form: weight ring stages
constexpr int kTWRow = kTCols + 16;       // bytes a weight row in shared memory (padded:
constexpr int kTBRow = 16 * kTChunk + 8;  // and bf16 a staged x row: a warp's 4-byte
                                          // weight reads and ldmatrix rows hit
                                          // distinct banks)

// weight rows of a K: ceil(K / 2) split-half, K / 2 native, K int8
__host__ __device__ __forceinline__ int weight_rows(int layout, int K) {
  return layout == kSplitHalf4 ? (K + 1) / 2 : layout == kNative4 ? K / 2 : K;
}

// slices of a K
template <class F>
__host__ __device__ __forceinline__ int slices(int K) {
  constexpr int rows = F::kStepRows * F::kSliceSteps;
  return (weight_rows(F::kLayout, K) + rows - 1) / rows;
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// the weight row (within its k-step) of a lane's read i: split-half 2t + i,
// native t + 4i, int8 2t + (i & 1) + 8 (i >> 1)
template <class F>
__device__ __forceinline__ int lane_row(int i, int t) {
  return F::kLayout == kSplitHalf4 ? 2 * t + i
         : F::kLayout == kNative4  ? t + 4 * i
                                   : 2 * t + (i & 1) + 8 * (i >> 1);
}

// the per-column constant of the decode: int4 with a zero point, bf16x2 of
// 24 + z; int8, the f32 bits of 2^23 + 128 + z; int4 without one, unused
template <class F>
__device__ __forceinline__ uint32_t zero_const(const int* __restrict__ zp, int n, int N,
                                               int per_channel) {
  const int z = (F::kZero && n < N) ? __ldg(zp + (per_channel ? n : 0)) : 0;
  if (F::kLayout == kInt8) return __float_as_uint(__int2float_rn(8388736 + z));
  const float c = (float)(24 + z);
  return bf2_bits(__floats2bfloat162_rn(c, c));
}

// two signed nibbles (bits 0-3 and 16-19 of X) as an exact bf16x2, less the
// zero point (zk: bf16x2 of 24 + z) when there is one
template <bool ZP>
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t X, uint32_t zk) {
  if (!ZP) {  // (the nibble ^ 8) as the mantissa of 128.0, less 136
    uint32_t h = (X & 0x000F000Fu) ^ 0x43084308u;
    __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&h);
    return bf2_bits(__hsub2(v, __floats2bfloat162_rn(136.f, 136.f)));
  }
  // (the nibble ^ 8) as mantissa bits 3-6 of 16.0, less 24 + z
  uint32_t h = ((X << 3) & 0x00780078u) ^ 0x41C041C0u;
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&h);
  return bf2_bits(__hsub2(v, *reinterpret_cast<const __nv_bfloat162*>(&zk)));
}

// two int8 bytes (byte c of words w0 and w1) less the zero point as an exact
// bf16x2: each (2^23 + (byte ^ 0x80)) - (2^23 + 128 + z) in f32, then the
// top halves
__device__ __forceinline__ uint32_t bytes_bf16x2(uint32_t w0, uint32_t w1, int c, uint32_t zk) {
  const float z = __uint_as_float(zk);
  const float f0 = __fsub_rn(__uint_as_float(__byte_perm(w0 ^ 0x80808080u, 0x4B000000u,
                                                         0x7650u | c)), z);
  const float f1 = __fsub_rn(__uint_as_float(__byte_perm(w1 ^ 0x80808080u, 0x4B000000u,
                                                         0x7650u | c)), z);
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632u);
}

// A fragments of WT m16 tiles for one k-step from a lane's row words
// (w[i][v]: read i, word v = columns 4v .. 4v + 3 of its 2 WT); byte c of
// word v is tile 2v + c / 2, MMA row g + 8 (c % 2); zk[4v + c] its column's
// constant
template <class F, int WT>
__device__ __forceinline__ void decode_a(const uint32_t (&w)[F::kLaneRows][WT / 2],
                                         const uint32_t (&zk)[2 * WT], uint32_t (&a)[WT][4]) {
#pragma unroll
  for (int v = 0; v < WT / 2; ++v)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int q = 2 * v + c / 2, e = c % 2;
      const uint32_t z = zk[4 * v + c];
      const uint32_t sel = c | (c + 4) << 8;  // byte c of each source to bytes 0 and 2
      if (F::kLayout == kSplitHalf4) {  // j = 2t, 2t+1: low nibbles of rows a, b; j + 8: high
        const uint32_t X = __byte_perm(w[0][v], w[1][v], sel);
        a[q][e] = nibbles_bf16x2<F::kZero>(X, z);
        a[q][2 + e] = nibbles_bf16x2<F::kZero>(X >> 4, z);
      } else if (F::kLayout == kNative4) {  // j = 2t, 2t+1: row a's low, high nibble; j + 8: b's
        a[q][e] = nibbles_bf16x2<F::kZero>(__byte_perm(w[0][v], w[0][v] >> 4, sel), z);
        a[q][2 + e] = nibbles_bf16x2<F::kZero>(__byte_perm(w[1][v], w[1][v] >> 4, sel), z);
      } else {  // j = 2t, 2t+1: rows 2t, 2t+1; j + 8: rows 2t+8, 2t+9
        a[q][e] = bytes_bf16x2(w[0][v], w[1][v], c, z);
        a[q][2 + e] = bytes_bf16x2(w[2][v], w[3][v], c, z);
      }
    }
}

// x values (x0, x1) as the B operand's bf16x2 of each pass
template <int PS>
__device__ __forceinline__ void stage_pair(float x0, float x1, uint32_t (&b)[PS]) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
  b[0] = bf2_bits(hi);
  if (PS == 3) {
    const float2 hf = __bfloat1622float2(hi);
    const float r0 = __fsub_rn(x0, hf.x), r1 = __fsub_rn(x1, hf.y);
    const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
    const float2 mf = __bfloat1622float2(mid);
    b[1 % PS] = bf2_bits(mid);
    b[2 % PS] = bf2_bits(__floats2bfloat162_rn(__fsub_rn(r0, mf.x), __fsub_rn(r1, mf.y)));
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The k of mma index j0 .. j0 + 7 (j0 0 or 8) of k-step ks, and whether each
// lies inside K: split-half j < 8 is k = 8 ks + j (byte row < KR), j >= 8 is
// KR + 8 ks + j - 8; otherwise k = 16 ks + j.  *k0 is the first k of the
// eight (consecutive in every layout).
template <class F>
__device__ __forceinline__ void k_run(int ks, int j0, int K, int* k0, int* nlive) {
  if (F::kLayout == kSplitHalf4) {
    const int KR = (K + 1) / 2, r = 8 * ks;
    *k0 = j0 ? KR + r : r;
    *nlive = max(0, min(8, min(KR - r, K - *k0)));
  } else {
    *k0 = 16 * ks + j0;
    *nlive = max(0, min(8, K - *k0));
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The decode form's ring slot: a lane's bytes of one k-step, its weight rows
// (padded to 16 bytes) then its quarter of an x row (16 bytes an n8 tile).
template <class F, int NT, int WT>
__host__ __device__ constexpr int decode_slot_bytes() {
  return (F::kLaneRows * 2 * WT + 15) / 16 * 16 + 16 * NT;
}

// Decode form, the body of a __global__ kernel of DW warps that each
// including source defines.  grid (C x column tiles, row tiles), cluster
// (C, 1, 1), DW warps on a 16 WT-column tile.  Dynamic shared memory: each
// lane's ring of its own bytes, [kDAhead][32 DW] x SB bytes (a
// k-step's weight rows and x values, copied by cp.async: no barrier, each
// lane waits for its own copies), then the gather, [nbuf][DW C][BMs][16 WT /
// C] floats (nbuf 2 with more than one round, else 1; BMs = min(BM, M): the
// rows that hold x), then with more than one round the lanes' running totals
// [2][BMs][16 WT / C], then the scales of this block's 16 WT / C columns.
template <class F, int NT, int WT, int DW>
__device__ __forceinline__ void decode_body(const float* __restrict__ x,
                                            const int8_t* __restrict__ w,
                                            const float* __restrict__ scale,
                                            const int* __restrict__ zp, float* __restrict__ out,
                                            int M, int K, int N, int per_channel, int wch) {
  constexpr int BM = 8 * NT, PS = F::kPasses, SS = F::kSliceSteps, RL = F::kLaneRows;
  constexpr int BN = 16 * WT, NTH = 32 * DW;
  constexpr int SB = decode_slot_bytes<F, NT, WT>(), XO = SB - 16 * NT;  // x's offset
  extern __shared__ float4 smem4[];
  // this lane's ring slot i: ring + i * SB * NTH
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4) + SB * threadIdx.x;
  float* gat = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(smem4) + kDAhead * NTH * SB);

  cluster_arrive_relaxed();  // this block has started (its shared memory exists)
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.dim_blocks().x, rank = (int)cluster.block_rank();
  const int cw = BN / C, P = DW * C, BMs = min(BM, M);
  const int R = weight_rows(F::kLayout, K);
  const int S = slices<F>(K), nr = (S + P - 1) / P;
  const int nbuf = nr > 1 ? 2 : 1;
  float* tots = gat + (size_t)nbuf * P * BMs * cw;
  float* scol = tots + (nr > 1 ? 2 * BMs * cw : 0);  // [cw]
  const int n0 = (blockIdx.x / C) * BN, m0 = blockIdx.y * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int part = rank * DW + warp;
  const int nl = n0 + 2 * WT * g;  // my 2 WT columns
  const int owner = 2 * WT * g / cw, ocol = 2 * WT * g - owner * cw;  // who folds them

  // this warp's k-steps, f = j * SS + u for round j, in one stream across
  // the rounds (the copies of round j + 1 are in flight during round j's
  // end, its barrier and its fold); past S a slice is empty
  auto step_of = [&](int f) { return ((f / SS) * P + part) * SS + f % SS; };
  // x is copied a quarter k-step a lane: lane l takes positions 4 (l % 4)
  // .. + 3 of row m0 + 8 nt + l / 4 (consecutive k: 16 bytes where x's rows
  // and, split-half, both halves are 16-byte aligned); a lane's B values
  // then come from its neighbours' slots
  const int xq = lane & 3, xr = lane >> 2;
  const bool xvec = (uintptr_t)x % 16 == 0 && K % 4 == 0 &&
                    (F::kLayout != kSplitHalf4 || ((K + 1) / 2) % 4 == 0);
  // k-step f's weight rows and its share of x (0 past M and K) into ring
  // slot f % kDAhead, one group a k-step (empty past the warp's slices)
  auto issue = [&](int f) {
    if ((f / SS) * P + part < S && f < nr * SS) {
      uint8_t* d = ring + (f % kDAhead) * SB * NTH;
      const int ks = step_of(f);
#pragma unroll
      for (int h = 0; h < RL; ++h) {
        const int r = ks * F::kStepRows + lane_row<F>(h, t);
        for (int o = 0; o < 2 * WT; o += wch) {
          const bool ok = r < R && nl + o < N;
          jlt::copy_async(d + 2 * WT * h + o, ok ? w + (size_t)r * N + nl + o : w, wch, ok);
        }
      }
      int k0, nlive;
      k_run<F>(ks, 8 * (xq >> 1), K, &k0, &nlive);
      k0 += 4 * (xq & 1);
      nlive -= 4 * (xq & 1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int m = m0 + 8 * nt + xr;
        const float* src = x + (size_t)m * K + k0;
        uint8_t* dx = d + XO + 16 * nt;
        if (xvec) {
          const bool ok = m < M && nlive >= 4;
          jlt::copy_async(dx, ok ? src : x, 16, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = m < M && e < nlive;
            jlt::copy_async(dx + 4 * e, ok ? src + e : x, 4, ok);
          }
        }
      }
    }
    jlt::copy_commit();
  };
  // the first copies, and the scales of the columns this block folds, are
  // in flight while the cluster gathers
  if (threadIdx.x < cw) {
    const int n = n0 + rank * cw + threadIdx.x;
    jlt::copy_async(scol + threadIdx.x, scale + (n < N && per_channel ? n : 0), 4, n < N);
  }
#pragma unroll
  for (int f = 0; f < kDAhead; ++f) issue(f);
  uint32_t zk[2 * WT];
#pragma unroll
  for (int i = 0; i < 2 * WT; ++i) zk[i] = zero_const<F>(zp, nl + i, N, per_channel);
  if (nr > 1)
    for (int i = threadIdx.x; i < 2 * BMs * cw; i += NTH) tots[i] = 0.f;
  cluster_wait();  // every block of the cluster has started
  float* dgat = cluster.map_shared_rank(gat, owner);

  float acc[WT][NT][4];
  // one k-step: wait for its bytes, take them into registers, refill the
  // slot kDAhead k-steps ahead, decode, stage x, the products
  auto step = [&](int f) {
    jlt::copy_wait<kDAhead - 1>();
    __syncwarp();  // the warp's copies of k-step f have landed
    const uint8_t* slot = ring + (f % kDAhead) * SB * NTH;
    const uint32_t* wv = reinterpret_cast<const uint32_t*>(slot);
    uint32_t wr[RL][WT / 2], a[WT][4], b[NT][2][PS];
    float4 xv[NT];
#pragma unroll
    for (int h = 0; h < RL; ++h)
#pragma unroll
      for (int i = 0; i < WT / 2; ++i) wr[h][i] = wv[h * WT / 2 + i];
    // positions 2t, 2t + 1 of row g: lane 4g + t / 2's quarter, and 2t + 8,
    // 2t + 9: lane 4g + 2 + t / 2's
    const uint8_t* xs = slot - SB * lane + SB * (4 * g + t / 2) + XO + 4 * (2 * t % 4);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 lo = *reinterpret_cast<const float2*>(xs + 16 * nt);
      const float2 hi = *reinterpret_cast<const float2*>(xs + 2 * SB + 16 * nt);
      xv[nt] = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
    __syncwarp();  // the warp has read the slot before it is refilled
    issue(f + kDAhead);
    decode_a<F, WT>(wr, zk, a);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      stage_pair<PS>(xv[nt].x, xv[nt].y, b[nt][0]);
      stage_pair<PS>(xv[nt].z, xv[nt].w, b[nt][1]);
    }
#pragma unroll
    for (int p = 0; p < PS; ++p)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < WT; ++q) mma_bf16(acc[q][nt], a[q], b[nt][0][p], b[nt][1][p]);
  };

  for (int j = 0; j < nr; ++j) {
    const int s = j * P + part;
    float* buf = dgat + (size_t)(nbuf > 1 ? (j & 1) : 0) * P * BMs * cw;
    if (s < S) {
#pragma unroll
      for (int q = 0; q < WT; ++q)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][nt][e] = 0.f;
      // a short slice unrolled: one k-step's decode and x split overlap the
      // last one's products (each accumulator's chain keeps its order)
#pragma unroll (SS <= 4 ? SS : 1)
      for (int u = 0; u < SS; ++u) step(j * SS + u);
      // row 8 nt + 2t + e of columns 2 WT g + 2q (+1): acc[q][nt][e] (acc[q][nt][2 + e])
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = 8 * nt + 2 * t + e;
          if (row < BMs) {
            float4* d = reinterpret_cast<float4*>(buf + ((size_t)part * BMs + row) * cw + ocol);
#pragma unroll
            for (int q = 0; q < WT; q += 2)
              d[q / 2] = make_float4(acc[q][nt][e], acc[q][nt][2 + e], acc[q + 1][nt][e],
                                     acc[q + 1][nt][2 + e]);
          }
        }
    }
    if (j + 1 == nr) jlt::copy_wait<0>();  // the scales (and empty groups)
    cluster.sync();  // round j's partials have landed in their owners
    // fold: even slices into lane 0, odd into lane 1, each in slice order
    const float* gb = gat + (size_t)(nbuf > 1 ? (j & 1) : 0) * P * BMs * cw;
    const int nlive = min(P, S - j * P), mt = min(BM, M - m0);
    for (int i = threadIdx.x; i < mt * cw; i += NTH) {
      const int m = i / cw, c = i - m * cw, n = n0 + rank * cw + c;
      float q0 = nr > 1 ? tots[i] : 0.f, q1 = nr > 1 ? tots[BMs * cw + i] : 0.f;
      for (int p = 0; p < nlive; p += 2) {
        q0 = __fadd_rn(q0, gb[((size_t)p * BMs + m) * cw + c]);
        if (p + 1 < nlive) q1 = __fadd_rn(q1, gb[((size_t)(p + 1) * BMs + m) * cw + c]);
      }
      if (j + 1 < nr) {
        tots[i] = q0;
        tots[BMs * cw + i] = q1;
      } else if (n < N) {
        out[(size_t)(m0 + m) * N + n] = __fmul_rn(__fadd_rn(q0, q1), scol[c]);
      }
    }
  }
}

// Tiled form, the body of a __global__ kernel of kThreads threads.  grid
// (column tiles, row tiles of TR), 8 warps: warp (wc, kl)
// = (warp % 4, warp / 4) owns columns n0 + 32 wc ... + 31 and all TR rows of
// the tile, for the slices of lane kl (s % 2 == kl).  Iteration i takes chunk
// i % CPS of slice pair i / CPS (slices 2 (i / CPS) and 2 (i / CPS) + 1, one
// a lane; CPS = SS / kTChunk chunks a slice): kTChunk k-steps.  The weight
// bytes arrive by cp.async in a ring of kTStages stages, [2 lanes][RS rows
// of the chunk][kTWRow]; x is loaded into registers an iteration ahead, then
// staged as bf16 (three passes: its three parts) into a double buffer
// [2][2 lanes][passes][TR][kTBRow] that the warps read with ldmatrix: one
// barrier an iteration.  At the end the odd lane's totals pass through
// shared memory to the even lane's warps, which add them.
template <class F, int TR>
__device__ __forceinline__ void tiled_body(const float* __restrict__ x,
                                           const int8_t* __restrict__ w,
                                           const float* __restrict__ scale,
                                           const int* __restrict__ zp, float* __restrict__ out,
                                           int M, int K, int N, int per_channel, int xvec,
                                           int wch) {
  constexpr int PS = F::kPasses, SS = F::kSliceSteps, RL = F::kLaneRows, NT = TR / 8, WT = 2;
  constexpr int CPS = SS / kTChunk;                // chunks a slice
  constexpr int RS = F::kStepRows * kTChunk;       // weight rows of a lane's chunk
  constexpr int WS = 2 * RS * kTWRow;              // bytes of a weight stage (two lanes)
  constexpr int BL = PS * TR * kTBRow;             // bf16 of one lane's staged x
  constexpr int XT = 128 / TR;                     // threads staging one lane's x row
  constexpr int XV = 16 * kTChunk / XT;            // x values a thread stages
  constexpr int WTPR = 128 / RS;                   // threads copying one weight row
  static_assert(SS % kTChunk == 0 && NT % 2 == 0 && XV % 8 == 0 && 128 % RS == 0,
                "a slice is whole chunks; ldmatrix takes n8 tiles in pairs");
  extern __shared__ float4 smem4[];
  uint8_t* ws = reinterpret_cast<uint8_t*>(smem4);
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(ws + kTStages * WS);

  const int R = weight_rows(F::kLayout, K);
  const int S = slices<F>(K);
  const int nit = (S + 1) / 2 * CPS;
  const int n0 = blockIdx.x * kTCols, m0 = blockIdx.y * TR;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int wc = warp % 4, kl = warp / 4;
  // the first k-step of lane l's chunk of iteration i
  auto chunk_step = [&](int i, int l) {
    return (2 * (i / CPS) + l) * SS + kTChunk * (i % CPS);
  };

  // weights: a thread copies lane wl's row wrow of the chunk, bytes wseg ..
  // wseg + RS - 1 of the tile
  const int wl = tid / 128, wrow = (tid % 128) / WTPR, wseg = RS * (tid % WTPR);
  auto issue = [&](int i) {
    if (i < nit) {
      uint8_t* d = ws + (i % kTStages) * WS + (wl * RS + wrow) * kTWRow + wseg;
      const int r = chunk_step(i, wl) * F::kStepRows + wrow;
      for (int o = 0; o < RS; o += wch) {
        const int nn = n0 + wseg + o;
        const bool ok = r < R && nn < N;
        jlt::copy_async(d + o, ok ? w + (size_t)r * N + nn : w, wch, ok);
      }
    }
    jlt::copy_commit();
  };
  // x: a thread loads lane xl's row xm, positions xh * XV .. + XV - 1 of the
  // chunk's 16 kTChunk (in mma order) and stages them
  const int xl = tid / 128, xm = (tid % 128) / XT, xh = tid % XT;
  const bool xlive = m0 + xm < M;
  const float* xrow = x + (size_t)(xlive ? m0 + xm : 0) * K;
  auto load_x = [&](int i, float (&v)[XV]) {
    const int ks0 = chunk_step(i, xl);
#pragma unroll
    for (int h = 0; h < XV / 8; ++h) {  // 8 positions: k-step p / 16, half (p / 8) % 2
      const int p = xh * XV + 8 * h;
      int k, nlive;
      k_run<F>(ks0 + p / 16, p & 8, K, &k, &nlive);
      if (!xlive) nlive = 0;
      if (xvec) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float4 f = 4 * q < nlive ? __ldg(reinterpret_cast<const float4*>(xrow + k + 4 * q))
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
          v[8 * h + 4 * q] = f.x;
          v[8 * h + 4 * q + 1] = f.y;
          v[8 * h + 4 * q + 2] = f.z;
          v[8 * h + 4 * q + 3] = f.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[8 * h + e] = e < nlive ? __ldg(xrow + k + e) : 0.f;
      }
    }
  };
  auto stage = [&](int i, const float (&v)[XV]) {
    __nv_bfloat16* d = bs + ((i & 1) * 2 + xl) * BL + xm * kTBRow + xh * XV;
    uint32_t packed[XV / 2][PS];
#pragma unroll
    for (int e = 0; e < XV / 2; ++e) stage_pair<PS>(v[2 * e], v[2 * e + 1], packed[e]);
#pragma unroll
    for (int p = 0; p < PS; ++p)
#pragma unroll
      for (int q = 0; q < XV / 8; ++q)
        reinterpret_cast<uint4*>(d + p * TR * kTBRow)[q] =
            make_uint4(packed[4 * q][p], packed[4 * q + 1][p], packed[4 * q + 2][p],
                       packed[4 * q + 3][p]);
  };

  const int nl = n0 + 32 * wc + 4 * g;  // my 4 columns
  uint32_t zk[2 * WT];
#pragma unroll
  for (int i = 0; i < 2 * WT; ++i) zk[i] = zero_const<F>(zp, nl + i, N, per_channel);
  float acc[WT][NT][4], tot[WT][NT][4];
#pragma unroll
  for (int q = 0; q < WT; ++q)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][nt][e] = tot[q][nt][e] = 0.f;

  // ldmatrix x4 addresses: lane supplies row lane % 8 of matrix lane / 8
  // (matrices: n8 tile 2i k 0-7, 2i k 8-15, 2i+1 k 0-7, 2i+1 k 8-15)
  const uint32_t lbase =
      (uint32_t)__cvta_generic_to_shared(bs + kl * BL) +
      2u * (uint32_t)((8 * (lane / 16) + lane % 8) * kTBRow + 8 * ((lane / 8) % 2));

  float xv[XV];
#pragma unroll
  for (int i = 0; i < kTStages - 1; ++i) issue(i);
  load_x(0, xv);
  stage(0, xv);
  if (nit > 1) load_x(1, xv);
  for (int i = 0; i < nit; ++i) {
    jlt::copy_wait<kTStages - 2>();
    __syncthreads();  // iteration i staged, its weights landed; i - 1 is done with
    issue(i + kTStages - 1);
    if (i + 1 < nit) {
      stage(i + 1, xv);
      if (i + 2 < nit) load_x(i + 2, xv);  // in flight during the products
    }
    const bool live = 2 * (i / CPS) + kl < S;
    if (live) {
      const uint8_t* wt = ws + (i % kTStages) * WS + kl * RS * kTWRow + 32 * wc + 4 * g;
      const uint32_t lb = lbase + 2u * (uint32_t)((i & 1) * 2 * BL);
#pragma unroll
      for (int u = 0; u < kTChunk; ++u) {
        uint32_t wr[RL][1], a[WT][4];
#pragma unroll
        for (int h = 0; h < RL; ++h)
          wr[h][0] = *reinterpret_cast<const uint32_t*>(
              wt + (u * F::kStepRows + lane_row<F>(h, t)) * kTWRow);
        decode_a<F, WT>(wr, zk, a);
#pragma unroll
        for (int p = 0; p < PS; ++p)
#pragma unroll
          for (int n2 = 0; n2 < NT / 2; ++n2) {
            uint32_t b[4];
            const uint32_t addr =
                lb + 2u * (uint32_t)(p * TR * kTBRow + 16 * n2 * kTBRow + 16 * u);
            asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                         : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
                         : "r"(addr));
#pragma unroll
            for (int q = 0; q < WT; ++q) {
              mma_bf16(acc[q][2 * n2], a[q], b[0], b[1]);
              mma_bf16(acc[q][2 * n2 + 1], a[q], b[2], b[3]);
            }
          }
      }
    }
    if (live && i % CPS == CPS - 1) {  // the slice's end
#pragma unroll
      for (int q = 0; q < WT; ++q)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tot[q][nt][e] = __fadd_rn(tot[q][nt][e], acc[q][nt][e]);
            acc[q][nt][e] = 0.f;
          }
    }
  }

  // lane 1's totals to shared memory (over the weight ring), then lane 0
  // adds them and writes out
  jlt::copy_wait<0>();
  __syncthreads();
  float4* odd_tot = reinterpret_cast<float4*>(smem4) + (wc * 32 + lane) * WT * NT;
  if (kl == 1) {
#pragma unroll
    for (int q = 0; q < WT; ++q)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        odd_tot[q * NT + nt] =
            make_float4(tot[q][nt][0], tot[q][nt][1], tot[q][nt][2], tot[q][nt][3]);
  }
  __syncthreads();
  if (kl == 1) return;
  // tile q's rows g, g + 8 are columns 4g + 2q, + 1; n8 tile nt's columns
  // 2t, 2t + 1 are rows 8 nt + 2t, + 1
#pragma unroll
  for (int q = 0; q < WT; ++q)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float4 o = odd_tot[q * NT + nt];
      const float odd[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = nl + 2 * q + e / 2, m = m0 + 8 * nt + 2 * t + e % 2;
        if (m < M && n < N)
          out[(size_t)m * N + n] =
              __fmul_rn(__fadd_rn(tot[q][nt][e], odd[e]), scale[per_channel ? n : 0]);
      }
    }
}

// raise an instance's dynamic shared memory limit once it needs more than 48 KB
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t& set) {
  if (smem <= set) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) set = smem;
  return err;
}

// the decode form's dynamic shared memory for S slices, a cluster of C and M
// rows
template <class F, int NT, int WT, int DW>
size_t decode_smem(int S, int C, int M) {
  constexpr int BN = 16 * WT;
  const int P = DW * C, cw = BN / C, nr = (S + P - 1) / P, BMs = min(8 * NT, M);
  return (size_t)decode_slot_bytes<F, NT, WT>() * kDAhead * 32 * DW +
         sizeof(float) * ((size_t)(nr > 1 ? 2 : 1) * P * BMs * cw +
                          (nr > 1 ? (size_t)2 * BMs * cw : 0) + cw);
}

// The decode form: one launch.  Its cluster is the largest (a power of two
// <= 8, no more parts, DW a block, than slices) whose clusters are all
// resident at once: one wave, no cluster left for a second; sizes whose
// shared memory exceeds a block's are skipped (a larger cluster takes fewer
// rounds, so needs no second gather buffer).
template <class F, int NT, int WT, int DW, class Kernel>
cudaError_t launch_decode(Kernel kernel, const float* x, const int8_t* w, const float* scale,
                          const int* zp, float* out, int M, int K, int N, int per_channel,
                          cudaStream_t stream) {
  constexpr int BM = 8 * NT, BN = 16 * WT;
  static size_t smem_set = 48 * 1024;  // this instance's dynamic shared memory limit
  const int S = slices<F>(K);
  const int tn = (N + BN - 1) / BN, tm = (M + BM - 1) / BM;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(32 * DW, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1] = {};
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto configure = [&](int C) {
    cfg.gridDim = dim3(C * tn, tm, 1);
    cfg.dynamicSmemBytes = decode_smem<F, NT, WT, DW>(S, C, M);
    attr[0].val.clusterDim.x = C;
    return allow_smem(kernel, cfg.dynamicSmemBytes, smem_set);
  };
  static int max_smem = 0;
  if (!max_smem) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  int C = 0;
  for (int c = 1; c <= kMaxCluster && (c == 1 || DW * c <= S); c *= 2) {
    if (decode_smem<F, NT, WT, DW>(S, c, M) > (size_t)max_smem) continue;
    if (C) {
      cudaError_t err = configure(c);
      int fit = 0;
      if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
      if (err != cudaSuccess) return err;
      if (fit < (long)tn * tm) break;
    }
    C = c;
  }
  if (!C) return cudaErrorInvalidValue;
  cudaError_t err = configure(C);
  if (err != cudaSuccess) return err;
  const int wch = min(jlt::copy_width((uintptr_t)w | (uintptr_t)N), 2 * WT);
  return cudaLaunchKernelEx(&cfg, kernel, x, w, scale, zp, out, M, K, N, per_channel, wch);
}

// the tiled form's dynamic shared memory
template <class F, int TR>
constexpr size_t tiled_smem() {
  return (size_t)kTStages * 2 * F::kStepRows * kTChunk * kTWRow +
         sizeof(__nv_bfloat16) * 2 * 2 * F::kPasses * TR * kTBRow;
}

template <class F, int TR, class Kernel>
cudaError_t launch_tiled(Kernel kernel, const float* x, const int8_t* w, const float* scale,
                         const int* zp, float* out, int M, int K, int N, int per_channel,
                         cudaStream_t stream) {
  constexpr size_t smem = tiled_smem<F, TR>();
  static size_t smem_set = 48 * 1024;
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  // 16-byte x loads need 16-byte rows and (split-half) both halves aligned
  const int KR = (K + 1) / 2;
  const int xvec = (uintptr_t)x % 16 == 0 && K % 4 == 0 && (F::kLayout != kSplitHalf4 || KR % 4 == 0);
  const int wch = min(jlt::copy_width((uintptr_t)w | (uintptr_t)N), 16);
  dim3 grid((N + kTCols - 1) / kTCols, (M + TR - 1) / TR, 1);
  kernel<<<grid, kThreads, smem, stream>>>(x, w, scale, zp, out, M, K, N, per_channel, xvec,
                                           wch);
  return cudaSuccess;
}

}  // namespace
}  // namespace mma
}  // namespace jlt
