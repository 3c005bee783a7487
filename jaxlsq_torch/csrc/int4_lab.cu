// The int4 lab's two candidates (lab/int4_kernel_lab.py) on the tensor cores,
// symmetric (no zero point), f32 (M, N) out:
//   wo4_bf16:   out[m, n] = s[n] * sum_k bf16_rn(x[m, k]) * w[k, n]
//     w as the serving pack's split-half bytes (ceil(K/2), N): byte row r
//     holds k = r (low nibble) and k = r + ceil(K/2) (high nibble); any K.
//     Replaces examples/_int4_kernel_lab.py:_wo4_bf16_kernel (:50, launched
//     at :106 in run_bf16), a bf16 dot with an f32 accumulator.
//   wo4_native: out[m, n] = s[n] * sum_k x[m, k] * w[k, n]
//     w K-contiguous (K/2, N) (pack_native): byte row r holds k = 2r (low
//     nibble) and k = 2r + 1 (high nibble); K even.  Replaces
//     _wo4_native_kernel (:72, launched at :136 in run_native), an f32 dot of
//     x and int4 values.
//
// One body serves both; its template parameter (Stage) is how x is staged:
//   kBf16:   x rounded to bf16 once (round to nearest even), one MMA pass;
//   kSplit3: x split exactly into three bf16 parts, hi = bf16_rn(x), mid =
//            bf16_rn(x - hi), lo = bf16_rn(x - hi - mid), hi + mid + lo == x
//            away from the ends of the exponent range, three MMA passes
//            against the same weight fragment.
// A nibble is exact in bf16, so every product is exact in f32 and only the
// tensor cores' f32 accumulation differs from an fmaf chain.
//
// ---- the operands ----
//
// mma.sync m16n8k16 bf16 -> f32 with the operands swapped: the weight is the
// A operand (16 output columns x 16 k, decoded in registers) and the
// activation rows are the n8 side (B), so M = 1 pads to 8 rows, not 16.  A
// k-step covers 8 byte rows, mapped onto mma's k index j so that a lane's A
// fragment (j = 2t, 2t + 1, 2t + 8, 2t + 9 for lane (g, t)) comes from whole
// bytes of two byte rows:
//   split-half: j < 8 is the low nibble of byte row r0 + j, j >= 8 the high
//     nibble of byte row r0 + j - 8 (lane rows r0 + 2t, r0 + 2t + 1); x is
//     staged as x[r0 .. r0 + 7] then x[KR + r0 .. KR + r0 + 7], KR =
//     ceil(K/2);
//   native: j is byte row r0 + j / 2, nibble j % 2 (lane rows r0 + t and
//     r0 + 4 + t); x stays contiguous, x[2 r0 .. 2 r0 + 15].
// A warp's WT m16 tiles take permuted output columns: tile q's row i is
// column (i % 8) * 2 WT + 2q + i / 8, so lane g's rows g and g + 8 of every
// tile are 2 WT adjacent columns, one 32-bit word a row for two tiles (the
// decode form: WT = 8, 16 bytes; the tiled form: WT = 2, 4 bytes).
// A nibble becomes bf16 in registers, two at a time: a byte permute puts the
// two bytes' nibbles at bits 0-3 and 16-19, one lop3 masks them and sets
// 0x43 (bf16 128.0) above each with the nibble ^ 8 as its mantissa (128 + 8
// + v), and one bf16x2 subtract of 136 gives v, exact for every v in [-8, 7]
// (the bf16 counterpart of wo_matmul.cu's mant_minus + biased4).
//
// ---- the summation order: one for every M and every cluster size ----
//
// The byte rows are cut into slices of kSliceRows = 128 (16 k-steps), the
// last padded with zero bytes and x = 0.  A slice partial is the tensor
// cores' chain from +0 over its k-steps in order (kSplit3: hi, mid, lo at
// each k-step).  The even slices' partials are left-folded in slice order
// from +0 in f32 (__fadd_rn) into q0, the odd slices' into q1, and out =
// (q0 + q1) * s[n].  Padding (rows past the weight's; odd split-half K's
// dead high nibble; rows past M) has a zero byte or x = 0.  So a row has the
// same bits in either form below, at every M and cluster size (an MMA's
// output element depends on its own A row, B column and accumulator only).
// The two lanes let the tiled form split K over two warps with no
// cross-warp fold until the end.
//
// ---- what bounds it on an H100, and the two forms ----
//
// At decode M the weight bytes (K N / 2) streamed once: 10 us for K = N =
// 8192 at 3.35 TB/s; at prefill M the tensor cores, 2 M K N (x3 for kSplit3)
// at 989 TFLOP/s bf16 (mma.sync reaches part of that; wgmma is later work).
//
// Decode form (M <= 16: NT = 1 or 2 n8 tiles, BM = 8 NT rows).  A block is 8
// warps on one 128-column tile (8 m16 tiles a warp: 16 bytes a lane and
// byte row); every warp is one part of the K split and a thread-block
// cluster of C blocks (a power of two <= 8: the largest whose clusters are
// all resident at once, no more parts than slices) splits it further: in
// round j part p (= rank * 8 + warp) sums slice j * 8C + p.  Each lane
// streams its own weight bytes kDAhead k-steps ahead by cp.async into a
// ring in shared memory (no barrier: a lane waits for its own copies),
// reads x straight from global memory (L1/L2: it is small) a k-step ahead
// and converts it in registers, stores its partial into the shared memory
// of the block that owns its columns (block r owns columns [r, r + 1) *
// 128 / C of the tile), and after one cluster barrier every block folds its
// columns (two gather buffers when there is more than one round).
//
// Tiled form (M > 16).  A block owns a 128 x 64 (columns x rows) tile and
// all of K; 8 warps, each 32 columns x 64 rows (2 m16 x 8 n8) of one lane
// (the even or the odd slices).  The weight bytes arrive by cp.async in a
// 4-stage ring; x is loaded into registers an iteration ahead and staged
// once a block as bf16 (kSplit3: split once) in a double buffer that the
// warps read with ldmatrix; one barrier an iteration.  Each warp adds its
// slice accumulator into its lane's running total at every slice's end, and
// the odd lane's totals reach the even lane's warps through shared memory
// at the end: the decode form's bits.  x traffic from L2 is (N / 128) x the
// bytes of x (256 MiB at M = 128, K = N = 8192).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace cg = cooperative_groups;

namespace {

enum Stage { kBf16, kSplit3 };  // wo4_bf16 (split-half bytes), wo4_native (K-contiguous)

template <int ST>
__host__ __device__ constexpr int passes() { return ST == kBf16 ? 1 : 3; }

constexpr int kSliceSteps = 16;               // k-steps a slice
constexpr int kSliceRows = 8 * kSliceSteps;   // byte rows a slice
constexpr int kThreads = 256;                 // 8 warps, both forms
constexpr int kMaxCluster = 8;
constexpr int kDecodeMaxRows = 16;            // the decode form up to this M
constexpr int kDTiles = 8;                    // decode form: m16 tiles a warp (16 kDTiles columns)
constexpr int kDAhead = 4;                    // decode form: k-steps in flight a lane
constexpr int kTCols = 128, kTRows = 64;      // tiled form: the block's tile
constexpr int kTChunk = 4;                    // tiled form: k-steps a lane an iteration
constexpr int kTStages = 4;                   // tiled form: weight ring stages
constexpr int kTWRow = kTCols + 16;           // bytes a weight row and bf16 a staged x
constexpr int kTBRow = 16 * kTChunk + 8;      // row in shared memory (padded: a warp's
                                              // 4-byte weight reads and ldmatrix rows
                                              // hit distinct banks)

// weight byte rows of a K: ceil(K / 2) split-half, K / 2 native
__host__ __device__ __forceinline__ int byte_rows(int st, int K) {
  return st == kBf16 ? (K + 1) / 2 : K / 2;
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// two signed nibbles (bits 0-3 and 16-19 of X) as an exact bf16x2: (the
// nibble ^ 8) as the mantissa of 128.0, less 136
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t X) {
  uint32_t h = (X & 0x000F000Fu) ^ 0x43084308u;
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&h);
  return bf2_bits(__hsub2(v, __floats2bfloat162_rn(136.f, 136.f)));
}

// A fragments of WT m16 tiles for one k-step from a lane's two byte-row
// words per pair of tiles (wa, wb: split-half rows r0 + 2t, r0 + 2t + 1;
// native rows r0 + t, r0 + 4 + t); byte c of word v is tile 2v + c / 2, MMA
// row g + 8 (c % 2)
template <int ST, int WT>
__device__ __forceinline__ void decode_a(const uint32_t (&wa)[WT / 2], const uint32_t (&wb)[WT / 2],
                                         uint32_t (&a)[WT][4]) {
#pragma unroll
  for (int v = 0; v < WT / 2; ++v)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int q = 2 * v + c / 2, e = c % 2;
      const uint32_t sel = c | (c + 4) << 8;  // byte c of each source to bytes 0 and 2
      if (ST == kBf16) {  // j = 2t, 2t+1: low nibbles of rows a, b; j + 8: their high nibbles
        const uint32_t X = __byte_perm(wa[v], wb[v], sel);
        a[q][e] = nibbles_bf16x2(X);
        a[q][2 + e] = nibbles_bf16x2(X >> 4);
      } else {  // j = 2t, 2t+1: row a's low, high nibble; j + 8: row b's
        a[q][e] = nibbles_bf16x2(__byte_perm(wa[v], wa[v] >> 4, sel));
        a[q][2 + e] = nibbles_bf16x2(__byte_perm(wb[v], wb[v] >> 4, sel));
      }
    }
}

// x values (x0, x1) as the B operand's bf16x2 of each pass
template <int ST>
__device__ __forceinline__ void stage_pair(float x0, float x1, uint32_t (&b)[passes<ST>()]) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
  b[0] = bf2_bits(hi);
  if (ST == kSplit3) {
    const float2 hf = __bfloat1622float2(hi);
    const float r0 = __fsub_rn(x0, hf.x), r1 = __fsub_rn(x1, hf.y);
    const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
    const float2 mf = __bfloat1622float2(mid);
    b[1 % passes<ST>()] = bf2_bits(mid);
    b[2 % passes<ST>()] = bf2_bits(__floats2bfloat162_rn(__fsub_rn(r0, mf.x), __fsub_rn(r1, mf.y)));
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a lane's weight rows of k-step ks (its byte rows: split-half 8 ks + 2t and
// + 1, native 8 ks + t and + 4)
template <int ST>
__device__ __forceinline__ int row_a(int ks, int t) { return 8 * ks + (ST == kBf16 ? 2 * t : t); }
template <int ST>
__device__ __forceinline__ int row_b(int ks, int t) {
  return row_a<ST>(ks, t) + (ST == kBf16 ? 1 : 4);
}

// x[m, k], 0 past M and K
__device__ __forceinline__ float x_at(const float* __restrict__ x, int m, int M, int K, int k) {
  return (m < M && k < K) ? __ldg(x + (size_t)m * K + k) : 0.f;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Decode form.  grid (C x column tiles, row tiles), cluster (C, 1, 1), 8
// warps on a 16 WT-column tile.  Dynamic shared memory: each lane's ring of
// its own weight bytes, [kDAhead][kThreads] x 4 WT bytes (a k-step's two
// rows, copied by cp.async: no barrier, each lane waits for its own
// copies), then the gather, [nbuf][8C][BM][16 WT / C] floats (nbuf 2 with
// more than one round, else 1), then with more than one round the lanes'
// running totals [2][BM][16 WT / C].
template <int ST, int NT, int WT>
__global__ void __launch_bounds__(kThreads)
lab_decode_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, float* __restrict__ out, int M, int K, int N,
                  int wch) {
  constexpr int BM = 8 * NT, PS = passes<ST>(), BN = 16 * WT, LB = 4 * WT;  // LB: lane bytes
  extern __shared__ float4 smem4[];
  // this lane's ring slot i: ring + i * LB * kThreads
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4) + LB * threadIdx.x;
  float* gat = reinterpret_cast<float*>(smem4) + kDAhead * kThreads * WT;

  cluster_arrive_relaxed();  // this block has started (its shared memory exists)
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.dim_blocks().x, rank = (int)cluster.block_rank();
  const int cw = BN / C, P = 8 * C;
  const int R = byte_rows(ST, K), KR = (K + 1) / 2;
  const int S = (R + kSliceRows - 1) / kSliceRows, nr = (S + P - 1) / P;
  const int nbuf = nr > 1 ? 2 : 1;
  float* tots = gat + (size_t)nbuf * P * BM * cw;
  const int n0 = (blockIdx.x / C) * BN, m0 = blockIdx.y * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int part = rank * 8 + warp;
  const int nl = n0 + 2 * WT * g;  // my 2 WT columns
  const int owner = 2 * WT * g / cw, ocol = 2 * WT * g - owner * cw;  // who folds them
  if (nr > 1)
    for (int i = threadIdx.x; i < 2 * BM * cw; i += kThreads) tots[i] = 0.f;
  cluster_wait();  // every block of the cluster has started
  float* dgat = cluster.map_shared_rank(gat, owner);

  for (int j = 0; j < nr; ++j) {
    const int s = j * P + part;
    float* buf = dgat + (size_t)(nbuf > 1 ? (j & 1) : 0) * P * BM * cw;
    if (s < S) {
      const int ks0 = s * kSliceSteps;
      // k-step u's two rows into ring slot u % kDAhead (one group a k-step,
      // empty past the slice)
      auto issue = [&](int u) {
        if (u < kSliceSteps) {
          uint8_t* d = ring + (u % kDAhead) * LB * kThreads;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = h ? row_b<ST>(ks0 + u, t) : row_a<ST>(ks0 + u, t);
            for (int o = 0; o < 2 * WT; o += wch) {
              const bool ok = r < R && nl + o < N;
              jlt::copy_async(d + 2 * WT * h + o, ok ? w + (size_t)r * N + nl + o : w, wch, ok);
            }
          }
        }
        jlt::copy_commit();
      };
      // x of k-step u for n8 tile nt (the B operand's four values)
      auto load_x = [&](int u, float (&v)[NT][4]) {
        const int ks = ks0 + u;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int m = m0 + 8 * nt + g;
          if (ST == kBf16) {
            const int r = 8 * ks + 2 * t;  // low nibbles of rows r, r + 1; high: k + KR
            v[nt][0] = r < KR ? x_at(x, m, M, K, r) : 0.f;
            v[nt][1] = r + 1 < KR ? x_at(x, m, M, K, r + 1) : 0.f;
            v[nt][2] = r < KR ? x_at(x, m, M, K, r + KR) : 0.f;
            v[nt][3] = r + 1 < KR ? x_at(x, m, M, K, r + 1 + KR) : 0.f;
          } else {
            const int k = 16 * ks + 2 * t;
            v[nt][0] = x_at(x, m, M, K, k);
            v[nt][1] = x_at(x, m, M, K, k + 1);
            v[nt][2] = x_at(x, m, M, K, k + 8);
            v[nt][3] = x_at(x, m, M, K, k + 9);
          }
        }
      };
      float acc[WT][NT][4];
#pragma unroll
      for (int q = 0; q < WT; ++q)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][nt][e] = 0.f;
      // one k-step: wait for its bytes, decode, stage x, the products
      auto step = [&](int u, const float (&v)[NT][4]) {
        issue(u + kDAhead - 1);
        jlt::copy_wait<kDAhead - 1>();
        const uint32_t* wv =
            reinterpret_cast<const uint32_t*>(ring + (u % kDAhead) * LB * kThreads);
        uint32_t wa[WT / 2], wb[WT / 2], a[WT][4], b[NT][2][PS];
#pragma unroll
        for (int i = 0; i < WT / 2; ++i) {
          wa[i] = wv[i];
          wb[i] = wv[WT / 2 + i];
        }
        decode_a<ST, WT>(wa, wb, a);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          stage_pair<ST>(v[nt][0], v[nt][1], b[nt][0]);
          stage_pair<ST>(v[nt][2], v[nt][3], b[nt][1]);
        }
#pragma unroll
        for (int p = 0; p < PS; ++p)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int q = 0; q < WT; ++q) mma_bf16(acc[q][nt], a[q], b[nt][0][p], b[nt][1][p]);
      };
#pragma unroll
      for (int u = 0; u < kDAhead - 1; ++u) issue(u);
      float xa[NT][4], xb[NT][4];
      load_x(0, xa);
#pragma unroll 1
      for (int u = 0; u < kSliceSteps; u += 2) {  // x one k-step ahead
        load_x(u + 1, xb);
        step(u, xa);
        if (u + 2 < kSliceSteps) load_x(u + 2, xa);
        step(u + 1, xb);
      }
      // row 8 nt + 2t + e of columns 2 WT g + 2q (+1): acc[q][nt][e] (acc[q][nt][2 + e])
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float4* d = reinterpret_cast<float4*>(
              buf + ((size_t)part * BM + 8 * nt + 2 * t + e) * cw + ocol);
#pragma unroll
          for (int q = 0; q < WT; q += 2)
            d[q / 2] = make_float4(acc[q][nt][e], acc[q][nt][2 + e], acc[q + 1][nt][e],
                                   acc[q + 1][nt][2 + e]);
        }
    }
    cluster.sync();  // round j's partials have landed in their owners
    // fold: even slices into lane 0, odd into lane 1, each in slice order
    const float* gb = gat + (size_t)(nbuf > 1 ? (j & 1) : 0) * P * BM * cw;
    const int nlive = min(P, S - j * P), mt = min(BM, M - m0);
    for (int i = threadIdx.x; i < mt * cw; i += kThreads) {
      const int m = i / cw, c = i - m * cw, n = n0 + rank * cw + c;
      float q0 = nr > 1 ? tots[i] : 0.f, q1 = nr > 1 ? tots[BM * cw + i] : 0.f;
      for (int p = 0; p < nlive; p += 2) {
        q0 = __fadd_rn(q0, gb[((size_t)p * BM + m) * cw + c]);
        if (p + 1 < nlive) q1 = __fadd_rn(q1, gb[((size_t)(p + 1) * BM + m) * cw + c]);
      }
      if (j + 1 < nr) {
        tots[i] = q0;
        tots[BM * cw + i] = q1;
      } else if (n < N) {
        out[(size_t)(m0 + m) * N + n] = __fmul_rn(__fadd_rn(q0, q1), scale[n]);
      }
    }
  }
}

// Tiled form.  grid (column tiles, row tiles), 8 warps: warp (wc, kl) =
// (warp % 4, warp / 4) owns columns n0 + 32 wc ... + 31 and all kTRows rows
// of the tile, for the slices of lane kl (s % 2 == kl).  Iteration i takes
// chunk i % 4 of slice pair i / 4 (slices 2 (i / 4) and 2 (i / 4) + 1, one a
// lane): kTChunk k-steps.  The weight bytes arrive by cp.async in a ring of
// kTStages stages, [2 lanes][8 kTChunk][kTWRow]; x is loaded into registers
// an iteration ahead, then staged as bf16 (kSplit3: its three parts) into a
// double buffer [2][2 lanes][passes][kTRows][kTBRow] that the warps read with
// ldmatrix: one barrier an iteration.  At the end the odd lane's totals pass
// through shared memory to the even lane's warps, which add them.
template <int ST>
__global__ void __launch_bounds__(kThreads)
lab_tiled_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, float* __restrict__ out, int M, int K, int N,
                 int xvec, int wch) {
  constexpr int PS = passes<ST>(), NT = kTRows / 8, WT = 2;
  constexpr int WS = 2 * 8 * kTChunk * kTWRow;  // bytes of a weight stage (two lanes)
  constexpr int BL = PS * kTRows * kTBRow;      // bf16 of one lane's staged x
  constexpr int XV = 2 * 16 * kTChunk * kTRows / kThreads;  // x values a thread stages
  static_assert(XV == 32 && 2 * 8 * kTChunk * (kTCols / 32) == kThreads,
                "a thread stages two k-steps of one x row and copies 32 weight bytes");
  extern __shared__ float4 smem4[];
  uint8_t* ws = reinterpret_cast<uint8_t*>(smem4);
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(ws + kTStages * WS);

  const int R = byte_rows(ST, K), KR = (K + 1) / 2;
  const int S = (R + kSliceRows - 1) / kSliceRows;
  const int nit = (S + 1) / 2 * (kSliceSteps / kTChunk);
  const int n0 = blockIdx.x * kTCols, m0 = blockIdx.y * kTRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int wc = warp % 4, kl = warp / 4;
  // the first byte row of lane l's chunk of iteration i
  auto chunk_row = [&](int i, int l) {
    return ((2 * (i / 4) + l) * kSliceSteps + kTChunk * (i % 4)) * 8;
  };

  // weights: a thread copies lane wl's byte row wrow of the chunk, bytes
  // wseg .. wseg + 31 of the tile
  const int wl = tid / 128, wrow = (tid / 4) % 32, wseg = 32 * (tid % 4);
  auto issue = [&](int i) {
    if (i < nit) {
      uint8_t* d = ws + (i % kTStages) * WS + (wl * 8 * kTChunk + wrow) * kTWRow + wseg;
      const int r = chunk_row(i, wl) + wrow;
      for (int o = 0; o < 32; o += wch) {
        const int nn = n0 + wseg + o;
        const bool ok = r < R && nn < N;
        jlt::copy_async(d + o, ok ? w + (size_t)r * N + nn : w, wch, ok);
      }
    }
    jlt::copy_commit();
  };
  // x: a thread loads lane xl's row xm, k-steps 2 xh and 2 xh + 1 (32 values
  // in position order) and stages them
  const int xl = tid / 128, xm = (tid / 2) % kTRows, xh = tid % 2;
  const bool xlive = m0 + xm < M;
  const float* xrow = x + (size_t)(xlive ? m0 + xm : 0) * K;
  auto load_x = [&](int i, float (&v)[XV]) {
    const int r0 = chunk_row(i, xl) + 16 * xh;  // byte row of the first k-step
#pragma unroll
    for (int h = 0; h < XV / 8; ++h) {  // 8 positions: k-step h / 2, half h % 2
      // split-half: low half x[r .. r + 7], high x[KR + r ..], r = r0 + 8 (h / 2);
      // native: x[2 r0 + 8 h ..]
      const int r = r0 + 8 * (h / 2);
      const int k = ST == kBf16 ? (h % 2 ? KR + r : r) : 2 * r0 + 8 * h;
      if (xvec) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const bool ok = xlive && k + 4 * q < K && (ST != kBf16 || r + 4 * q < KR);
          const float4 f = ok ? __ldg(reinterpret_cast<const float4*>(xrow + k + 4 * q))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
          v[8 * h + 4 * q] = f.x;
          v[8 * h + 4 * q + 1] = f.y;
          v[8 * h + 4 * q + 2] = f.z;
          v[8 * h + 4 * q + 3] = f.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const bool ok = xlive && k + e < K && (ST != kBf16 || r + e < KR);
          v[8 * h + e] = ok ? __ldg(xrow + k + e) : 0.f;
        }
      }
    }
  };
  auto stage = [&](int i, const float (&v)[XV]) {
    __nv_bfloat16* d = bs + ((i & 1) * 2 + xl) * BL + xm * kTBRow + 32 * xh;
    uint32_t packed[XV / 2][PS];
#pragma unroll
    for (int e = 0; e < XV / 2; ++e) stage_pair<ST>(v[2 * e], v[2 * e + 1], packed[e]);
#pragma unroll
    for (int p = 0; p < PS; ++p)
#pragma unroll
      for (int q = 0; q < XV / 8; ++q)
        reinterpret_cast<uint4*>(d + p * kTRows * kTBRow)[q] =
            make_uint4(packed[4 * q][p], packed[4 * q + 1][p], packed[4 * q + 2][p],
                       packed[4 * q + 3][p]);
  };

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
    const bool live = 2 * (i / 4) + kl < S;
    if (live) {
      const uint8_t* wt = ws + (i % kTStages) * WS + kl * 8 * kTChunk * kTWRow + 32 * wc + 4 * g;
      const uint32_t lb = lbase + 2u * (uint32_t)((i & 1) * 2 * BL);
#pragma unroll
      for (int u = 0; u < kTChunk; ++u) {
        uint32_t wa[1], wb[1], a[WT][4];
        wa[0] = *reinterpret_cast<const uint32_t*>(wt + row_a<ST>(u, t) * kTWRow);
        wb[0] = *reinterpret_cast<const uint32_t*>(wt + row_b<ST>(u, t) * kTWRow);
        decode_a<ST, WT>(wa, wb, a);
#pragma unroll
        for (int p = 0; p < PS; ++p)
#pragma unroll
          for (int n2 = 0; n2 < NT / 2; ++n2) {
            uint32_t b[4];
            const uint32_t addr =
                lb + 2u * (uint32_t)(p * kTRows * kTBRow + 16 * n2 * kTBRow + 16 * u);
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
    if (live && i % 4 == 3) {  // the slice's end
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
  const int nl = n0 + 32 * wc + 4 * g;
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
          out[(size_t)m * N + n] = __fmul_rn(__fadd_rn(tot[q][nt][e], odd[e]), scale[n]);
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

// the decode form's dynamic shared memory for S slices and a cluster of C
template <int NT, int WT>
size_t decode_smem(int S, int C) {
  constexpr int BM = 8 * NT, BN = 16 * WT;
  const int P = 8 * C, cw = BN / C, nr = (S + P - 1) / P;
  return (size_t)4 * WT * kDAhead * kThreads +
         sizeof(float) * ((size_t)(nr > 1 ? 2 : 1) * P * BM * cw +
                          (nr > 1 ? (size_t)2 * BM * cw : 0));
}

template <int ST, int NT, int WT>
cudaError_t launch_decode(const float* x, const int8_t* w, const float* scale, float* out, int M,
                          int K, int N, cudaStream_t stream) {
  constexpr int BM = 8 * NT, BN = 16 * WT;
  auto kernel = lab_decode_kernel<ST, NT, WT>;
  static size_t smem_set = 48 * 1024;  // this instance's dynamic shared memory limit
  const int S = (byte_rows(ST, K) + kSliceRows - 1) / kSliceRows;
  const int tn = (N + BN - 1) / BN, tm = (M + BM - 1) / BM;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1] = {};
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto configure = [&](int C) {
    cfg.gridDim = dim3(C * tn, tm, 1);
    cfg.dynamicSmemBytes = decode_smem<NT, WT>(S, C);
    attr[0].val.clusterDim.x = C;
    return allow_smem(kernel, cfg.dynamicSmemBytes, smem_set);
  };
  // the largest cluster (a power of two <= 8, no more parts, 8 a block,
  // than slices) whose clusters are all resident at once: one wave, no
  // cluster left for a second
  int C = 1;
  for (int c = 2; c <= kMaxCluster && 8 * c <= S; c *= 2) {
    cudaError_t err = configure(c);
    int fit = 0;
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (fit < (long)tn * tm) break;
    C = c;
  }
  cudaError_t err = configure(C);
  if (err != cudaSuccess) return err;
  const int wch = min(jlt::copy_width((uintptr_t)w | (uintptr_t)N), 2 * WT);
  return cudaLaunchKernelEx(&cfg, kernel, x, w, scale, out, M, K, N, wch);
}

template <int ST>
cudaError_t launch_tiled(const float* x, const int8_t* w, const float* scale, float* out, int M,
                         int K, int N, cudaStream_t stream) {
  const size_t smem = kTStages * 2 * 8 * kTChunk * kTWRow +
                      sizeof(__nv_bfloat16) * 2 * 2 * passes<ST>() * kTRows * kTBRow;
  static size_t smem_set = 48 * 1024;
  cudaError_t err = allow_smem(lab_tiled_kernel<ST>, smem, smem_set);
  if (err != cudaSuccess) return err;
  // 16-byte x loads need 16-byte rows and (split-half) both halves aligned
  const int KR = (K + 1) / 2;
  const int xvec = (uintptr_t)x % 16 == 0 && K % 4 == 0 && (ST != kBf16 || KR % 4 == 0);
  const int wch = min(jlt::copy_width((uintptr_t)w | (uintptr_t)N), 16);
  dim3 grid((N + kTCols - 1) / kTCols, (M + kTRows - 1) / kTRows, 1);
  lab_tiled_kernel<ST><<<grid, kThreads, smem, stream>>>(x, w, scale, out, M, K, N, xvec, wch);
  return cudaSuccess;
}

template <int ST>
cudaError_t launch_lab(const float* x, const int8_t* w, const float* scale, float* out, int M,
                       int K, int N, cudaStream_t stream) {
  if (M <= 8) return launch_decode<ST, 1, kDTiles>(x, w, scale, out, M, K, N, stream);
  if (M <= kDecodeMaxRows) return launch_decode<ST, 2, kDTiles>(x, w, scale, out, M, K, N, stream);
  return launch_tiled<ST>(x, w, scale, out, M, K, N, stream);
}

}  // namespace

extern "C" {

// The int4 lab: x f32 (M, K); w int8 bytes, (ceil(K / 2), N) split-half
// (native = 0, wo4_bf16) or (K / 2, N) K-contiguous (native = 1, wo4_native;
// odd K: cudaErrorInvalidValue), 4-byte aligned; scale f32 (N,); out f32
// (M, N).  One kernel launch, no workspace, the form chosen by M (the same
// bits in either).  Returns the launch's error, else cudaGetLastError().
int jlt_int4_lab(const void* x, const void* w, const void* scale, void* out, int M, int K,
                 int N, int native, void* stream) {
  const float* xf = (const float*)x;
  const int8_t* wb = (const int8_t*)w;
  const float* sf = (const float*)scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (native) {
    if (K % 2) return (int)cudaErrorInvalidValue;
    err = launch_lab<kSplit3>(xf, wb, sf, (float*)out, M, K, N, s);
  } else {
    err = launch_lab<kBf16>(xf, wb, sf, (float*)out, M, K, N, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
