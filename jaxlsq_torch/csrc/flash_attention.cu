// Causal flash attention for the training path: the forward and the backward.
//
// Replaces the upstream TPU kernels that jaxlsq/models/zoo.py:
// _flash_train_attention (:433) calls, in jax/experimental/pallas/ops/tpu/
// flash_attention.py: the forward kernel (:331, launched :758), the dK/dV
// kernel (:796, launched :1121) and the dQ kernel (:1146, launched :1456).
// q, k, v, o, dO are (BH, t, HD) f32 row-major per (batch, head); lse and D
// are (BH, t).  Scores are S = (q . k) * sm on the causal triangle (key <=
// query); each row's softmax is carried as its log-sum-exp, lse = m + log(l).
//
// flash_fwd: one block per (bh, 64-query tile), longest rows first.  K/V
//   tiles of BN keys stream through shared memory from key 0 up to the
//   diagonal; tiles above it are never read.  Online softmax in f32 (running
//   max m and sum l per row, accurate expf); writes out = acc / l and lse.
// flash_bwd: one launch, grid (2 * n_tiles, BH), two block roles:
//   - blocks [0, n_tiles) own a 64-key tile (key tile 0, the longest walk,
//     first).  K and V stay in shared memory; query tiles (Q, dO, lse, D)
//     stream from the diagonal down.  Per tile: S^T = K Q^T, dP^T = V dO^T,
//     P^T = exp(S^T * sm - lse), dS^T = P^T o (dP^T - D), dV += P^T dO,
//     dK += dS^T Q (times sm at the end).  S^T and dP^T come out of the
//     products already transposed, so P^T and dS^T are the A operands of the
//     dV and dK products with no transpose;
//   - blocks [n_tiles, 2 n_tiles) own a 64-query tile (the longest first).
//     Q and dO stay in shared memory; key tiles stream from key 0 to the
//     diagonal: S, dP, dS as above, dQ += dS K (times sm at the end).
//   D = rowsum(dO o O) is the caller's (one tensor op), as upstream computes
//   `di` outside its kernels.
//
// Every block owns its output rows and sums them in a fixed order: no
// atomics, so the results are the same bits on every run (the captured train
// step is held equal to the eager one leaf by leaf).  Rows and keys at or
// past t (the ragged last tile) are loaded as zeros, masked out of every
// softmax and every sum, and never written.
//
// What bounds it on an H100: at the training shapes (t = 2048-4096, HD = 64)
// the forward does 2 products of 2 * HD flops a (query, key) pair of the
// causal triangle and the backward 7 (S and dP in both roles, dV, dK, dQ),
// against 4-9 (t, HD) tensors moved: operations bound.  The products run on
// the tensor cores as 3xTF32 (CUTLASS's OpMultiplyAddFastF32 scheme): each
// f32 operand x is split into big = tf32(x) and small = tf32(x - big), and
// each m16n8k8 product accumulates small.big, big.small and then big.big in
// f32 (mma.sync ... .tf32, an sm_80 instruction that runs on sm_90a).  That
// keeps f32-class accuracy (the dropped small.small term is below 2^-21
// relative) at 3 tensor-core passes: a bound of 3 * flops / 495 TFLOP/s,
// against flops / 67 TFLOP/s on the CUDA cores.  Design:
//   - 4 warps a block; each warp owns 16 rows of the block's 64 (query rows
//     in the forward and the dQ role, keys in the dK/dV role), so the online
//     softmax and the masks work on the warp's own accumulator fragments with
//     quad shuffles and no block barrier; only tiles that cross the diagonal
//     (or t) are masked;
//   - a score fragment becomes the A operand of the next product in
//     registers: an accumulator holds columns 2t, 2t + 1 of its 8-column
//     strip in lane (g, t), so the product takes them as its k = t and
//     k = t + 4 and reads the B operand's rows 2t and 2t + 1 to match;
//   - each tile's P V, P^T dO, dS^T Q or dS K is summed on the tensor cores
//     into a zeroed fragment and added to the running sum in f32: the tensor
//     cores' accumulation rounds toward zero, and a running sum fed by them
//     drifts over a long walk (4096 queries);
//   - streamed tiles are double-buffered in shared memory with cp.async
//     (16 bytes a thread, zero-filled past t); tile j + 1 is issued before
//     tile j's products;
//   - every tile has a row stride of HD + 4 floats, so both fragment loads
//     (lane (g, t) at row g, column t: bank 4g + t; and at rows 2t, 2t + 1,
//     column g: bank 8t + g) hit 32 different banks;
//   - the tile sizes are template parameters per head_dim (`Tiles` below).
//     wgmma/TMA are the next step (for TF32 wgmma wants both operands
//     K-major; V is not).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows a block owns: queries, or keys in the dK/dV role

// Tile sizes per head_dim, chosen on the H100: BN, the width of the streamed
// tiles (keys, or queries in the dK/dV role) in the forward and the backward,
// and the backward's blocks an SM for __launch_bounds__ (HD 64: 3 blocks of
// 70 KB, at the cost of a few spilled registers).
template <int HD>
struct Tiles;
template <>
struct Tiles<32> {
  static constexpr int kFwd = 64, kBwd = 32, kBwdBlocks = 1;
};
template <>
struct Tiles<64> {
  static constexpr int kFwd = 64, kBwd = 32, kBwdBlocks = 3;
};
template <>
struct Tiles<128> {
  static constexpr int kFwd = 32, kBwd = 16, kBwdBlocks = 1;
};

// ---- 3xTF32 tensor-core products ------------------------------------------

// x = big + small: big is x rounded to TF32 (to nearest, ties away: the bits
// of cvt.rna.tf32.f32 for finite x, in two integer ops, where cvt.rna
// compiles to a guarded sequence); small is the exact remainder x - big
// truncated to TF32, the bits the tensor cores read of it anyway.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[n] += a b[n] for one m16n8k8 step of N products in 3xTF32 (CUTLASS's
// OpMultiplyAddFastF32 order): small.big, big.small, then big.big, each pass
// over all N accumulators, so dependent products are N instructions apart.
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N][4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], const uint32_t (&bb)[N][2],
                                     const uint32_t (&bs)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], as, bb[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], ab, bs[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], ab, bb[n]);
}

// Fragments, for lane (g, t) = (lane / 4, lane % 4); tiles have stride LD.
// A (16 x 8): rows r0 + g, r0 + g + 8 at columns c0 + t, c0 + t + 4.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&ab)[4], uint32_t (&as)[4],
                                       const float* s, int r0, int c0, int g, int tq) {
  const float* p = s + (r0 + g) * LD + c0 + tq;
  split_tf32(p[0], ab[0], as[0]);
  split_tf32(p[8 * LD], ab[1], as[1]);
  split_tf32(p[4], ab[2], as[2]);
  split_tf32(p[8 * LD + 4], ab[3], as[3]);
}

// B (8 x 8) of a product with a tile's transpose, B[k][n] = tile[n0 + n][c0 + k]:
// row n0 + g at columns c0 + t, c0 + t + 4.
template <int LD>
__device__ __forceinline__ void load_bt(uint32_t (&bb)[2], uint32_t (&bs)[2],
                                        const float* s, int n0, int c0, int g, int tq) {
  const float* p = s + (n0 + g) * LD + c0 + tq;
  split_tf32(p[0], bb[0], bs[0]);
  split_tf32(p[4], bb[1], bs[1]);
}

// B (8 x 8) of a product with the tile itself, B[k][n] = tile[k0 + k][n0 + n],
// in the k order of `acc_to_a`: rows k0 + 2t, k0 + 2t + 1 at column n0 + g.
template <int LD>
__device__ __forceinline__ void load_bp(uint32_t (&bb)[2], uint32_t (&bs)[2],
                                        const float* s, int k0, int n0, int g, int tq) {
  const float* p = s + (k0 + 2 * tq) * LD + n0 + g;
  split_tf32(p[0], bb[0], bs[0]);
  split_tf32(p[LD], bb[1], bs[1]);
}

// An accumulator fragment (16 x 8: rows g, g + 8, columns 2t, 2t + 1) as the A
// operand of the next product: column 2t is its k = t, column 2t + 1 its
// k = t + 4 (load_bp reads B's rows in the same order).
__device__ __forceinline__ void acc_to_a(uint32_t (&ab)[4], uint32_t (&as)[4],
                                         const float (&c)[4]) {
  split_tf32(c[0], ab[0], as[0]);
  split_tf32(c[2], ab[1], as[1]);
  split_tf32(c[1], ab[2], as[2]);
  split_tf32(c[3], ab[3], as[3]);
}

// acc[j] += (16 rows r0.. of a) (rows 8j.. of b)^T over HD: the warp's
// 16 x (8 NT) strip of A B^T for an a tile and a b tile in shared memory.
template <int HD, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const float* a, int r0,
                                        const float* b, int g, int tq) {
  constexpr int kLd = HD + 4;
#pragma unroll
  for (int kd = 0; kd < HD / 8; ++kd) {
    uint32_t ab[4], as[4];
    load_a<kLd>(ab, as, a, r0, 8 * kd, g, tq);
    uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) load_bt<kLd>(bb[j], bs[j], b, 8 * j, 8 * kd, g, tq);
    mma3<NT>(acc, ab, as, bb, bs);
  }
}

// acc[e] += p (8 NT columns, in registers) . m (8 NT rows of a tile), over HD
// output columns 8e...  The tile's product is summed on the tensor cores into
// a zeroed fragment and added to acc in f32: the tensor cores' accumulation
// rounds toward zero, so a running sum over a whole walk (4096 queries)
// would drift by up to an ulp a step; one f32 add a tile keeps round to
// nearest across tiles.  Output columns go EC at a time (HD 128 in two
// halves), so the zeroed fragment stays within the register budget.
template <int HD, int NT>
__device__ __forceinline__ void mma_pm(float (&acc)[HD / 8][4], const float (&p)[NT][4],
                                       const float* m, int g, int tq) {
  constexpr int kLd = HD + 4, kEC = HD / 8 < 8 ? HD / 8 : 8;
#pragma unroll
  for (int e0 = 0; e0 < HD / 8; e0 += kEC) {
    float part[kEC][4];
#pragma unroll
    for (int e = 0; e < kEC; ++e) part[e][0] = part[e][1] = part[e][2] = part[e][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ab[4], as[4];
      acc_to_a(ab, as, p[j]);
      uint32_t bb[kEC][2], bs[kEC][2];
#pragma unroll
      for (int e = 0; e < kEC; ++e) load_bp<kLd>(bb[e], bs[e], m, 8 * j, 8 * (e0 + e), g, tq);
      mma3<kEC>(part, ab, as, bb, bs);
    }
#pragma unroll
    for (int e = 0; e < kEC; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[e0 + e][i] += part[e][i];
  }
}

// ---- copies ----------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of a (t, HD) matrix into shared memory (stride
// HD + 4), asynchronously; rows at or past t become zeros.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* s, const float* g, int row0, int t) {
  constexpr int kVec = HD / 4, kLd = HD + 4;
  for (int i = threadIdx.x; i < ROWS * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    const bool ok = row0 + r < t;
    cp_async16(s + r * kLd + c, g + (size_t)(ok ? row0 + r : 0) * HD + c, ok);
  }
}

// Entries [row0, row0 + N) of two (t,) vectors into a[0, N) and b[0, N); 0 past t.
template <int N>
__device__ __forceinline__ void load_rows(float* a, float* b, const float* ga,
                                          const float* gb, int row0, int t) {
  const int i = threadIdx.x % N;
  const bool ok = row0 + i < t;
  const int src = ok ? row0 + i : 0;
  if (threadIdx.x < N)
    cp_async4(a + i, ga + src, ok);
  else if (threadIdx.x < 2 * N)
    cp_async4(b + i, gb + src, ok);
}

// ---- row statistics within a quad (the 4 lanes that share a row) ----------

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Scores of the warp's rows (row, row + 8) against keys c0 + 8j (+1): S * sm,
// or -inf above the diagonal (kMask); the rows' maxima into mx.
template <bool kMask, int NT>
__device__ __forceinline__ void scale_scores(float (&s)[NT][4], float (&mx)[2], int c0,
                                             int row, float sm) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + 8 * j + (i & 1), r = row + 8 * (i >> 1);
      s[j][i] = (!kMask || c <= r) ? s[j][i] * sm : -INFINITY;
      mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
    }
}

// The dQ role: P = exp(S * sm - lse) (0 above the diagonal, kMask) into ds,
// then dS = P o (dP - D); ds holds dP on entry.
template <bool kMask, int NT>
__device__ __forceinline__ void probs(const float (&s)[NT][4], float (&ds)[NT][4], int c0,
                                      int row, const float (&lr)[2], const float (&dr)[2],
                                      float sm) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + 8 * j + (i & 1), h = i >> 1;
      const float pv = (!kMask || c <= row + 8 * h) ? expf(s[j][i] * sm - lr[h]) : 0.f;
      ds[j][i] = pv * (ds[j][i] - dr[h]);
    }
}

// The dK/dV role: P^T into p (S^T on entry; 0 where the query c0 + 8j (+1)
// precedes the key or lies past t, kMask) and dS^T = P^T o (dP^T - D) into
// ds (dP^T on entry); lse and D of the tile's queries from shared memory.
template <bool kMask, int NT>
__device__ __forceinline__ void probs_t(float (&p)[NT][4], float (&ds)[NT][4],
                                        const float* lse_s, const float* d_s, int tq,
                                        int c0, int key, int t, float sm) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int ql = 8 * j + 2 * tq;
    const float2 lq = *reinterpret_cast<const float2*>(lse_s + ql);
    const float2 dq = *reinterpret_cast<const float2*>(d_s + ql);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + ql + (i & 1), kk = key + 8 * (i >> 1);
      const float pv = (!kMask || (c >= kk && c < t))
                           ? expf(p[j][i] * sm - ((i & 1) ? lq.y : lq.x))
                           : 0.f;
      p[j][i] = pv;
      ds[j][i] = pv * (ds[j][i] - ((i & 1) ? dq.y : dq.x));
    }
  }
}

template <int HD, int BN>
constexpr int fwd_smem() {
  return (kRows + 4 * BN) * (HD + 4) * (int)sizeof(float);
}

template <int HD, int BN>
constexpr int bwd_smem() {
  return ((2 * kRows + 4 * BN) * (HD + 4) + 4 * BN) * (int)sizeof(float);
}

// ---- forward ---------------------------------------------------------------

template <int HD, int BN>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int t, float sm) {
  constexpr int kLd = HD + 4, kNT = BN / 8, kDT = HD / 8, kStage = 2 * BN * kLd;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                // kRows x kLd
  float* kv = qs + kRows * kLd;    // 2 stages of (K, V), each BN x kLd
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, g = lane / 4, tq = lane % 4;
  const int n_tiles = (t + kRows - 1) / kRows;
  const int q0 = (n_tiles - 1 - (int)blockIdx.x) * kRows;  // the longest rows first
  const size_t base = (size_t)blockIdx.y * t * HD;
  const int n_kt = min(q0 + kRows - 1, t - 1) / BN + 1;  // key tiles 0 .. the diagonal
  const int r0 = 16 * w, row = q0 + r0 + g;              // the lane's rows: row, row + 8

  load_tile<HD, kRows>(qs, q + base, q0, t);
  load_tile<HD, BN>(kv, k + base, 0, t);
  load_tile<HD, BN>(kv + BN * kLd, v + base, 0, t);
  cp_async_commit();

  float o[kDT][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < kDT; ++e) o[e][0] = o[e][1] = o[e][2] = o[e][3] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const float* ks = kv + (kt & 1) * kStage;
    const float* vs = ks + BN * kLd;
    if (kt + 1 < n_kt) {  // the next tile's copies overlap this tile's products
      float* nk = kv + ((kt + 1) & 1) * kStage;
      load_tile<HD, BN>(nk, k + base, (kt + 1) * BN, t);
      load_tile<HD, BN>(nk + BN * kLd, v + base, (kt + 1) * BN, t);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = kt * BN;
    if (k0 <= q0 + r0 + 15) {  // some key of the tile is visible to the warp's rows
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      mma_abt<HD, kNT>(s, qs, r0, ks, g, tq);
      float mx[2] = {-INFINITY, -INFINITY};
      if (k0 + BN - 1 > q0 + r0)  // a key of the tile lies above a row of the warp's
        scale_scores<true>(s, mx, k0 + 2 * tq, row, sm);
      else
        scale_scores<false>(s, mx, k0 + 2 * tq, row, sm);
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // finite: key 0 (tile 0, the first walked) is visible to every row
        const float m_new = fmaxf(m[h], quad_max(mx[h]));
        alpha[h] = expf(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[j][i] = expf(s[j][i] - m[i >> 1]);
          rs[i >> 1] += s[j][i];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(rs[h]);
#pragma unroll
      for (int e = 0; e < kDT; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[e][i] *= alpha[i >> 1];
      mma_pm<HD, kNT>(o, s, vs, g, tq);
    }
    __syncthreads();  // this stage is read; the next iteration refills it
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= t) continue;
    float* dst = out + base + (size_t)r * HD + 2 * tq;
#pragma unroll
    for (int e = 0; e < kDT; ++e)
      *reinterpret_cast<float2*>(dst + 8 * e) =
          make_float2(o[e][2 * h] / l[h], o[e][2 * h + 1] / l[h]);
    if (tq == 0) lse[(size_t)blockIdx.y * t + r] = m[h] + logf(l[h]);
  }
}

// ---- backward --------------------------------------------------------------

// The dK/dV role: keys [k0, k0 + 64); query tiles of BN from the diagonal down.
template <int HD, int BN>
__device__ __forceinline__ void bwd_dkv(const float* q, const float* k, const float* v,
                                        const float* dout, const float* lse,
                                        const float* dvec, float* dk, float* dv, int t,
                                        float sm, int k0, float* smem) {
  constexpr int kLd = HD + 4, kNT = BN / 8, kDT = HD / 8, kStage = 2 * BN * kLd;
  float* ks = smem;                 // kRows x kLd
  float* vs = ks + kRows * kLd;
  float* qd = vs + kRows * kLd;     // 2 stages of (Q, dO), each BN x kLd
  float* rv = qd + 2 * kStage;      // 2 stages of (lse, D), each BN
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, g = lane / 4, tq = lane % 4;
  const size_t base = (size_t)blockIdx.y * t * HD, rbase = (size_t)blockIdx.y * t;
  const int r0 = 16 * w, key = k0 + r0 + g;  // the lane's keys: key, key + 8
  const int qb0 = k0 / BN, n_qb = (t + BN - 1) / BN;

  load_tile<HD, kRows>(ks, k + base, k0, t);
  load_tile<HD, kRows>(vs, v + base, k0, t);
  load_tile<HD, BN>(qd, q + base, qb0 * BN, t);
  load_tile<HD, BN>(qd + BN * kLd, dout + base, qb0 * BN, t);
  load_rows<BN>(rv, rv + BN, lse + rbase, dvec + rbase, qb0 * BN, t);
  cp_async_commit();

  float adk[kDT][4], adv[kDT][4];
#pragma unroll
  for (int e = 0; e < kDT; ++e)
#pragma unroll
    for (int i = 0; i < 4; ++i) adk[e][i] = adv[e][i] = 0.f;
  for (int qb = qb0; qb < n_qb; ++qb) {
    const int st = (qb - qb0) & 1;
    const float* qs = qd + st * kStage;
    const float* dos = qs + BN * kLd;
    const float* lse_s = rv + st * 2 * BN;
    const float* d_s = lse_s + BN;
    if (qb + 1 < n_qb) {
      float* nq = qd + (st ^ 1) * kStage;
      float* nr = rv + (st ^ 1) * 2 * BN;
      load_tile<HD, BN>(nq, q + base, (qb + 1) * BN, t);
      load_tile<HD, BN>(nq + BN * kLd, dout + base, (qb + 1) * BN, t);
      load_rows<BN>(nr, nr + BN, lse + rbase, dvec + rbase, (qb + 1) * BN, t);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int qs0 = qb * BN;
    if (qs0 + BN - 1 >= k0 + r0) {  // some query of the tile sees the warp's keys
      float p[kNT][4], ds[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) p[j][i] = ds[j][i] = 0.f;
      mma_abt<HD, kNT>(p, ks, r0, qs, g, tq);    // S^T: keys x queries
      mma_abt<HD, kNT>(ds, vs, r0, dos, g, tq);  // dP^T = V dO^T
      // a query of the tile precedes a key of the warp's, or lies past t
      if (qs0 < k0 + r0 + 15 || qs0 + BN > t)
        probs_t<true>(p, ds, lse_s, d_s, tq, qs0, key, t, sm);
      else
        probs_t<false>(p, ds, lse_s, d_s, tq, qs0, key, t, sm);
      mma_pm<HD, kNT>(adv, p, dos, g, tq);   // dV += P^T dO
      mma_pm<HD, kNT>(adk, ds, qs, g, tq);   // dK += dS^T Q
    }
    __syncthreads();  // this stage is read; the next iteration refills it
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = key + 8 * h;
    if (c >= t) continue;
    const size_t off = base + (size_t)c * HD + 2 * tq;
#pragma unroll
    for (int e = 0; e < kDT; ++e) {
      *reinterpret_cast<float2*>(dk + off + 8 * e) =
          make_float2(adk[e][2 * h] * sm, adk[e][2 * h + 1] * sm);
      *reinterpret_cast<float2*>(dv + off + 8 * e) =
          make_float2(adv[e][2 * h], adv[e][2 * h + 1]);
    }
  }
}

// The dQ role: queries [q0, q0 + 64); key tiles of BN from key 0 to the diagonal.
template <int HD, int BN>
__device__ __forceinline__ void bwd_dq(const float* q, const float* k, const float* v,
                                       const float* dout, const float* lse,
                                       const float* dvec, float* dq, int t, float sm,
                                       int q0, float* smem) {
  constexpr int kLd = HD + 4, kNT = BN / 8, kDT = HD / 8, kStage = 2 * BN * kLd;
  float* qs = smem;                 // kRows x kLd
  float* dos = qs + kRows * kLd;
  float* kv = dos + kRows * kLd;    // 2 stages of (K, V), each BN x kLd
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, g = lane / 4, tq = lane % 4;
  const size_t base = (size_t)blockIdx.y * t * HD, rbase = (size_t)blockIdx.y * t;
  const int r0 = 16 * w, row = q0 + r0 + g;  // the lane's rows: row, row + 8
  const int n_kb = min(q0 + kRows - 1, t - 1) / BN + 1;

  load_tile<HD, kRows>(qs, q + base, q0, t);
  load_tile<HD, kRows>(dos, dout + base, q0, t);
  load_tile<HD, BN>(kv, k + base, 0, t);
  load_tile<HD, BN>(kv + BN * kLd, v + base, 0, t);
  cp_async_commit();
  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = row + 8 * h < t;
    lr[h] = ok ? lse[rbase + row + 8 * h] : 0.f;
    dr[h] = ok ? dvec[rbase + row + 8 * h] : 0.f;
  }

  float adq[kDT][4];
#pragma unroll
  for (int e = 0; e < kDT; ++e) adq[e][0] = adq[e][1] = adq[e][2] = adq[e][3] = 0.f;
  for (int kb = 0; kb < n_kb; ++kb) {
    const float* ks = kv + (kb & 1) * kStage;
    const float* vs = ks + BN * kLd;
    if (kb + 1 < n_kb) {
      float* nk = kv + ((kb + 1) & 1) * kStage;
      load_tile<HD, BN>(nk, k + base, (kb + 1) * BN, t);
      load_tile<HD, BN>(nk + BN * kLd, v + base, (kb + 1) * BN, t);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = kb * BN;
    if (k0 <= q0 + r0 + 15) {  // some key of the tile is visible to the warp's rows
      float s[kNT][4], ds[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = ds[j][i] = 0.f;
      mma_abt<HD, kNT>(s, qs, r0, ks, g, tq);    // S
      mma_abt<HD, kNT>(ds, dos, r0, vs, g, tq);  // dP = dO V^T
      if (k0 + BN - 1 > q0 + r0)  // a key of the tile lies above a row of the warp's
        probs<true>(s, ds, k0 + 2 * tq, row, lr, dr, sm);
      else
        probs<false>(s, ds, k0 + 2 * tq, row, lr, dr, sm);
      mma_pm<HD, kNT>(adq, ds, ks, g, tq);  // dQ += dS K
    }
    __syncthreads();  // this stage is read; the next iteration refills it
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= t) continue;
    float* dst = dq + base + (size_t)r * HD + 2 * tq;
#pragma unroll
    for (int e = 0; e < kDT; ++e)
      *reinterpret_cast<float2*>(dst + 8 * e) =
          make_float2(adq[e][2 * h] * sm, adq[e][2 * h + 1] * sm);
  }
}

template <int HD, int BN>
__global__ void __launch_bounds__(kThreads, Tiles<HD>::kBwdBlocks)
    flash_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dvec,
                     float* __restrict__ dq, float* __restrict__ dk,
                     float* __restrict__ dv, int t, float sm) {
  extern __shared__ __align__(16) float smem[];
  const int n_tiles = (t + kRows - 1) / kRows;
  const int x = blockIdx.x;
  if (x < n_tiles)  // key tile 0 walks the most query tiles: first
    bwd_dkv<HD, BN>(q, k, v, dout, lse, dvec, dk, dv, t, sm, x * kRows, smem);
  else  // the longest rows first
    bwd_dq<HD, BN>(q, k, v, dout, lse, dvec, dq, t, sm, (2 * n_tiles - 1 - x) * kRows,
                   smem);
}

// The dynamic shared memory above 48 KB is opted into once per instance, at
// its first launch (outside any graph capture: the train step's warm-up).
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

template <int HD>
int launch_fwd(const float* q, const float* k, const float* v, float* out, float* lse,
               int BH, int t, float sm, cudaStream_t stream) {
  constexpr int BN = Tiles<HD>::kFwd;
  static bool done = false;
  const int bytes = fwd_smem<HD, BN>();
  cudaError_t err = opt_in(flash_fwd_kernel<HD, BN>, bytes, done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + kRows - 1) / kRows, BH);
  flash_fwd_kernel<HD, BN><<<grid, kThreads, bytes, stream>>>(q, k, v, out, lse, t, sm);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd(const float* q, const float* k, const float* v, const float* dout,
               const float* lse, const float* dvec, float* dq, float* dk, float* dv,
               int BH, int t, float sm, cudaStream_t stream) {
  constexpr int BN = Tiles<HD>::kBwd;
  static bool done = false;
  const int bytes = bwd_smem<HD, BN>();
  cudaError_t err = opt_in(flash_bwd_kernel<HD, BN>, bytes, done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(2 * ((t + kRows - 1) / kRows), BH);
  flash_bwd_kernel<HD, BN><<<grid, kThreads, bytes, stream>>>(q, k, v, dout, lse, dvec,
                                                              dq, dk, dv, t, sm);
  return (int)cudaGetLastError();
}

#define JLT_FLASH_HD(HD_, CALL) \
  switch (HD_) {                \
    case 32: return CALL(32);   \
    case 64: return CALL(64);   \
    case 128: return CALL(128); \
    default: return (int)cudaErrorInvalidValue; \
  }

}  // namespace

extern "C" {

// q, k, v, out: f32 (BH, t, hd) contiguous; lse: f32 (BH, t); hd 32, 64 or
// 128.  Returns cudaGetLastError().
int jlt_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                  int BH, int t, int hd, float sm, void* stream) {
#define CALL(H)                                                                    \
  launch_fwd<H>((const float*)q, (const float*)k, (const float*)v, (float*)out,    \
                (float*)lse, BH, t, sm, (cudaStream_t)stream)
  JLT_FLASH_HD(hd, CALL)
#undef CALL
}

// dout: dO (BH, t, hd); lse and dvec (D = rowsum(dO o O)): (BH, t).  Writes
// dq, dk, dv (BH, t, hd) in one launch.  Returns cudaGetLastError().
int jlt_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* dvec, void* dq, void* dk, void* dv, int BH,
                  int t, int hd, float sm, void* stream) {
#define CALL(H)                                                                    \
  launch_bwd<H>((const float*)q, (const float*)k, (const float*)v,                 \
                (const float*)dout, (const float*)lse, (const float*)dvec,         \
                (float*)dq, (float*)dk, (float*)dv, BH, t, sm, (cudaStream_t)stream)
  JLT_FLASH_HD(hd, CALL)
#undef CALL
}

}  // extern "C"
