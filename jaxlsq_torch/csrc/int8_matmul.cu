// The int8 x int8 serving path: activation quantization to int8 (I1,
// act_quant_i8) and a batched int8 x int8 -> int32 product on the tensor
// cores with the dequant epilogue fused (I2, i8mm), which can also quantize
// its A rows itself (I1 fused into I2's A loads).
//
// They replace no TPU kernel.  jaxlsq leaves this path to XLA
// (jaxlsq/serve/matmul.py static_int8_matmul :415, static_int8_conv :471,
// dynamic_int8_matmul :582, jaxlsq/models/moe.py _ExpertDense._serve_int8
// :204): jax.lax.dot / conv_general_dilated with preferred_element_type
// int32, which the MXU runs natively.  PyTorch has no public int8 product on
// CUDA (torch.matmul refuses int8; torch._int_mm is private and refuses
// M <= 16), so the product is written here for Hopper's int8 tensor cores.
//
// ---- act_quant_i8 (I1) ----
//
// x f32 (n elements) -> xq int8 (n), and qx f32 [sx, zpx_c]:
//   static:  xq = clip(rint(x / sx + zpx), qmin, qmax) - shift, sx = scale[0],
//            zpx = (float)zp[0], zpx_c = zpx - shift (shift 128 for an
//            unsigned range, else 0);
//   dynamic: sx = max(max|x| / 127, FLT_MIN), xq = rint(x / sx), zpx_c = 0.
// The float to int8 conversion is jax's: saturating, NaN -> 0 (quant_one).
// The dynamic absmax is a max over |x|'s bit patterns (a NaN's exceed
// +inf's, so a NaN passes as in jnp.max) in two launches: per-block partial
// maxima into a workspace, then the quantizing pass, whose every block folds
// the partials itself.  sx never leaves the card, so a CUDA graph captures
// it.  Divisions are __fdiv_rn (a multiply by a reciprocal differs in the
// last bit), rintf rounds half to even as jnp.round.  Bound: the bytes (4
// read, 1 written an element; the dynamic mode reads x twice); at decode M a
// call is 1-16 KB and the launch is the whole cost, which is why the matmul
// callers fuse it into i8mm below.  A thread takes 4 elements a trip (one
// 16-byte load, one 4-byte store) where x is 16-byte aligned; the grid is
// one block a 1024 elements (one trip of its 256 threads), at most 1024
// blocks (the partials' workspace).
//
// ---- i8mm (I2) ----
//
// For each batch b (1 for a matmul, E experts, G conv groups):
//   acc[m, n] = sum_k A[b, m, k] * B[b, k, n]          (int32, exact)
// A int8 row-major (lda), B int8 (K, N) row-major (ldb): jaxlsq's pack, never
// re-laid out.  Each batch at its own stride.  Exact in any order while
// K * 128 * 128 < 2^31 (the wrapper holds K <= 131072), so the tile, the
// K split and the pipeline below all give the plain version's bits.
//
// What bounds it on an H100: at decode M the weight bytes (K N a batch, at
// 3.35 TB/s: 0.3-2.5 us a d1024 layer, where launch and memory latency are
// most of a call); at prefill M the int8 tensor cores, 2 M N K at 1,979
// TOPS.  The first form of this kernel (one 64 x 64 tile a block streaming
// its whole K alone, one 64-byte k-slice in flight) reached 3.5% of the
// bound at decode: 16 blocks at N = 1024 on 132 SMs.  This form:
//
//  * A block owns a BM x BN output tile (BM = 16 WM rows, BN 128 or 64
//    columns) and one k range; the plan (serve/matmul.py i8mm_plan, pure
//    Python) gives BM, BN and the K split.  WM warps along M x WK along K
//    (BM 16: 1 x 4, 32: 2 x 4, 64: 4 x 2, 128: 8 x 1): each warp a 16 x BN
//    strip of BN / 8 mma.sync m16n8k32 s8 tiles over its share of each
//    stage's four 32-k steps.  BN = 64 at decode M, and at prefill where
//    128-column tiles fall short of the plan's target (card runs).
//  * K is split over a thread-block cluster of cs <= 8 blocks (rank r owns
//    k in [r kper, (r + 1) kper)), so that the column tiles times cs fill a
//    wave of SMs (0.7 of one at prefill, where the fold costs more than idle
//    SMs): at decode M = 1 the five d1024 shapes get 128-192 blocks where the
//    first form had 16-128.  The int32 partials, the B column sums
//    and the A row sums fold through distributed shared memory (each rank
//    folds a cs-th of the tile's elements, reading every rank's partials);
//    no workspace, no second launch.
//  * The weight streams through a ring of up to 8 stages of 128 k x BN n
//    bytes (16 KB at BN = 128; at most 192 KB with the resident A below),
//    by cp.async 16 bytes a thread: all of a block's stages in flight where
//    they fit (a decode block's whole k range), else all but one.  (TMA
//    copies into the same ring, with an mbarrier a slot, measured no faster
//    on the H100 at decode and slower at M = 256, so the ring stays
//    cp.async.)  The stage lands as the (K, N) rows it is,
//    chunks of 16 bytes XOR-swizzled by (k / 4) % (BN / 16); the .col
//    operand (4 consecutive k of one n a register) is made between shared
//    memory and the tensor cores: thread g of a warp reads piece p(g) (16
//    bytes at BN = 128, conflict-free under the swizzle: the 8 threads of a
//    quarter warp read 8 distinct chunk positions; 8 bytes at BN = 64, where
//    a half warp's 16 reads fall on 16 banks, two ways) of each of its 4 k
//    rows and transposes each 4 x 4 byte block with 6 __byte_perm.  Thread g
//    then holds column g of every n8 tile T, so tile T's column j is output
//    column (BN / 8) p(j) + T; the epilogue maps it back (a thread a column,
//    its qparams and column sum loaded once).  cp.async cannot transform
//    bytes on the way, so the transpose happens on the read side, and the
//    ring stays asynchronous.
//  * A: in the ring beside B (BM x 128 bytes a stage), or, fused, resident:
//    the block reads its rows of f32 x once for its k range, quantizes them
//    in registers with I1's formula (quant_one) and keeps them in shared
//    memory; sx and zpx come from the activation's scale / zero point
//    (static) or from the absmax partials of the one launch before
//    (dynamic), as act_quant folds them; the first block writes qx.  The
//    weight's first stages are issued before, so the quantization overlaps
//    their flight.  So a static int8 matmul at decode M is one launch, a
//    dynamic one two; each column block quantizes its rows again, which is
//    why the callers fuse only up to FUSED_MAX_M rows (card runs).  A
//    fragments by ldmatrix.x4 from rows swizzled by m % 8.
//  * The block sums its A rows (__dp4a over the A stages) and B columns
//    (__dp4a over the transposed B registers) over its k range: rowsum(x_q)
//    and colsum(w_q), per call, as jaxlsq computes them.
//  * Ragged M, N and K are zero-filled (exact).  Where B (or A) is not
//    16-byte aligned (odd N or K) a stage's chunks are loaded byte by byte
//    through registers instead (same ring, no overlap).
//  * A convolution's products take the conv form (tile64, below) instead.
//
// The epilogue is each caller's formula in jaxlsq's order of f32 operations,
// every one an explicit _rn intrinsic (nvcc contracts no FMA), with
// sx, zpx_c from I1's qx (or the fused quantization) and sw[n], zw[n] from
// the weight's qparams at b * q_bstride + n * q_nstride (per tensor, per
// column, per expert, or per output channel of a conv group):
//   kStatic (static_int8_matmul :463-467, _serve_int8 :231-237):
//     ((acc - zpx * cs) - zw * rs) + (K * zpx) * zw, then * (sx * sw)
//   kDynamic (dynamic_int8_matmul :606-608): (acc - rs * zw) * (sx * sw)
//   kConv (static_int8_conv :560-578): acc - zpx * cs, then, where zw != 0,
//     - zw * (rs - zpx * window), then * (sx * sw)
// (kConv's per-column test equals jaxlsq's affine expansion, whose zw = 0
// columns subtract a zero, and its symmetric fast path; a zero's sign may
// differ.)  So with the same xq the output is the plain version's bit for
// bit.  The output element (b, m, n) lands at b * o_bstride + (m / o_hw) *
// o_mhi + (m % o_hw) * o_mlo + n * o_n: (M, N) rows for a matmul, NCHW for a
// conv.

#include <cooperative_groups.h>

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kQuantThreads = 256;
constexpr int kQuantPerBlock = 1024;  // elements a block of act_quant / absmax
constexpr int kMaxPartials = 1024;

constexpr int kBK = 128;          // k rows a ring stage
constexpr int kMaxSlots = 8;      // ring stages at most
constexpr int kRingBytes = 192 * 1024;  // a block's ring and resident A at most
constexpr int kMaxCluster = 8;    // portable cluster size
constexpr int kMaxK = 131072;
constexpr int kMaxDevices = 64;

enum { kStatic = 0, kDynamic = 1, kConv = 2 };

__device__ __forceinline__ unsigned warp_max(unsigned v) {
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// max over the T threads of a block (red: T / 32 words of shared memory)
template <int T>
__device__ unsigned block_max(unsigned v, unsigned* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = threadIdx.x < T / 32 ? red[threadIdx.x] : 0u;
  if (threadIdx.x < 32) v = warp_max(v);
  return v;  // valid in warp 0
}

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// The activation's quantization: static scale / zero point, or the dynamic
// mode's absmax partials (parts of them).
struct QuantArgs {
  const float* scale;
  const int* zp;
  const unsigned* part;
  int parts, dynamic;
  float qmin, qmax, shift;
};

// s[0] = sx, s[1] = zpx (the quantization's), s[2] = zpx_c (the epilogue's)
// for every thread of the block (one __syncthreads); the first block also
// writes qx = [sx, zpx_c].
template <int T>
__device__ void act_qparams(const QuantArgs& q, float* s, unsigned* red, bool first,
                            float* qx) {
  if (q.dynamic) {
    unsigned m = 0;
    for (int i = threadIdx.x; i < q.parts; i += T) m = max(m, q.part[i]);
    m = block_max<T>(m, red);
    if (threadIdx.x == 0) {
      const float sx = __fdiv_rn(__uint_as_float(m), 127.0f);
      s[0] = isnan(sx) ? sx : fmaxf(sx, FLT_MIN);
      s[1] = 0.0f;
      s[2] = 0.0f;
    }
  } else if (threadIdx.x == 0) {
    s[0] = q.scale[0];
    s[1] = __int2float_rn(q.zp[0]);
    s[2] = __fsub_rn(s[1], q.shift);
  }
  __syncthreads();
  if (first && threadIdx.x == 0) {
    qx[0] = s[0];
    qx[1] = s[2];
  }
}

// one element's int8 level (jax's float -> int8 conversion: NaN -> 0)
__device__ __forceinline__ int quant_one(float x, float sx, float zpx, const QuantArgs& q) {
  float v = __fdiv_rn(x, sx);
  if (!q.dynamic) v = __fadd_rn(v, zpx);
  float r = rintf(v);
  if (isnan(r)) return 0;
  if (!q.dynamic) r = __fsub_rn(fminf(fmaxf(r, q.qmin), q.qmax), q.shift);
  return (int)fminf(fmaxf(r, -128.0f), 127.0f);
}

__device__ __forceinline__ unsigned quant4(float4 v, float sx, float zpx, const QuantArgs& q) {
  return (unsigned)(quant_one(v.x, sx, zpx, q) & 0xff) |
         ((unsigned)(quant_one(v.y, sx, zpx, q) & 0xff) << 8) |
         ((unsigned)(quant_one(v.z, sx, zpx, q) & 0xff) << 16) |
         ((unsigned)(quant_one(v.w, sx, zpx, q) & 0xff) << 24);
}

__global__ void __launch_bounds__(kQuantThreads)
absmax_partials(const float* __restrict__ x, long long n, int vec, unsigned* __restrict__ part) {
  __shared__ unsigned red[kQuantThreads / 32];
  unsigned m = 0;
  const long long stride = (long long)gridDim.x * kQuantThreads;
  const long long t0 = (long long)blockIdx.x * kQuantThreads + threadIdx.x;
  long long tail = 0;
  if (vec) {
    const long long n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (long long i = t0; i < n4; i += stride) {
      const float4 v = x4[i];
      m = max(m, max(max(abs_bits(v.x), abs_bits(v.y)), max(abs_bits(v.z), abs_bits(v.w))));
    }
    tail = n4 << 2;
  }
  for (long long i = tail + t0; i < n; i += stride) m = max(m, abs_bits(x[i]));
  m = block_max<kQuantThreads>(m, red);
  if (threadIdx.x == 0) part[blockIdx.x] = m;
}

// vec: x 16-byte aligned (xq, a fresh tensor, is)
__global__ void __launch_bounds__(kQuantThreads)
act_quant(const float* __restrict__ x, long long n, int vec, int8_t* __restrict__ xq,
          float* __restrict__ qx, QuantArgs q) {
  __shared__ unsigned red[kQuantThreads / 32];
  __shared__ float s[3];
  act_qparams<kQuantThreads>(q, s, red, blockIdx.x == 0, qx);
  const float sx = s[0], zpx = s[1];
  const long long stride = (long long)gridDim.x * kQuantThreads;
  const long long t0 = (long long)blockIdx.x * kQuantThreads + threadIdx.x;
  long long tail = 0;
  if (vec) {
    const long long n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    unsigned* q4 = reinterpret_cast<unsigned*>(xq);
    for (long long i = t0; i < n4; i += stride) q4[i] = quant4(x4[i], sx, zpx, q);
    tail = n4 << 2;
  }
  for (long long i = tail + t0; i < n; i += stride) xq[i] = (int8_t)quant_one(x[i], sx, zpx, q);
}

int quant_blocks(long long n) {
  const long long b = (n + kQuantPerBlock - 1) / kQuantPerBlock;
  return (int)(b < 1 ? 1 : (b > kMaxPartials ? kMaxPartials : b));
}

struct MmArgs {
  const int8_t* a;  // int8 A; fused: nullptr
  const float* x;   // fused: f32 x, A before quantization (lda, a_bstride in floats)
  const int8_t* b;
  float* out;
  long long a_bstride, b_bstride, o_bstride, o_hw, o_mhi, o_mlo, o_n;
  int lda, ldb, M, N, K;
  const float* qx;  // [sx, zpx_c]: read, or (fused) written by the first block
  const float* sw;
  const int* zw;
  int q_bstride, q_nstride, mode, vec_a, vec_b;
  float window;
  int cs, kper, fused, slots;
  QuantArgs q;
};

// a 16-byte asynchronous copy of `bytes` (0..16) bytes, the rest zeros
__device__ __forceinline__ void copy16(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// the same for a run-time n in 0..kMaxSlots - 1
__device__ __forceinline__ void copy_wait(int n) {
  switch (n) {
    case 0: copy_wait<0>(); break;
    case 1: copy_wait<1>(); break;
    case 2: copy_wait<2>(); break;
    case 3: copy_wait<3>(); break;
    case 4: copy_wait<4>(); break;
    case 5: copy_wait<5>(); break;
    case 6: copy_wait<6>(); break;
    default: copy_wait<7>(); break;
  }
}

// `bytes` (0..16) bytes from src, zeros after, as one 16-byte chunk
__device__ __forceinline__ int4 bytes16(const int8_t* src, int bytes) {
  unsigned w[4] = {0u, 0u, 0u, 0u};
  for (int j = 0; j < bytes; ++j) w[j >> 2] |= (unsigned)(uint8_t)src[j] << (8 * (j & 3));
  return make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
}

// The weight's stage j: rows kb + j kBK + [0, kBK) (zeros from ke on) of the
// block's BN columns, chunk c of row r at r * BN + (c ^ (r / 4) % (BN / 16)) * 16.
template <int T, int BN>
__device__ __forceinline__ void load_b(const MmArgs& p, const int8_t* B, int n0, int k0, int ke,
                                       int8_t* dst) {
  constexpr int CH = BN / 16;
#pragma unroll
  for (int i = 0; i < kBK * CH / T; ++i) {
    const int id = threadIdx.x + i * T;
    const int row = id / CH, c = id % CH;
    const int k = k0 + row, n = n0 + 16 * c;
    int8_t* d = dst + row * BN + ((c ^ ((row >> 2) & (CH - 1))) << 4);
    const int bytes = k < ke ? min(16, max(0, p.N - n)) : 0;
    const int8_t* src = bytes ? B + (long long)k * p.ldb + n : B;
    if (p.vec_b)
      copy16(d, src, bytes);
    else
      *reinterpret_cast<int4*>(d) = bytes16(src, bytes);
  }
}

// A's stage j (ring form): rows m0 + [0, BM) of k0 + [0, kBK), chunk c of
// row r at r * kBK + (c ^ r % 8) * 16.
template <int T, int BM>
__device__ __forceinline__ void load_a(const MmArgs& p, const int8_t* A, int m0, int k0, int ke,
                                       int8_t* dst) {
#pragma unroll
  for (int i = 0; i < BM * (kBK / 16) / T; ++i) {
    const int id = threadIdx.x + i * T;
    const int row = id >> 3, c = id & 7;
    const int m = m0 + row, k = k0 + 16 * c;
    int8_t* d = dst + row * kBK + ((c ^ (row & 7)) << 4);
    const int bytes = m < p.M ? min(16, max(0, ke - k)) : 0;
    const int8_t* src = bytes ? A + (long long)m * p.lda + k : A;
    if (p.vec_a)
      copy16(d, src, bytes);
    else
      *reinterpret_cast<int4*>(d) = bytes16(src, bytes);
  }
}

// Fused: the block's rows of x over [kb, ke), quantized, resident in shared
// memory (row stride kper, chunk c of row r at (c ^ r % 8) * 16).
template <int T, int BM>
__device__ void quantize_a(const MmArgs& p, const float* X, int m0, int kb, int ke, float sx,
                           float zpx, int8_t* dst) {
  const int chunks = p.kper / 16;
  for (int id = threadIdx.x; id < BM * chunks; id += T) {
    const int row = id / chunks, c = id % chunks;
    const int m = m0 + row, k = kb + 16 * c;
    const int valid = m < p.M ? min(16, max(0, ke - k)) : 0;
    unsigned w[4] = {0u, 0u, 0u, 0u};
    if (valid) {
      const float* src = X + (long long)m * p.lda + k;
      if (p.vec_a && valid == 16) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] = quant4(reinterpret_cast<const float4*>(src)[j], sx, zpx, p.q);
      } else {
        for (int j = 0; j < valid; ++j)
          w[j >> 2] |= (unsigned)(quant_one(src[j], sx, zpx, p.q) & 0xff) << (8 * (j & 3));
      }
    }
    *reinterpret_cast<int4*>(dst + row * p.kper + ((c ^ (row & 7)) << 4)) =
        make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows k..k+3 (r0..r3) of columns n..n+3 -> columns n..n+3 of rows k..k+3
__device__ __forceinline__ void transpose4(unsigned r0, unsigned r1, unsigned r2, unsigned r3,
                                           unsigned (&c)[4]) {
  const unsigned t0 = __byte_perm(r0, r1, 0x5140);
  const unsigned t1 = __byte_perm(r0, r1, 0x7362);
  const unsigned t2 = __byte_perm(r2, r3, 0x5140);
  const unsigned t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ float epilogue(const MmArgs& p, int acc, int rs, int cs,
                                          float sx, float zpx, float sw, float zw) {
  const float a = __int2float_rn(acc);
  const float sxw = __fmul_rn(sx, sw);
  float o;
  if (p.mode == kDynamic) {
    o = __fsub_rn(a, __fmul_rn(__int2float_rn(rs), zw));
  } else if (p.mode == kStatic) {
    o = __fsub_rn(a, __fmul_rn(zpx, __int2float_rn(cs)));
    o = __fsub_rn(o, __fmul_rn(zw, __int2float_rn(rs)));
    o = __fadd_rn(o, __fmul_rn(__fmul_rn(__int2float_rn(p.K), zpx), zw));
  } else {
    o = __fsub_rn(a, __fmul_rn(zpx, __int2float_rn(cs)));
    if (zw != 0.0f)
      o = __fsub_rn(o, __fmul_rn(zw, __fsub_rn(__int2float_rn(rs),
                                                __fmul_rn(zpx, p.window))));
  }
  return __fmul_rn(o, sxw);
}

// the piece of a B row that thread g of a warp reads: a 16-byte chunk of
// 128 columns, an 8-byte half chunk of 64
template <int BN>
__device__ __forceinline__ int b_piece(int g) {
  return BN == 128 ? (((g & 1) << 2) | (g >> 1)) : g;
}

// piece p of the stage's row k as BN / 32 words (columns in byte order)
template <int BN>
__device__ __forceinline__ void b_row(const int8_t* bs, int k, int p, unsigned (&w)[BN / 32]) {
  if constexpr (BN == 128) {
    const int4 v = *reinterpret_cast<const int4*>(bs + k * BN + ((p ^ ((k >> 2) & 7)) << 4));
    w[0] = (unsigned)v.x;
    w[1] = (unsigned)v.y;
    w[2] = (unsigned)v.z;
    w[3] = (unsigned)v.w;
  } else {
    const int2 v = *reinterpret_cast<const int2*>(
        bs + k * BN + ((((p >> 1) ^ ((k >> 2) & 3))) << 4) + ((p & 1) << 3));
    w[0] = (unsigned)v.x;
    w[1] = (unsigned)v.y;
  }
}

template <int WM, int WK, int BN>
__global__ void __launch_bounds__(32 * WM * WK, 1) i8mm_kernel(MmArgs p) {
  constexpr int T = 32 * WM * WK, BM = 16 * WM;
  constexpr int W = BN / 32;        // words a thread reads of each B row
  constexpr int NT = BN / 8;        // n8 tiles of a warp's strip
  constexpr int PROW = BN + 4;      // the partial tile's row stride (ints)
  constexpr int BSTAGE = kBK * BN;  // a stage's weight bytes
  extern __shared__ __align__(128) int8_t smem[];
  __shared__ int csum_s[BN], rsum_s[BM], csum_t[BN], rsum_t[BM];
  __shared__ long long row_off[BM];
  __shared__ float s_q[3];
  __shared__ unsigned red[T / 32];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp % WM, wk = warp / WM;
  const int cs = p.cs, rank = (int)(blockIdx.x % cs);
  const int n0 = (int)(blockIdx.x / cs) * BN, m0 = blockIdx.y * BM, bt = blockIdx.z;
  const int kb = rank * p.kper, ke = min(p.K, kb + p.kper);
  const int nst = ke > kb ? (ke - kb + kBK - 1) / kBK : 0;
  const int8_t* B = p.b + bt * p.b_bstride;
  // a ring of S slots, D stages in flight: all of the block's where they fit
  const int S = p.slots, D = nst <= S ? nst : S - 1;
  const int stage_bytes = BSTAGE + (p.fused ? 0 : BM * kBK);
  int8_t* resident = smem + S * stage_bytes;

  // the ring's first D stages in flight before anything waits
  for (int j = 0; j < D; ++j) {
    int8_t* slot = smem + j * stage_bytes;
    load_b<T, BN>(p, B, n0, kb + j * kBK, ke, slot);
    if (!p.fused) load_a<T, BM>(p, p.a + bt * p.a_bstride, m0, kb + j * kBK, ke, slot + BSTAGE);
    copy_commit();
  }
  for (int i = t; i < BN; i += T) csum_s[i] = 0;
  for (int i = t; i < BM; i += T) {
    rsum_s[i] = 0;
    const long long mg = m0 + i;
    row_off[i] = (mg / p.o_hw) * p.o_mhi + (mg % p.o_hw) * p.o_mlo;
  }
  if (p.fused) {  // then the resident A, quantized while the weight streams in
    act_qparams<T>(p.q, s_q, red, blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0,
                   const_cast<float*>(p.qx));
    quantize_a<T, BM>(p, p.x + bt * p.a_bstride, m0, kb, ke, s_q[0], s_q[1], resident);
  } else if (t == 0) {
    s_q[0] = p.qx[0];
    s_q[2] = p.qx[1];
  }

  int acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0;
  int csp[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) csp[i] = 0;
  int rpart = 0;  // thread t: row t % BM, chunks t / BM + (T / BM) i of each stage
  const int bp = b_piece<BN>(g);

  for (int j = 0; j < nst; ++j) {
    copy_wait(D - 1);  // D + j groups committed: stage j's is done
    __syncthreads();   // stage j has landed; every warp is done with stage j - 1
    {
      const int jn = j + D;  // into slot (j - 1) % S where D = S - 1
      if (jn < nst) {
        int8_t* slot = smem + (jn % S) * stage_bytes;
        load_b<T, BN>(p, B, n0, kb + jn * kBK, ke, slot);
        if (!p.fused)
          load_a<T, BM>(p, p.a + bt * p.a_bstride, m0, kb + jn * kBK, ke, slot + BSTAGE);
      }
      copy_commit();
    }
    const int8_t* bs = smem + (j % S) * stage_bytes;
    const int8_t* as = p.fused ? resident + j * kBK : bs + BSTAGE;
    const int ald = p.fused ? p.kper : kBK;
    {
      const int rr = t % BM;
      for (int cc = t / BM; cc < kBK / 16; cc += T / BM) {
        const int4 v = *reinterpret_cast<const int4*>(as + rr * ald + ((cc ^ (rr & 7)) << 4));
        rpart = __dp4a(v.x, 0x01010101, rpart);
        rpart = __dp4a(v.y, 0x01010101, rpart);
        rpart = __dp4a(v.z, 0x01010101, rpart);
        rpart = __dp4a(v.w, 0x01010101, rpart);
      }
    }
#pragma unroll
    for (int ss = 0; ss < kBK / 32 / WK; ++ss) {
      const int s = wk + ss * WK;
      unsigned af[4];
      {
        const int r = wm * 16 + (lane & 15), c = 2 * s + (lane >> 4);
        ldmatrix_x4(af, as + r * ald + ((c ^ (r & 7)) << 4));
      }
      unsigned h0[4][W], h1[4][W];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k0 = s * 32 + 4 * tig + r;
        b_row<BN>(bs, k0, bp, h0[r]);
        b_row<BN>(bs, k0 + 16, bp, h1[r]);
      }
#pragma unroll
      for (int q = 0; q < W; ++q) {
        unsigned b0[4], b1[4];
        transpose4(h0[0][q], h0[1][q], h0[2][q], h0[3][q], b0);
        transpose4(h1[0][q], h1[1][q], h1[2][q], h1[3][q], b1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_s8(acc[4 * q + i], af, b0[i], b1[i]);
          if (wm == 0) {
            csp[4 * q + i] = __dp4a((int)b0[i], 0x01010101, csp[4 * q + i]);
            csp[4 * q + i] = __dp4a((int)b1[i], 0x01010101, csp[4 * q + i]);
          }
        }
      }
    }
  }
  copy_wait<0>();
  __syncthreads();  // the ring and the resident A are free

  // the block's partial tile P (BM x PROW ints, natural order), its column
  // and row sums: warps along K add into the first's
  int* P = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int pass = 0; pass < (WK > 1 ? 2 : 1); ++pass) {
    if ((pass == 0) == (wk == 0)) {
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = wm * 16 + g + (e >> 1) * 8, j = 2 * tig + (e & 1);
          int* d = P + m * PROW + NT * b_piece<BN>(j) + i;
          if (pass == 0)
            *d = acc[i][e];
          else
            atomicAdd(d, acc[i][e]);
        }
    }
    if (WK > 1 && pass == 0) __syncthreads();
  }
  if (wm == 0) {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      int v = csp[i];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (tig == 0) atomicAdd(&csum_s[NT * bp + i], v);
    }
  }
  atomicAdd(&rsum_s[t % BM], rpart);

  // the cluster's fold: every rank's partials, sums and tile have landed
  cg::cluster_group cluster = cg::this_cluster();
  if (cs > 1)
    cluster.sync();
  else
    __syncthreads();
  for (int i = t; i < BN + BM; i += T) {
    const int* src = i < BN ? csum_s + i : rsum_s + (i - BN);
    int v = 0;
    if (cs > 1) {
      for (int r = 0; r < cs; ++r) v += *cluster.map_shared_rank(src, r);
    } else {
      v = *src;
    }
    if (i < BN)
      csum_t[i] = v;
    else
      rsum_t[i - BN] = v;
  }
  __syncthreads();
  // thread t: column t % BN, rows r = (t / BN) cs + rank + (T / BN) cs i of
  // the tile (each element folded and written once over the cluster)
  {
    constexpr int TPC = T / BN;
    const int nl = t % BN, n = n0 + nl;
    const int rows = min(BM, p.M - m0);
    if (n < p.N) {
      const float sx = s_q[0], zpx = s_q[2];
      const long long qi = (long long)bt * p.q_bstride + (long long)n * p.q_nstride;
      const float sw = p.sw[qi], zw = __int2float_rn(p.zw[qi]);
      const int csn = csum_t[nl];
      float* out = p.out + bt * p.o_bstride + (long long)n * p.o_n;
      for (int m = (t / BN) * cs + rank; m < rows; m += TPC * cs) {
        const int* src = P + m * PROW + nl;
        int v = 0;
        if (cs > 1) {
          for (int r = 0; r < cs; ++r) v += *cluster.map_shared_rank(src, r);
        } else {
          v = *src;
        }
        out[row_off[m]] = epilogue(p, v, rsum_t[m], csn, sx, zpx, sw, zw);
      }
    }
  }
  if (cs > 1) cluster.sync();  // no rank leaves while another reads its shared memory
}

// the ring's slots of a launch (BM x BN tiles): a rank's stages, at most
// kMaxSlots and kRingBytes with the resident A, at least 2
int mm_slots(int BM, int BN, int kper, int fused) {
  const size_t stage = (size_t)kBK * BN + (fused ? 0 : (size_t)BM * kBK);
  const size_t res = fused ? (size_t)BM * kper : 0;
  int s = kper / kBK < kMaxSlots ? kper / kBK : kMaxSlots;
  while (s > 2 && s * stage + res > (size_t)kRingBytes) --s;
  return s;
}

// the dynamic shared memory of a launch
size_t mm_smem(int BM, int BN, int kper, int fused) {
  const size_t bytes = (size_t)mm_slots(BM, BN, kper, fused) *
                           ((size_t)kBK * BN + (fused ? 0 : (size_t)BM * kBK)) +
                       (fused ? (size_t)BM * kper : 0);
  const size_t tile = (size_t)BM * (BN + 4) * sizeof(int);
  return bytes > tile ? bytes : tile;
}

template <int WM, int WK, int BN>
cudaError_t launch_mm(const MmArgs& p, int batch, cudaStream_t stream) {
  constexpr int T = 32 * WM * WK, BM = 16 * WM;
  auto kernel = i8mm_kernel<WM, WK, BN>;
  // this instance's dynamic shared memory limit, raised by device (the
  // default 48 KB holds the static shared memory too)
  static size_t smem_set[kMaxDevices] = {};
  const size_t smem = mm_smem(BM, BN, p.kper, p.fused);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((p.N + BN - 1) / BN) * p.cs), (unsigned)((p.M + BM - 1) / BM),
                     (unsigned)batch);
  cfg.blockDim = dim3(T, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1] = {};
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cs > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

// ---- the conv form: a 64 x 64 tile (static_int8_conv's products) ----
//
// mobilenetv2's convs give products of K = 9 (a depthwise window) to 384 (a
// 1 x 1) over 8k-131k rows a group, and an NCHW output.  There the form
// above loses to this kernel's first form on every layer (3.3x over the B =
// 128 net, wo_compare.py --int8 on the H100): one 128-k stage a block, so
// each block is its set-up, its fold and its epilogue, at one or two blocks
// an SM; a thread a column writes the NCHW output scattered; an unaligned
// A's bytes load one after another.  So the conv keeps the first form: a 64
// x 64 tile of 4 warps a block (2 x 2, 32 x 32 each), the whole K a block in
// 64-byte k-slices staged in registers (A 2 x 16 bytes, B 2 x 4 x 4 bytes a
// thread, transposed on the way to shared memory), the row and column sums
// by __dp4a from shared memory, the epilogue above.  vec_a: 16-byte loads of
// A; vec_b: 4-byte loads of B.
namespace tile64 {

constexpr int kBM = 64, kBN = 64, kBK = 64;
constexpr int kThreads = 128;
constexpr int kLds = kBK + 16;  // shared row stride in bytes (conflict-free)

// one k-slice of the block's tiles, held in registers between the loads and
// the shared stores
struct Stage {
  int4 a[2];
  unsigned b[2][4];
};

__device__ __forceinline__ void load_stage(const MmArgs& p, const int8_t* A, const int8_t* B,
                                           int m0, int n0, int k0, Stage& st) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = t + i * kThreads;  // 256 chunks of 16 bytes
    const int row = c >> 2, kc = k0 + (c & 3) * 16;
    const int m = m0 + row;
    int4 v = make_int4(0, 0, 0, 0);
    if (m < p.M) {
      const int8_t* src = A + (long long)m * p.lda + kc;
      if (p.vec_a && kc + 16 <= p.K) {
        v = *reinterpret_cast<const int4*>(src);
      } else {
        unsigned w[4] = {0u, 0u, 0u, 0u};
        for (int j = 0; j < 16; ++j)
          if (kc + j < p.K) w[j >> 2] |= (unsigned)(uint8_t)src[j] << (8 * (j & 3));
        v = make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
      }
    }
    st.a[i] = v;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int blk = t + i * kThreads;  // 256 blocks of 4 x 4 bytes
    const int kb = blk >> 4, nb = blk & 15;
    const int n = n0 + nb * 4;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = k0 + kb * 4 + r;
      unsigned w = 0u;
      if (k < p.K) {
        const int8_t* src = B + (long long)k * p.ldb + n;
        if (p.vec_b && n + 4 <= p.N) {
          w = *reinterpret_cast<const unsigned*>(src);
        } else {
          for (int j = 0; j < 4; ++j)
            if (n + j < p.N) w |= (unsigned)(uint8_t)src[j] << (8 * j);
        }
      }
      st.b[i][r] = w;
    }
  }
}

__device__ __forceinline__ void store_stage(const Stage& st, int8_t* As, int8_t* Bs) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = t + i * kThreads;
    *reinterpret_cast<int4*>(As + (c >> 2) * kLds + (c & 3) * 16) = st.a[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int blk = t + i * kThreads;
    const int kb = blk >> 4, nb = blk & 15;
    unsigned c[4];
    transpose4(st.b[i][0], st.b[i][1], st.b[i][2], st.b[i][3], c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<unsigned*>(Bs + (nb * 4 + j) * kLds + kb * 4) = c[j];
  }
}

__global__ void __launch_bounds__(kThreads) kernel(MmArgs p) {
  __shared__ __align__(16) int8_t As[kBM * kLds];
  __shared__ __align__(16) int8_t Bs[kBN * kLds];
  __shared__ int rsum[kBM], csum[kBN];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, bt = blockIdx.z;
  const int8_t* A = p.a + bt * p.a_bstride;
  const int8_t* B = p.b + bt * p.b_bstride;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  int rpart = 0, cpart = 0;  // thread t: row / column t / 2, half t % 2

  Stage st;
  load_stage(p, A, B, m0, n0, 0, st);
  for (int k0 = 0; k0 < p.K; k0 += kBK) {
    __syncthreads();  // the previous slice's reads are done
    store_stage(st, As, Bs);
    __syncthreads();
    if (k0 + kBK < p.K) load_stage(p, A, B, m0, n0, k0 + kBK, st);
    {
      const unsigned* ra = reinterpret_cast<const unsigned*>(As + (t >> 1) * kLds + (t & 1) * 32);
      const unsigned* rb = reinterpret_cast<const unsigned*>(Bs + (t >> 1) * kLds + (t & 1) * 32);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        rpart = __dp4a((int)ra[j], 0x01010101, rpart);
        cpart = __dp4a((int)rb[j], 0x01010101, cpart);
      }
    }
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      unsigned af[2][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* r0 = As + (wm * 32 + mt * 16 + g) * kLds + ks + tig * 4;
        const int8_t* r8 = r0 + 8 * kLds;
        af[mt][0] = *reinterpret_cast<const unsigned*>(r0);
        af[mt][1] = *reinterpret_cast<const unsigned*>(r8);
        af[mt][2] = *reinterpret_cast<const unsigned*>(r0 + 16);
        af[mt][3] = *reinterpret_cast<const unsigned*>(r8 + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* c0 = Bs + (wn * 32 + nt * 8 + g) * kLds + ks + tig * 4;
        bf[nt][0] = *reinterpret_cast<const unsigned*>(c0);
        bf[nt][1] = *reinterpret_cast<const unsigned*>(c0 + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  }
  rpart += __shfl_xor_sync(0xffffffffu, rpart, 1);
  cpart += __shfl_xor_sync(0xffffffffu, cpart, 1);
  if ((t & 1) == 0) {
    rsum[t >> 1] = rpart;
    csum[t >> 1] = cpart;
  }
  __syncthreads();

  const float sx = p.qx[0], zpx = p.qx[1];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int nl = wn * 32 + nt * 8 + tig * 2 + e;
      const int n = n0 + nl;
      if (n >= p.N) continue;
      const long long qi = (long long)bt * p.q_bstride + (long long)n * p.q_nstride;
      const float sw = p.sw[qi], zw = __int2float_rn(p.zw[qi]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ml = wm * 32 + mt * 16 + g + h * 8;
          const int m = m0 + ml;
          if (m >= p.M) continue;
          const float o = epilogue(p, acc[mt][nt][h * 2 + e], rsum[ml], csum[nl], sx, zpx,
                                   sw, zw);
          p.out[bt * p.o_bstride + (m / p.o_hw) * p.o_mhi + (m % p.o_hw) * p.o_mlo +
                n * p.o_n] = o;
        }
      }
    }
  }
}

}  // namespace tile64

}  // namespace

extern "C" {

// act_quant_i8: x f32 (n), xq int8 (n), qx f32 (2) = [sx, zpx_c]; static:
// scale f32 (1,), zp int32 (1,); dynamic: work uint32 (1024,) for the
// partial maxima (scale, zp not read).  One launch (static) or two
// (dynamic).  Returns the first launch error, else cudaGetLastError().
int jlt_act_quant_i8(const void* x, const void* scale, const void* zp, void* xq, void* qx,
                     void* work, long long n, float qmin, float qmax, float shift,
                     int dynamic, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int blocks = quant_blocks(n);
  const int vec = (int)(reinterpret_cast<uintptr_t>(x) % 16 == 0);
  if (dynamic) {
    absmax_partials<<<blocks, kQuantThreads, 0, s>>>((const float*)x, n, vec, (unsigned*)work);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const QuantArgs q = {(const float*)scale, (const int*)zp, (const unsigned*)work, blocks,
                       dynamic, qmin, qmax, shift};
  act_quant<<<blocks, kQuantThreads, 0, s>>>((const float*)x, n, vec, (int8_t*)xq, (float*)qx,
                                             q);
  return (int)cudaGetLastError();
}

// i8mm: batch products of A (M, K) by B int8 (K, N) with the epilogue
// `mode` (0 static, 1 dynamic, 2 conv); strides as in the note at the top.
// The plan (serve/matmul.py i8mm_plan): bm rows (16, 32, 64, 128) by bn
// columns (128, or 64 up to bm = 64) a block, K over clusters of cs blocks
// of kper rows each (a multiple of 128, no rank empty).  fused = 0: A int8,
// qx read.  fused = 1 (bm <= 64): A is f32 x (lda and a_bstride in floats),
// quantized in the kernel with scale / zp (static) or after one
// absmax_partials launch into work (dynamic), qx written.  vec_a: 16-byte
// loads of A (int8: lda, the batch stride and the pointer multiples of 16;
// f32: of 4 floats and 16 bytes); vec_b: of B (multiples of 16).  One
// launch, two for a fused dynamic call.
int jlt_i8mm(const void* a, const void* b, void* out, long long a_bstride,
             long long b_bstride, long long o_bstride, long long o_hw, long long o_mhi,
             long long o_mlo, long long o_n, int lda, int ldb, int batch, int M, int N,
             int K, const void* qx, const void* sw, const void* zw, int q_bstride,
             int q_nstride, int mode, float window, int vec_a, int vec_b, int bm, int bn,
             int cs, int kper, int fused, const void* scale, const void* zp, void* work,
             float qmin, float qmax, float shift, int dynamic, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K > kMaxK || batch <= 0 || batch > 65535 ||
      (M + bm - 1) / bm > 65535 || o_hw <= 0 || cs < 1 || cs > kMaxCluster ||
      kper <= 0 || kper % kBK || (long long)kper * cs < K || (long long)kper * (cs - 1) >= K ||
      (bn != 128 && !(bn == 64 && bm <= 64)) ||
      (long long)((N + bn - 1) / bn) * cs > 2147483647LL || (fused && bm > 64) ||
      mm_smem(bm, bn, kper, fused) > (size_t)kRingBytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  MmArgs p = {};
  p.a = fused ? nullptr : (const int8_t*)a;
  p.x = fused ? (const float*)a : nullptr;
  p.b = (const int8_t*)b;
  p.out = (float*)out;
  p.a_bstride = a_bstride;
  p.b_bstride = b_bstride;
  p.o_bstride = o_bstride;
  p.o_hw = o_hw;
  p.o_mhi = o_mhi;
  p.o_mlo = o_mlo;
  p.o_n = o_n;
  p.lda = lda;
  p.ldb = ldb;
  p.M = M;
  p.N = N;
  p.K = K;
  p.qx = (const float*)qx;
  p.sw = (const float*)sw;
  p.zw = (const int*)zw;
  p.q_bstride = q_bstride;
  p.q_nstride = q_nstride;
  p.mode = mode;
  p.window = window;
  p.vec_a = vec_a;
  p.vec_b = vec_b;
  p.cs = cs;
  p.kper = kper;
  p.fused = fused;
  p.slots = mm_slots(bm, bn, kper, fused);
  if (fused) {
    const long long n = (long long)batch * M * K;  // x is (batch, M, K) contiguous
    const int blocks = quant_blocks(n);
    if (dynamic) {
      const int vec = (int)(reinterpret_cast<uintptr_t>(a) % 16 == 0);
      absmax_partials<<<blocks, kQuantThreads, 0, s>>>((const float*)a, n, vec,
                                                       (unsigned*)work);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    p.q = {(const float*)scale, (const int*)zp, (const unsigned*)work, blocks, dynamic, qmin,
           qmax, shift};
  }
  cudaError_t err;
  if (bn == 64) {
    switch (bm) {
      case 16: err = launch_mm<1, 4, 64>(p, batch, s); break;
      case 32: err = launch_mm<2, 4, 64>(p, batch, s); break;
      case 64: err = launch_mm<4, 2, 64>(p, batch, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (bm) {
      case 16: err = launch_mm<1, 4, 128>(p, batch, s); break;
      case 32: err = launch_mm<2, 4, 128>(p, batch, s); break;
      case 64: err = launch_mm<4, 2, 128>(p, batch, s); break;
      case 128: err = launch_mm<8, 1, 128>(p, batch, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // reported here: not left for the next call to find
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// i8mm's conv form (tile64 above): the same products and strides as
// jlt_i8mm, one 64 x 64 tile a block over the whole K; vec_a: 16-byte loads
// of A (lda, the batch stride and the pointer multiples of 16); vec_b:
// 4-byte loads of B (multiples of 4).  One launch.
int jlt_i8mm_tile64(const void* a, const void* b, void* out, long long a_bstride,
                    long long b_bstride, long long o_bstride, long long o_hw, long long o_mhi,
                    long long o_mlo, long long o_n, int lda, int ldb, int batch, int M, int N,
                    int K, const void* qx, const void* sw, const void* zw, int q_bstride,
                    int q_nstride, int mode, float window, int vec_a, int vec_b,
                    void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K > kMaxK || batch <= 0 || batch > 65535 ||
      (M + tile64::kBM - 1) / tile64::kBM > 65535 || o_hw <= 0)
    return (int)cudaErrorInvalidValue;
  MmArgs p = {};
  p.a = (const int8_t*)a;
  p.b = (const int8_t*)b;
  p.out = (float*)out;
  p.a_bstride = a_bstride;
  p.b_bstride = b_bstride;
  p.o_bstride = o_bstride;
  p.o_hw = o_hw;
  p.o_mhi = o_mhi;
  p.o_mlo = o_mlo;
  p.o_n = o_n;
  p.lda = lda;
  p.ldb = ldb;
  p.M = M;
  p.N = N;
  p.K = K;
  p.qx = (const float*)qx;
  p.sw = (const float*)sw;
  p.zw = (const int*)zw;
  p.q_bstride = q_bstride;
  p.q_nstride = q_nstride;
  p.mode = mode;
  p.window = window;
  p.vec_a = vec_a;
  p.vec_b = vec_b;
  const dim3 grid((N + tile64::kBN - 1) / tile64::kBN, (M + tile64::kBM - 1) / tile64::kBM,
                  batch);
  tile64::kernel<<<grid, tile64::kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
