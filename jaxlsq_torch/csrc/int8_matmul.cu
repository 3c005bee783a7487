// The int8 x int8 serving path: activation quantization to int8 (I1,
// act_quant_i8) and a batched int8 x int8 -> int32 product on the tensor
// cores with the dequant epilogue fused (I2, i8mm).
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
// The float to int8 conversion is jax's: saturating, NaN -> 0.  The
// dynamic absmax is a max over |x|'s bit patterns (a NaN's exceed +inf's, so
// a NaN passes as in jnp.max) in two launches: per-block partial maxima into
// a workspace, then the quantizing pass, whose every block folds the
// partials itself.  sx never leaves the card, so a CUDA graph captures it.
// Divisions are __fdiv_rn (a multiply by a reciprocal differs in the last
// bit), rintf rounds half to even as jnp.round.  Bound: the bytes (4 read,
// 1 written an element; the dynamic mode reads x twice).
//
// ---- i8mm (I2) ----
//
// For each batch b (1 for a matmul, E experts, G conv groups):
//   acc[m, n] = sum_k A[b, m, k] * B[b, k, n]          (int32, exact)
// A int8 row-major (lda), B int8 (K, N) row-major (ldb), each batch at its
// own stride.  Exact in any order while K * 128 * 128 < 2^31 (the wrapper
// holds K <= 131072).  A 64 x 64 output tile a block of 4 warps, each warp
// 32 x 32 of it as 2 x 4 mma.sync.m16n8k32 s8 tiles; K in 64-byte slices
// through shared memory, the next slice's loads in flight (registers) while
// the tensor cores run the current one.  The .col B operand wants four
// consecutive k of one n in a register, so each 4 x 4 byte block of the
// (K, N) slice is transposed in registers (__byte_perm) into the shared
// tile, stored n-major.  Ragged M, N and K are zero-filled (exact); 16-byte
// loads of A where its rows allow them, 4-byte loads of B, bytes at a
// ragged edge.  The block also sums its A rows and B columns over K from the
// shared tiles (__dp4a): rowsum(x_q) and colsum(w_q), per call, as jaxlsq
// computes them.
//
// The epilogue is each caller's formula in jaxlsq's order of f32 operations,
// every one an explicit _rn intrinsic (nvcc contracts no FMA), with
// sx, zpx_c from I1's qx and sw[n], zw[n] from the weight's qparams at
// b * q_bstride + n * q_nstride (per tensor, per column, per expert, or per
// output channel of a conv group):
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
//
// Bound: at decode M the weight bytes (K N a batch); at prefill M the int8
// tensor cores, 2 M N K at 1,979 TOPS.  This simple first form reaches
// neither (a block of 64 columns streams its whole K alone); PERF.md has its
// times.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kQuantThreads = 256;
constexpr int kMaxPartials = 1024;

constexpr int kBM = 64, kBN = 64, kBK = 64;
constexpr int kThreads = 128;
constexpr int kLds = kBK + 16;  // shared row stride in bytes (conflict-free)

enum { kStatic = 0, kDynamic = 1, kConv = 2 };

__device__ __forceinline__ unsigned warp_max(unsigned v) {
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// max over the threads of a block of kQuantThreads
__device__ unsigned block_max(unsigned v) {
  __shared__ unsigned red[kQuantThreads / 32];
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = threadIdx.x < kQuantThreads / 32 ? red[threadIdx.x] : 0u;
  if (threadIdx.x < 32) v = warp_max(v);
  return v;  // valid in warp 0
}

__global__ void __launch_bounds__(kQuantThreads)
absmax_partials(const float* __restrict__ x, long long n, unsigned* __restrict__ part) {
  unsigned m = 0;
  for (long long i = (long long)blockIdx.x * kQuantThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kQuantThreads)
    m = max(m, __float_as_uint(x[i]) & 0x7fffffffu);
  m = block_max(m);
  if (threadIdx.x == 0) part[blockIdx.x] = m;
}

__global__ void __launch_bounds__(kQuantThreads)
act_quant(const float* __restrict__ x, long long n, int8_t* __restrict__ xq,
          float* __restrict__ qx, const float* __restrict__ scale,
          const int* __restrict__ zp, const unsigned* __restrict__ part, int parts,
          float qmin, float qmax, float shift, int dynamic) {
  __shared__ float s_sx;
  float zpx = 0.0f;
  if (dynamic) {
    unsigned m = 0;
    for (int i = threadIdx.x; i < parts; i += kQuantThreads) m = max(m, part[i]);
    m = block_max(m);
    if (threadIdx.x == 0) {
      float sx = __fdiv_rn(__uint_as_float(m), 127.0f);
      s_sx = isnan(sx) ? sx : fmaxf(sx, FLT_MIN);
    }
  } else {
    zpx = __int2float_rn(zp[0]);
    if (threadIdx.x == 0) s_sx = scale[0];
  }
  __syncthreads();
  const float sx = s_sx;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    qx[0] = sx;
    qx[1] = dynamic ? 0.0f : __fsub_rn(zpx, shift);
  }
  for (long long i = (long long)blockIdx.x * kQuantThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kQuantThreads) {
    float v = __fdiv_rn(x[i], sx);
    if (!dynamic) v = __fadd_rn(v, zpx);
    float r = rintf(v);
    int q = 0;  // NaN -> 0, as jax's float -> int8 conversion
    if (!isnan(r)) {
      if (!dynamic) r = __fsub_rn(fminf(fmaxf(r, qmin), qmax), shift);
      q = (int)fminf(fmaxf(r, -128.0f), 127.0f);
    }
    xq[i] = (int8_t)q;
  }
}

struct MmArgs {
  const int8_t* a;
  const int8_t* b;
  float* out;
  long long a_bstride, b_bstride, o_bstride, o_hw, o_mhi, o_mlo, o_n;
  int lda, ldb, M, N, K;
  const float* qx;
  const float* sw;
  const int* zw;
  int q_bstride, q_nstride, mode, vec_a, vec_b;
  float window;
};

// one k-slice of the block's tiles, held in registers between the loads and
// the shared stores: A as 2 x 16 bytes a thread, B as 2 x (4 rows x 4 bytes)
struct Stage {
  int4 a[2];
  unsigned b[2][4];
};

__device__ __forceinline__ void load_stage(const MmArgs& p, const int8_t* A, const int8_t* B,
                                           int m0, int n0, int k0, Stage& st) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = t + i * kThreads;        // 256 chunks of 16 bytes
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
    const int blk = t + i * kThreads;      // 256 blocks of 4 x 4 bytes
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
    const unsigned* r = st.b[i];
    // rows k..k+3 of columns n..n+3 -> columns n..n+3 of rows k..k+3
    const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);
    const unsigned t1 = __byte_perm(r[0], r[1], 0x7362);
    const unsigned t2 = __byte_perm(r[2], r[3], 0x5140);
    const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
    const unsigned c[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                           __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<unsigned*>(Bs + (nb * 4 + j) * kLds + kb * 4) = c[j];
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

__global__ void __launch_bounds__(kThreads) i8mm_kernel(MmArgs p) {
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

int quant_blocks(long long n) {
  long long b = (n + kQuantThreads * 4 - 1) / (kQuantThreads * 4);
  return (int)(b < 1 ? 1 : (b > kMaxPartials ? kMaxPartials : b));
}

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
  if (dynamic) {
    absmax_partials<<<blocks, kQuantThreads, 0, s>>>((const float*)x, n, (unsigned*)work);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  act_quant<<<blocks, kQuantThreads, 0, s>>>(
      (const float*)x, n, (int8_t*)xq, (float*)qx, (const float*)scale, (const int*)zp,
      (const unsigned*)work, blocks, qmin, qmax, shift, dynamic);
  return (int)cudaGetLastError();
}

// i8mm: batch products of A int8 (M, K) by B int8 (K, N) with the epilogue
// `mode` (0 static, 1 dynamic, 2 conv); strides as in the note at the top.
// vec_a: 16-byte loads of A allowed (lda, the batch stride and the pointer
// multiples of 16); vec_b: 4-byte loads of B (ldb, the batch stride and the
// pointer multiples of 4).  One launch.
int jlt_i8mm(const void* a, const void* b, void* out, long long a_bstride,
             long long b_bstride, long long o_bstride, long long o_hw, long long o_mhi,
             long long o_mlo, long long o_n, int lda, int ldb, int batch, int M, int N,
             int K, const void* qx, const void* sw, const void* zw, int q_bstride,
             int q_nstride, int mode, float window, int vec_a, int vec_b, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K > 131072 || batch <= 0 || batch > 65535 ||
      (M + kBM - 1) / kBM > 65535 || o_hw <= 0)
    return (int)cudaErrorInvalidValue;
  MmArgs p;
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
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  i8mm_kernel<<<grid, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
