// Causal flash attention for the training path: forward, dK/dV and dQ.
//
// Replaces the upstream TPU kernels that jaxlsq/models/zoo.py:
// _flash_train_attention (:433) calls, in jax/experimental/pallas/ops/tpu/
// flash_attention.py: the forward kernel (:331, launched :758), the dK/dV
// kernel (:796, launched :1121) and the dQ kernel (:1146, launched :1456).
// q, k, v, o, dO are (BH, t, HD) f32 row-major per (batch, head); lse and D
// are (BH, t).  Scores are S = (q . k) * sm on the causal triangle (key <=
// query); each row's softmax is carried as its log-sum-exp, lse = m + log(l).
//
// flash_fwd: one block per (bh, 64-query tile).  K/V tiles of 64 keys stream
//   through shared memory from key 0 up to the diagonal tile; tiles above it
//   are never read.  Online softmax in f32 (running max m and sum l per row,
//   accurate expf), the output accumulator in registers; writes out = acc / l
//   and lse.
// flash_bwd_dkv: one block per (bh, 64-key tile).  K and V stay in shared
//   memory; query tiles (Q, dO, lse, D) stream from the diagonal tile down.
//   Per tile it recomputes P = exp(S * sm - lse), dV += P^T dO,
//   dS = P o (dO V^T - D), dK += dS^T Q (times sm at the end).
// flash_bwd_dq: one block per (bh, 64-query tile).  Q and dO stay in shared
//   memory; key tiles stream from key 0 to the diagonal.  dQ += dS K (times
//   sm at the end).
// D = rowsum(dO o O) is the caller's (one tensor op), as upstream computes
// `di` outside its kernels.
//
// Every block owns its output rows and sums in a fixed order: no atomics, so
// the results are the same bits on every run (the captured train step is
// held equal to the eager one leaf by leaf).  Rows and keys at or past t
// (the ragged last tile) are loaded as zeros, masked out of every softmax and
// every sum, and never written.
//
// What bounds it on an H100: at the training shapes (t = 2048-4096, HD = 64)
// the work is 4 * t^2 / 2 * HD flops per (b, h) for the forward and 2.5x that
// for the backward against 4-8 (t, HD) tensors moved: operations bound, at
// the f32 CUDA-core rate (67 TFLOP/s; this kernel uses no tensor cores).  The
// design is a simple tile kernel: 256 threads as 16 x 16, each owning a 4 x 4
// patch of every 64 x 64 score tile (rows ty + 16 i, columns tx + 16 j) and
// the matching rows x HD/16 columns (tx + 16 j) of its accumulators.  Tiles
// sit in shared memory row-major with a row stride of HD + 1 floats, so that
// reading down a column (16 lanes, 16 rows) and along a row (16 lanes, 16
// columns) both hit 16 different banks.  Each FMA of the inner products takes
// half a shared-memory load, so shared-memory bandwidth, not the FMA units,
// sets the pace; wgmma / TMA tiles are the known next step.  Longest tiles
// are scheduled first (the causal triangle makes work uneven across tiles).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // query rows and keys per tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kLdP = kTile + 1;    // row stride of a 64 x 64 score tile

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows [row0, row0 + 64) of a (t, HD) matrix into shared memory (stride
// HD + 1); rows at or past t become zeros.
template <int HD>
__device__ __forceinline__ void load_tile(float* __restrict__ s,
                                          const float* __restrict__ g, int row0,
                                          int t) {
  constexpr int kLd = HD + 1, kVec = HD / 4;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < t)
      val = *reinterpret_cast<const float4*>(g + (size_t)(row0 + r) * HD + c);
    float* d = s + r * kLd + c;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

// Entries [row0, row0 + 64) of a (t,) vector; 0 past t.
__device__ __forceinline__ void load_rows(float* __restrict__ s,
                                          const float* __restrict__ g, int row0,
                                          int t) {
  if (threadIdx.x < kTile)
    s[threadIdx.x] = row0 + (int)threadIdx.x < t ? g[row0 + threadIdx.x] : 0.f;
}

// acc[i][j] = sum over d of a[(ra + 16 i), d] * b[(rb + 16 j), d]: a 4 x 4
// patch of A B^T for two (64, HD) tiles in shared memory.
template <int HD>
__device__ __forceinline__ void dot_patch(float (&acc)[4][4],
                                          const float* __restrict__ a,
                                          const float* __restrict__ b, int ra,
                                          int rb) {
  constexpr int kLd = HD + 1;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ra + 16 * i) * kLd + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(rb + 16 * j) * kLd + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][e] += sum over c of p[(r + 16 i), c] * m[c, (tx + 16 e)]: rows of a
// 64 x 64 score tile (stride kLdP) times a (64, HD) tile.
template <int HD>
__device__ __forceinline__ void mul_patch(float (&acc)[4][HD / 16],
                                          const float* __restrict__ p,
                                          const float* __restrict__ m, int r,
                                          int tx) {
  constexpr int kLd = HD + 1, kD = HD / 16;
#pragma unroll 4
  for (int c = 0; c < kTile; ++c) {
    float x[4], y[kD];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = p[(r + 16 * i) * kLdP + c];
#pragma unroll
    for (int e = 0; e < kD; ++e) y[e] = m[c * kLd + tx + 16 * e];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < kD; ++e) acc[i][e] = fmaf(x[i], y[e], acc[i][e]);
  }
}

template <int HD>
constexpr int fwd_smem() {
  return (3 * kTile * (HD + 1) + kTile * kLdP) * (int)sizeof(float);
}

template <int HD>
constexpr int dkv_smem() {
  return (4 * kTile * (HD + 1) + 2 * kTile * kLdP + 2 * kTile) * (int)sizeof(float);
}

template <int HD>
constexpr int dq_smem() {
  return (4 * kTile * (HD + 1) + kTile * kLdP + 2 * kTile) * (int)sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int t, float sm) {
  constexpr int kLd = HD + 1, kD = HD / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTile * kLd;
  float* vs = ks + kTile * kLd;
  float* ps = vs + kTile * kLd;
  const int n_tiles = (t + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - (int)blockIdx.x;  // the longest rows first
  const size_t base = (size_t)blockIdx.y * t * HD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = qt * kTile;

  load_tile<HD>(qs, q + base, q0, t);
  float m[4], l[4], acc[4][kD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kD; ++e) acc[i][e] = 0.f;
  }
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's reads are done
    load_tile<HD>(ks, k + base, k0, t);
    load_tile<HD>(vs, v + base, k0, t);
    __syncthreads();
    float s[4][4] = {};
    dot_patch<HD>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        s[i][j] = (c <= r && c < t) ? s[i][j] * sm : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // finite: key 0 (tile 0, the first walked) is visible to every row
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
        ps[(ty + 16 * i) * kLdP + tx + 16 * j] = s[i][j];
      }
      l[i] = l[i] * alpha + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < kD; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();
    mul_patch<HD>(acc, ps, vs, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= t) continue;
    float* o = out + base + (size_t)r * HD;
#pragma unroll
    for (int e = 0; e < kD; ++e) o[tx + 16 * e] = acc[i][e] / l[i];
    if (tx == 0) lse[(size_t)blockIdx.y * t + r] = m[i] + logf(l[i]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dvec,
                         float* __restrict__ dk, float* __restrict__ dv, int t,
                         float sm) {
  constexpr int kLd = HD + 1, kD = HD / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * kLd;
  float* qs = vs + kTile * kLd;
  float* dos = qs + kTile * kLd;
  float* ps = dos + kTile * kLd;   // P^T: [key][query]
  float* dss = ps + kTile * kLdP;  // dS^T: [key][query]
  float* lse_s = dss + kTile * kLdP;
  float* d_s = lse_s + kTile;
  const int n_tiles = (t + kTile - 1) / kTile;
  const int kt = blockIdx.x;  // key tile 0 walks the most query tiles: first
  const size_t base = (size_t)blockIdx.y * t * HD;
  const size_t rbase = (size_t)blockIdx.y * t;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = kt * kTile;

  load_tile<HD>(ks, k + base, k0, t);
  load_tile<HD>(vs, v + base, k0, t);
  float adk[4][kD], adv[4][kD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < kD; ++e) adk[i][e] = adv[i][e] = 0.f;
  for (int qt = kt; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<HD>(qs, q + base, q0, t);
    load_tile<HD>(dos, dout + base, q0, t);
    load_rows(lse_s, lse + rbase, q0, t);
    load_rows(d_s, dvec + rbase, q0, t);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    dot_patch<HD>(s, ks, qs, ty, tx);    // S^T: keys ty + 16 i, queries tx + 16 j
    dot_patch<HD>(dp, vs, dos, ty, tx);  // dP^T = V dO^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rl = tx + 16 * j, r = q0 + rl;
        const float p = (c <= r && r < t) ? expf(s[i][j] * sm - lse_s[rl]) : 0.f;
        ps[(ty + 16 * i) * kLdP + rl] = p;
        dss[(ty + 16 * i) * kLdP + rl] = p * (dp[i][j] - d_s[rl]);
      }
    }
    __syncthreads();
    mul_patch<HD>(adv, ps, dos, ty, tx);
    mul_patch<HD>(adk, dss, qs, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= t) continue;
#pragma unroll
    for (int e = 0; e < kD; ++e) {
      dk[base + (size_t)c * HD + tx + 16 * e] = adk[i][e] * sm;
      dv[base + (size_t)c * HD + tx + 16 * e] = adv[i][e];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dvec,
                        float* __restrict__ dq, int t, float sm) {
  constexpr int kLd = HD + 1, kD = HD / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * kLd;
  float* ks = dos + kTile * kLd;
  float* vs = ks + kTile * kLd;
  float* dss = vs + kTile * kLd;  // dS: [query][key]
  float* lse_s = dss + kTile * kLdP;
  float* d_s = lse_s + kTile;
  const int n_tiles = (t + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - (int)blockIdx.x;  // the longest rows first
  const size_t base = (size_t)blockIdx.y * t * HD;
  const size_t rbase = (size_t)blockIdx.y * t;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = qt * kTile;

  load_tile<HD>(qs, q + base, q0, t);
  load_tile<HD>(dos, dout + base, q0, t);
  load_rows(lse_s, lse + rbase, q0, t);
  load_rows(d_s, dvec + rbase, q0, t);
  float adq[4][kD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < kD; ++e) adq[i][e] = 0.f;
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<HD>(ks, k + base, k0, t);
    load_tile<HD>(vs, v + base, k0, t);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    dot_patch<HD>(s, qs, ks, ty, tx);    // S: queries ty + 16 i, keys tx + 16 j
    dot_patch<HD>(dp, dos, vs, ty, tx);  // dP = dO V^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty + 16 * i, r = q0 + rl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const float p = (c <= r && r < t) ? expf(s[i][j] * sm - lse_s[rl]) : 0.f;
        dss[rl * kLdP + tx + 16 * j] = p * (dp[i][j] - d_s[rl]);
      }
    }
    __syncthreads();
    mul_patch<HD>(adq, dss, ks, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= t) continue;
#pragma unroll
    for (int e = 0; e < kD; ++e) dq[base + (size_t)r * HD + tx + 16 * e] = adq[i][e] * sm;
  }
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
int launch_fwd(const float* q, const float* k, const float* v, float* out,
               float* lse, int BH, int t, float sm, cudaStream_t stream) {
  static bool done = false;
  const int bytes = fwd_smem<HD>();
  cudaError_t err = opt_in(flash_fwd_kernel<HD>, bytes, done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + kTile - 1) / kTile, BH);
  flash_fwd_kernel<HD><<<grid, kThreads, bytes, stream>>>(q, k, v, out, lse, t, sm);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(const float* q, const float* k, const float* v, const float* dout,
               const float* lse, const float* dvec, float* dk, float* dv, int BH,
               int t, float sm, cudaStream_t stream) {
  static bool done = false;
  const int bytes = dkv_smem<HD>();
  cudaError_t err = opt_in(flash_bwd_dkv_kernel<HD>, bytes, done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + kTile - 1) / kTile, BH);
  flash_bwd_dkv_kernel<HD><<<grid, kThreads, bytes, stream>>>(q, k, v, dout, lse, dvec,
                                                              dk, dv, t, sm);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dq(const float* q, const float* k, const float* v, const float* dout,
              const float* lse, const float* dvec, float* dq, int BH, int t, float sm,
              cudaStream_t stream) {
  static bool done = false;
  const int bytes = dq_smem<HD>();
  cudaError_t err = opt_in(flash_bwd_dq_kernel<HD>, bytes, done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + kTile - 1) / kTile, BH);
  flash_bwd_dq_kernel<HD><<<grid, kThreads, bytes, stream>>>(q, k, v, dout, lse, dvec,
                                                             dq, t, sm);
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
// dk, dv (BH, t, hd).  Returns cudaGetLastError().
int jlt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* dvec, void* dk, void* dv, int BH,
                      int t, int hd, float sm, void* stream) {
#define CALL(H)                                                                    \
  launch_dkv<H>((const float*)q, (const float*)k, (const float*)v,                 \
                (const float*)dout, (const float*)lse, (const float*)dvec,         \
                (float*)dk, (float*)dv, BH, t, sm, (cudaStream_t)stream)
  JLT_FLASH_HD(hd, CALL)
#undef CALL
}

// As jlt_flash_bwd_dkv; writes dq (BH, t, hd).  Returns cudaGetLastError().
int jlt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* dvec, void* dq, int BH, int t,
                     int hd, float sm, void* stream) {
#define CALL(H)                                                                    \
  launch_dq<H>((const float*)q, (const float*)k, (const float*)v,                  \
               (const float*)dout, (const float*)lse, (const float*)dvec,          \
               (float*)dq, BH, t, sm, (cudaStream_t)stream)
  JLT_FLASH_HD(hd, CALL)
#undef CALL
}

}  // extern "C"
