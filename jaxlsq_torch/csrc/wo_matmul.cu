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
// What bounds it on an H100: in the decode regime (M <= 16) every weight byte
// is used M times, far below the card's ~20 f32 operations per byte of
// bandwidth, so the kernel is bound by streaming the K*N weight bytes once.
// The design reads each weight byte once per block of 16 activation rows: a
// block owns 128 output columns (a warp's 32 lanes x 4 adjacent columns, so a
// warp loads one contiguous 128-byte segment of a weight row) and one 128-row
// chunk of K, its 8 warps take the chunk's rows in turn (four row loads in
// flight per warp), and the activations of the chunk sit in shared memory.
// Splitting K into chunks gives enough blocks to spread the weight stream over
// the SMs (N/128 column tiles alone would be 8 blocks for N = 1024).  A second kernel sums the chunk partials in chunk
// order and applies the epilogue: the zero point as acc - rowsum(x) * z[n] for
// int4 (as _wo4_kernel does), subtracted per element for int8, then * s[n].
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;        // output columns per block (32 lanes x 4)
constexpr int kWarps = 8;         // warps sharing a K chunk
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;         // activation rows per block
constexpr int kChunk = 128;       // weight rows (int8) or byte rows (int4) per block
constexpr int kUnroll = 4;        // weight rows a warp loads before using them
constexpr int kSlab = 256;        // activation rows per launch pair

// How a block stages its chunk's activations: f32 split halves (wo8, wo4,
// wo4g), split halves rounded to bf16 (wo4_bf16), K contiguous (wo4_native:
// byte row r meets x[m, 2r] and x[m, 2r + 1]).
enum Stage { kStageF32, kStageBf16, kStageKContig };

// One (column tile, K chunk, row tile) block: partial sums of its chunk.
// part is (n_chunks, mslab, N); rowsum is (n_chunks, mslab) (int4 only).
// GROUPED (int4 only): gscale is (G, N); each nibble is scaled by its group.
// rowsum == nullptr (int4, no zero point): no rowsum is written.
template <bool INT4, bool GROUPED, Stage STAGE = kStageF32>
__global__ void __launch_bounds__(kThreads)
wo_partial_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                  const int* __restrict__ zp, const float* __restrict__ gscale,
                  float* __restrict__ part, float* __restrict__ rowsum, int M,
                  int K, int N, int KR, int per_channel, int gs) {
  __shared__ float xs[kRows][kChunk];
  __shared__ float xh[INT4 ? kRows : 1][INT4 ? kChunk : 1];
  __shared__ float red[kWarps][kCols];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kCols + lane * 4;
  const int chunk = blockIdx.y;
  const int r0 = chunk * kChunk;
  const int rc = min(kChunk, KR - r0);
  const int m0 = blockIdx.z * kRows;
  const int mt = min(kRows, M - m0);

  // stage this chunk's activations (low half; for int4 also the high half,
  // or for K contiguous the even and the odd k)
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
        if (INT4 && r0 + r + KR < K) hi = row[r0 + r + KR];
        if (STAGE == kStageBf16) {
          lo = __bfloat162float(__float2bfloat16_rn(lo));
          hi = __bfloat162float(__float2bfloat16_rn(hi));
        }
      }
    }
    xs[m][r] = lo;
    if (INT4) xh[m][r] = hi;
  }
  __syncthreads();

  int zc[4];
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + j;
    zc[j] = (n < N && !INT4) ? zp[per_channel ? n : 0] : 0;
  }
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
        if (INT4) {
          const int v = b[u][j];
          wlo[j] = (float)((int)((unsigned)v << 28) >> 28);  // sign-extended low nibble
          whi[j] = (float)(v >> 4);  // arithmetic shift: sign-extended high nibble
          if (GROUPED) {
            wlo[j] *= slo[j];
            whi[j] *= shi[j];
          }
        } else {
          wlo[j] = (float)((int)b[u][j] - zc[j]);
          whi[j] = 0.f;
        }
      }
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        if (m < mt) {
          const float xl = xs[m][r];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xl, wlo[j], acc[m][j]);
          if (INT4) {
            const float xu = xh[m][r];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xu, whi[j], acc[m][j]);
          }
        }
      }
    }
  }

  // rowsum(x) over this chunk, for the int4 zero-point epilogue
  if (INT4 && !GROUPED && rowsum && blockIdx.x == 0 && threadIdx.x < mt) {
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
template <bool INT4, bool GROUPED>
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
  if (INT4 && zp) {
    float rs = 0.f;
    for (int c = 0; c < n_chunks; ++c) rs += rowsum[(size_t)c * M + m];
    acc = acc - rs * (float)zp[ch];
  }
  out[i] = acc * scale[ch];
}

template <bool INT4, bool GROUPED, Stage STAGE = kStageF32>
void launch(const float* x, const int8_t* w, const float* scale, const int* zp,
            float* out, float* part, float* rowsum, int M, int K, int N,
            int per_channel, int gs, cudaStream_t stream) {
  const int KR = INT4 ? (K + 1) / 2 : K;
  const int n_chunks = (KR + kChunk - 1) / kChunk;
  for (int ms = 0; ms < M; ms += kSlab) {
    const int mslab = min(kSlab, M - ms);
    dim3 grid((N + kCols - 1) / kCols, n_chunks, (mslab + kRows - 1) / kRows);
    wo_partial_kernel<INT4, GROUPED, STAGE><<<grid, kThreads, 0, stream>>>(
        x + (size_t)ms * K, w, zp, scale, part, rowsum, mslab, K, N, KR,
        per_channel, gs);
    const size_t total = (size_t)mslab * N;
    wo_epilogue_kernel<INT4, GROUPED>
        <<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
            part, rowsum, scale, zp, out + (size_t)ms * N, mslab, N, n_chunks,
            per_channel);
  }
}

}  // namespace

extern "C" {

// Workspace: part holds n_chunks * min(M, 256) * N floats, rowsum
// n_chunks * min(M, 256) floats, n_chunks = ceil(rows / 128) with rows = K
// (int8) or ceil(K / 2) (int4).  group_size > 0 selects wo4g (int4 only, K
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
    launch<true, true>(xf, wb, sf, zi, (float*)out, (float*)part,
                       (float*)rowsum, M, K, N, per_channel, group_size, s);
  } else if (int4) {
    launch<true, false>(xf, wb, sf, zi, (float*)out, (float*)part,
                        (float*)rowsum, M, K, N, per_channel, 0, s);
  } else {
    launch<false, false>(xf, wb, sf, zi, (float*)out, (float*)part,
                         (float*)rowsum, M, K, N, per_channel, 0, s);
  }
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
    launch<true, false, kStageKContig>(xf, wb, sf, nullptr, (float*)out,
                                       (float*)part, nullptr, M, K, N, 1, 0, s);
  } else {
    launch<true, false, kStageBf16>(xf, wb, sf, nullptr, (float*)out,
                                    (float*)part, nullptr, M, K, N, 1, 0, s);
  }
  return (int)cudaGetLastError();
}

int jlt_wo_chunk_rows() { return kChunk; }
int jlt_wo_slab_rows() { return kSlab; }

const char* jlt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
