// Flash-decoding attention of new queries against the dense KV cache.
//
// Replaces the TPU kernel jaxlsq/serve/attention.py:_attn_kernel (launched at
// :345 with window block skipping and at :356).  For each (batch b, kv head)
// the g = H/KVH query heads x t new rows are attended against the cache keys
// kpos with kpos <= qpos[b] + row (and kpos > qpos[b] + row - window when a
// window is set), in ONE pass over the cache with an online softmax in f32.
// Masked scores take the additive -1e9 of attention.py:50, never -inf.
//
// Cache carriers (CARRIER):
//   0 f32 and 1 bf16: (B, KVH, L, hd), read back as f32;
//   2 int8: data (B, KVH, L, hd) + f32 per-row scales (B, KVH, L); the key
//     scale multiplies the score after the QK dot, the value scale the softmax
//     weight before the AV dot (no dequantized copy anywhere);
//   3 int4: uint8 (B, KVH, L, hd/2), INTERLEAVED nibbles (low = even head-dim
//     index, high = odd; models/zoo.py:626-633), same per-row scales.
//
// What bounds it on an H100: decoding reads every cache byte once per step and
// does 4 * g * t operations per key element, far below the ~20 f32 operations
// per byte the card needs before arithmetic binds: it is bound by the cache
// bytes.  The design streams 64-key tiles of K and V through shared memory
// once per block (converted to f32 as they land), keeps the query rows, the
// score tile and the output accumulator in shared memory, and walks only the
// tiles that hold keys some row of the block can see (from the window's first
// key to the last causal key).  Skipped tiles are exactly the ones whose
// softmax weights would be exp(-1e9 - m) = 0, so skipping changes no bit.
//
// Every row is computed the same way whatever t, B or the row's place in the
// block (fixed 64-key tiles from key 0, fixed summation orders), so a token
// decoded at B = 8 gets the same bits as at B = 1, and prefill in chunks the
// same bits as in one call.
//
// Later work: one block per (b, kv head) is 16 blocks at B = 1, H = 16, far
// from filling 132 SMs; splitting L across blocks (a second pass combining the
// partial softmax states) is the known next step.
//
// PAGED: the same kernel over page pools through a block table (replaces the
// TPU kernel jaxlsq/serve/paged.py:paged_attention, launched at :362).  Pools
// are (P, KVH, ps, hd) (int4: hd / 2 bytes) with (P, KVH, ps) scales; key
// position kpos of batch row b, kv head h lives at pool row
// (table[b, kpos / ps] * KVH + h) * ps + kpos % ps (64-bit).  The block reads
// its table row from device memory into shared memory, 64 row offsets a
// tile, and everything else (64-key tiles counted from key 0, the window's
// tile skip, the summation orders, the -1e9 mask) is the dense kernel's, so a
// paged cache gives the dense kernel's bits on the same contents at any page
// size: only addresses differ.  L = pages_per_slot * ps.  Entries pointing
// at a page no row wrote (the engines' dummy page) sit at key positions the
// causal mask kills.  What bounds it: as the dense kernel, the cache bytes;
// a page is ps * hd contiguous carrier bytes, so any ps >= 1 streams whole
// rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // keys per tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxRows = 64;   // query rows per block
constexpr float kMask = -1e9f;

template <int CARRIER>
__device__ __forceinline__ float load_elem(const void* data, size_t row, int d,
                                           int hd) {
  if (CARRIER == 0) return static_cast<const float*>(data)[row * hd + d];
  if (CARRIER == 1)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(data)[row * hd + d]);
  if (CARRIER == 2) return (float)static_cast<const int8_t*>(data)[row * hd + d];
  const uint8_t b = static_cast<const uint8_t*>(data)[row * (hd / 2) + d / 2];
  const int nib = (d & 1) ? (b >> 4) : (b & 0xF);
  return (float)((nib ^ 8) - 8);
}

// grid: (B * KVH, ceil(gt / rows)); q/out are (B * KVH, gt, hd) with
// gt = g * t, row i holding query head i / t at new position i % t.
// PAGED: table (B, pps) int32, page_rows positions a page, L = pps * page_rows.
template <int CARRIER, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const float* __restrict__ q, const void* __restrict__ kd,
                        const float* __restrict__ ks, const void* __restrict__ vd,
                        const float* __restrict__ vs, const int* __restrict__ qpos,
                        const int* __restrict__ table, float* __restrict__ out,
                        int KVH, int L, int hd, int t, int gt, int rows,
                        int window, float scale, int page_rows, int pps) {
  constexpr bool kQuant = CARRIER >= 2;
  extern __shared__ float smem[];
  __shared__ size_t prow[PAGED ? kTile : 1];  // this tile's pool rows
  const int hdp = hd + 1;  // padded K rows: no bank conflicts in the QK loop
  float* qs = smem;                        // rows x hd
  float* ps = qs + rows * hd;              // rows x kTile
  float* kt = ps + rows * kTile;           // kTile x hdp
  float* vt = kt + kTile * hdp;            // kTile x hd
  float* acc = vt + kTile * hd;            // rows x hd
  float* ksc = acc + rows * hd;            // kTile
  float* vsc = ksc + kTile;                // kTile
  float* mrow = vsc + kTile;               // rows
  float* lrow = mrow + rows;               // rows
  float* arow = lrow + rows;               // rows

  const int bkv = blockIdx.x;
  const int b = bkv / KVH;
  const int r0 = blockIdx.y * rows;
  const int rb = min(rows, gt - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qp0 = qpos[b];

  const float* qblk = q + ((size_t)bkv * gt + r0) * hd;
  for (int i = tid; i < rb * hd; i += kThreads) {
    qs[i] = qblk[i];
    acc[i] = 0.f;
  }
  for (int i = tid; i < rb; i += kThreads) {
    mrow[i] = -1e30f;
    lrow[i] = 0.f;
  }

  // tiles some row of this block can see
  const int last_key = min(L - 1, qp0 + t - 1);
  const int first_key = window > 0 ? max(0, qp0 - window + 1) : 0;
  const int tile_end = last_key / kTile;
  const int tile_begin = min(first_key / kTile, tile_end);
  const size_t cache_row0 = (size_t)bkv * L;
  const int* trow = PAGED ? table + (size_t)b * pps : nullptr;
  const int head = bkv % KVH;

  for (int tile = tile_begin; tile <= tile_end; ++tile) {
    const int kbase = tile * kTile;
    // the last tile's row offsets were read before the last tile's post-load
    // barrier, which every thread has passed: they may be overwritten here
    if (PAGED && tid < kTile && kbase + tid < L) {
      const int kpos = kbase + tid;
      prow[tid] = ((size_t)trow[kpos / page_rows] * KVH + head) * page_rows +
                  kpos % page_rows;
    }
    __syncthreads();  // previous tile's readers are done
    for (int i = tid; i < kTile * hd; i += kThreads) {
      const int j = i / hd, d = i % hd;
      const int kpos = kbase + j;
      float kv = 0.f, vv = 0.f;
      if (kpos < L) {
        const size_t row = PAGED ? prow[PAGED ? j : 0] : cache_row0 + kpos;
        kv = load_elem<CARRIER>(kd, row, d, hd);
        vv = load_elem<CARRIER>(vd, row, d, hd);
      }
      kt[j * hdp + d] = kv;
      vt[j * hd + d] = vv;
    }
    if (kQuant) {
      for (int j = tid; j < kTile; j += kThreads) {
        const int kpos = kbase + j;
        const size_t row = PAGED ? prow[PAGED ? j : 0] : cache_row0 + kpos;
        ksc[j] = kpos < L ? ks[row] : 0.f;
        vsc[j] = kpos < L ? vs[row] : 0.f;
      }
    }
    __syncthreads();

    // scores, masked
    for (int i = tid; i < rb * kTile; i += kThreads) {
      const int r = i / kTile, j = i % kTile;
      const float* qr = qs + r * hd;
      const float* kr = kt + j * hdp;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      float s = dot;
      if (kQuant) s *= ksc[j];
      s *= scale;
      const int qp = qp0 + (r0 + r) % t;
      const int kpos = kbase + j;
      bool ok = kpos <= qp && kpos < L;
      if (window > 0) ok = ok && kpos > qp - window;
      ps[i] = ok ? s : kMask;
    }
    __syncthreads();

    // online softmax: one warp per row, two keys per lane
    for (int r = warp; r < rb; r += kThreads / 32) {
      const float s0 = ps[r * kTile + lane], s1 = ps[r * kTile + lane + 32];
      float mx = fmaxf(s0, s1);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = mrow[r];
      const float m_new = fmaxf(m_prev, mx);
      float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m_prev - m_new);
      if (kQuant) {
        p0 *= vsc[lane];
        p1 *= vsc[lane + 32];
      }
      ps[r * kTile + lane] = p0;
      ps[r * kTile + lane + 32] = p1;
      if (lane == 0) {
        lrow[r] = lrow[r] * alpha + sum;
        mrow[r] = m_new;
        arow[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v
    for (int i = tid; i < rb * hd; i += kThreads) {
      const int r = i / hd, d = i % hd;
      const float* pr = ps + r * kTile;
      float s = 0.f;
      for (int j = 0; j < kTile; ++j) s = fmaf(pr[j], vt[j * hd + d], s);
      acc[i] = acc[i] * arow[r] + s;
    }
  }
  __syncthreads();

  float* oblk = out + ((size_t)bkv * gt + r0) * hd;
  for (int i = tid; i < rb * hd; i += kThreads) oblk[i] = acc[i] / lrow[i / hd];
}

size_t smem_bytes(int rows, int hd) {
  return sizeof(float) * ((size_t)rows * hd * 2 + (size_t)rows * kTile +
                          (size_t)kTile * (hd + 1) + (size_t)kTile * hd +
                          2 * kTile + 3 * (size_t)rows);
}

template <int CARRIER, bool PAGED>
cudaError_t launch(const float* q, const void* kd, const float* ks,
                   const void* vd, const float* vs, const int* qpos,
                   const int* table, float* out, int B, int KVH, int L, int hd,
                   int t, int gt, int window, float scale, int ps, int pps,
                   cudaStream_t stream) {
  const int rows = min(gt, kMaxRows);
  const size_t smem = smem_bytes(rows, hd);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<CARRIER, PAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * KVH, (gt + rows - 1) / rows);
  decode_attention_kernel<CARRIER, PAGED><<<grid, kThreads, smem, stream>>>(
      q, kd, ks, vd, vs, qpos, table, out, KVH, L, hd, t, gt, rows, window,
      scale, ps, pps);
  return cudaSuccess;
}

template <bool PAGED>
int dispatch(const void* q, const void* kd, const void* ks, const void* vd,
             const void* vs, const void* qpos, const void* table, void* out,
             int B, int KVH, int L, int hd, int t, int gt, int window,
             int carrier, float scale, int ps, int pps, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* qf = (const float*)q;
  const float* ksf = (const float*)ks;
  const float* vsf = (const float*)vs;
  const int* qp = (const int*)qpos;
  const int* tb = (const int*)table;
  float* o = (float*)out;
  cudaError_t err;
  switch (carrier) {
    case 0: err = launch<0, PAGED>(qf, kd, ksf, vd, vsf, qp, tb, o, B, KVH, L, hd, t, gt, window, scale, ps, pps, s); break;
    case 1: err = launch<1, PAGED>(qf, kd, ksf, vd, vsf, qp, tb, o, B, KVH, L, hd, t, gt, window, scale, ps, pps, s); break;
    case 2: err = launch<2, PAGED>(qf, kd, ksf, vd, vsf, qp, tb, o, B, KVH, L, hd, t, gt, window, scale, ps, pps, s); break;
    case 3: err = launch<3, PAGED>(qf, kd, ksf, vd, vsf, qp, tb, o, B, KVH, L, hd, t, gt, window, scale, ps, pps, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out: f32 (B*KVH, gt, hd) contiguous; qpos: int32 (B,) position of the
// first new row per batch entry; window <= 0 means none.  ks/vs are ignored
// for float carriers.  Returns cudaGetLastError().
int jlt_decode_attention(const void* q, const void* kd, const void* ks,
                         const void* vd, const void* vs, const void* qpos,
                         void* out, int B, int KVH, int L, int hd, int t, int gt,
                         int window, int carrier, float scale, void* stream) {
  return dispatch<false>(q, kd, ks, vd, vs, qpos, nullptr, out, B, KVH, L, hd,
                         t, gt, window, carrier, scale, L, 1, stream);
}

// The same over page pools: kd/vd (P, KVH, ps, hd or hd / 2), ks/vs
// (P, KVH, ps), table int32 (B, pps) of pool page ids (the caller keeps them
// below P).  Returns cudaGetLastError().
int jlt_paged_attention(const void* q, const void* kd, const void* ks,
                        const void* vd, const void* vs, const void* qpos,
                        const void* table, void* out, int B, int KVH, int ps,
                        int pps, int hd, int t, int gt, int window, int carrier,
                        float scale, void* stream) {
  return dispatch<true>(q, kd, ks, vd, vs, qpos, table, out, B, KVH, ps * pps,
                        hd, t, gt, window, carrier, scale, ps, pps, stream);
}

}  // extern "C"
