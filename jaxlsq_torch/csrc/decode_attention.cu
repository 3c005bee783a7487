// Flash-decoding attention of new queries against the KV cache, split along
// the cache, with a fixed-order fold of the partial softmax states.
//
// Replaces the TPU kernels jaxlsq/serve/attention.py:_attn_kernel (launched
// at :345 with window block skipping and at :356) and, through the PAGED
// instance of the same body, jaxlsq/serve/paged.py:paged_attention (launched
// at :362).  For each (batch b, kv head) the g = H/KVH query heads x t new
// rows are attended against the cache keys kpos with kpos <= qpos[b] + row
// (and kpos > qpos[b] + row - window when a window is set), with an online
// softmax in f32.  Masked scores take the additive -1e9 of attention.py:50,
// never -inf.
//
// Cache carriers (CARRIER):
//   0 f32 and 1 bf16: (B, KVH, L, hd), read back as f32;
//   2 int8: data (B, KVH, L, hd) + f32 per-row scales (B, KVH, L); the key
//     scale multiplies the score after the QK dot, the value scale the softmax
//     weight before the AV dot (no dequantized copy anywhere);
//   3 int4: uint8 (B, KVH, L, hd/2), INTERLEAVED nibbles (low = even head-dim
//     index, high = odd; models/zoo.py:626-633), same per-row scales.
// Any head_dim <= 128 (even for int4).
//
// The order, which depends on key positions only (never on L, B, t, the row
// tile, the page size or the grid):
//   1. the keys are cut into spans of kSpan = 256 keys counted from key 0,
//      each four 64-key tiles;
//   2. within a span the online softmax walks the 64-key tiles in order from
//      m = -1e30, l = 0, acc = 0: a score is the dot of q and k split over 8
//      lanes (lane i: head-dim slice i, an fmaf chain in ascending order),
//      summed in one xor tree (4, 2, 1), times the key scale (int), times
//      1/sqrt(hd), or -1e9 where masked; per tile m' = max(m, tile max),
//      p = exp(s - m'), the tile's sum of p in one xor tree over 32 lanes (two
//      keys a lane: p[j] + p[j + 32] first), l = fmaf(l, exp(m - m'), sum),
//      p times the value scale (int), acc = fmaf(acc, exp(m - m'),
//      (c0 + c1) + (c2 + c3)) where cu is an fmaf chain of p[j] * v[j] over
//      the tile's keys j = u, u + 4, ..., 60 + u;
//   3. each span leaves a state (m, l, acc[hd]) a query row;
//   4. the states are left-folded in ascending span order from (m = -1e30,
//      l = 0, acc = 0): m' = max(m, m_i), l' = fmaf(l_i, exp(m_i - m'),
//      l * exp(m - m')), acc' likewise; out = acc / l.
// A block walks the tiles of its span that hold keys some row of its call can
// see (from the window's first key to the last causal key) and only those
// spans are folded.  A tile or a span that a row cannot see gives it m = -1e9
// and weight exp(-1e9 - m) = 0 exactly wherever it falls in the walk or the
// fold, so walking it and skipping it give the same bits: a token decoded at
// B = 8 gets the same bits as at B = 1, prefill in chunks the same bits as in
// one call, and a paged cache the dense cache's bits.
//
// What bounds it on an H100: decoding reads every cache byte once per step and
// does 4 * g * t operations per key element, far below the ~20 f32 operations
// per byte the card needs before arithmetic binds: it is bound by the cache
// bytes.  The design: the grid is (B * KVH, row tiles of 8, spans), 1,024
// blocks at B = 8, L = 2048, t = 1; a block streams its span's tiles through
// shared memory as raw carrier bytes with 16-byte cp.async copies (a tile's
// rows a thread quarter each, the row's offset computed once), all four tiles
// in flight at once where they fit in 64 KB (int8, int4; bf16 up to hd 64),
// else the next tile while this one is computed.  The score of (row, key) is
// 8 lanes' slice dots and a 3-step shuffle tree, every warp scoring its 8 keys
// of a tile for every row.  With all four tiles in, the (row, tile) pairs'
// weights and P.V sums run on separate warps, and only the short walk of step
// 2's fmaf sequence over a row's tiles stays serial; else each warp owns a row
// (its m, l and acc in registers) tile by tile.  The states go to a workspace
// that a second, light kernel folds (one thread an output element, eight
// spans' loads in flight): no counters, no fences, any L.
//
// PAGED: the same body over page pools through a block table.  Pools are
// (P, KVH, ps, hd) (int4: hd / 2 bytes) with (P, KVH, ps) scales; key
// position kpos of batch row b, kv head h lives at pool row
// (table[b, kpos / ps] * KVH + h) * ps + kpos % ps (64-bit).  Only the row
// addresses differ, at any page size; L = pages_per_slot * ps.  Entries
// pointing at a page no row wrote (the engines' dummy page) sit at key
// positions the causal mask kills.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

using jlt::copy_async;
using jlt::copy_commit;
using jlt::copy_wait;

constexpr int kTile = 64;             // keys a tile
constexpr int kTilesPerSpan = 4;      // kSpan = 256 keys
constexpr int kThreads = 256;         // 8 warps
constexpr int kFoldThreads = 64;      // the fold: more, smaller blocks
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = kWarps;       // query rows a block, one a warp
constexpr int kLanesPerKey = 8;       // a score's head-dim slices
constexpr float kMask = -1e9f;
constexpr float kInit = -1e30f;

// tiles of a span a block keeps in flight: all four where a stage (K and V
// rows of 64 keys) is at most 16 KB, else two
__host__ __device__ constexpr int stages(int row_bytes) { return row_bytes <= 128 ? 4 : 2; }

template <int CARRIER>
struct Carrier {
  static constexpr int kBits = CARRIER == 0 ? 32 : CARRIER == 1 ? 16 : CARRIER == 2 ? 8 : 4;
  static constexpr bool kQuant = CARRIER >= 2;
};

// the tiles some row of a call (first position qp0, t rows, window) can see
__device__ __forceinline__ void tile_range(int qp0, int t, int L, int window,
                                           int& begin, int& end) {
  const int last_key = min(L - 1, qp0 + t - 1);
  const int first_key = window > 0 ? max(0, qp0 - window + 1) : 0;
  end = last_key / kTile;
  begin = min(first_key / kTile, end);
}

// N 32-bit words from 16-byte-aligned shared memory, in the widest loads
template <int N>
__device__ __forceinline__ void load_words(const uint8_t* p, unsigned* w) {
  if (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i / 4];
      w[i] = v.x; w[i + 1] = v.y; w[i + 2] = v.z; w[i + 3] = v.w;
    }
  } else if (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const uint2 v = reinterpret_cast<const uint2*>(p)[i / 2];
      w[i] = v.x; w[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = reinterpret_cast<const unsigned*>(p)[i];
  }
}

// element e of a word of carrier values as f32 (exact): int8 and int4 via
// the integer in the low mantissa bits of 2^23
template <int CARRIER>
__device__ __forceinline__ float word_elem(unsigned w, int e) {
  if (CARRIER == 0) return __uint_as_float(w);
  if (CARRIER == 1) return __uint_as_float(e ? (w & 0xFFFF0000u) : (w << 16));
  if (CARRIER == 2)  // byte e + 128 into 2^23's mantissa: one byte permute
    return __fsub_rn(__uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7650u | e)),
                     8388736.f);
  return __fsub_rn(__uint_as_float(0x4B000000u | (((w >> (4 * e)) & 0xFu) ^ 0x8u)),
                   8388616.f);
}

// element d of a shared-memory row
template <int CARRIER>
__device__ __forceinline__ float row_elem(const uint8_t* row, int d) {
  if (CARRIER == 0) return reinterpret_cast<const float*>(row)[d];
  if (CARRIER == 1)
    return __uint_as_float((unsigned)reinterpret_cast<const uint16_t*>(row)[d] << 16);
  if (CARRIER == 2) return word_elem<2>(row[d], 0);
  return word_elem<3>(row[d >> 1], d & 1);
}

// One (b * KVH + head, row tile, span) block of at most 8 query rows, warp
// r owning row r.  q (B * KVH, gt, hd) with gt = g * t, row i holding query
// head i / t at new position i % t.  The span's state goes to ws_ml
// (B * KVH, NS, gt) float2 and ws_acc (B * KVH, NS, gt, hd).  DL: head-dim
// slice a lane (hd <= 8 * DL).  PAGED: table (B, pps), page_rows positions a
// page, L = pps * page_rows.
//
// Where the span's four tiles fit in shared memory at once (NST == 4) the
// block scores all of them, then finds the tiles' maxima, then takes each
// (row, tile)'s weights, weight sum and P.V sums on its own warp, and last
// walks each row's tiles in order with the same fmaf sequence as a tile-by-
// tile walk; else it walks tile by tile, the next tile in flight.  Both give
// the same bits.
template <int CARRIER, bool PAGED, int DL>
__global__ void __launch_bounds__(kThreads)
decode_attention_span_kernel(const float* __restrict__ q, const uint8_t* __restrict__ kd,
                             const float* __restrict__ ks, const uint8_t* __restrict__ vd,
                             const float* __restrict__ vs, const int* __restrict__ qpos,
                             const int* __restrict__ table, float2* __restrict__ ws_ml,
                             float* __restrict__ ws_acc, int KVH, int L, int hd, int t,
                             int gt, int window, float scale, int page_rows, int pps,
                             int rowbytes, int ch) {
  using Car = Carrier<CARRIER>;
  constexpr int RS = DL * Car::kBits;        // bytes of a shared-memory row (8 * DL elements)
  constexpr int QW = kLanesPerKey * DL;      // padded head-dim
  constexpr int NW = DL * Car::kBits / 32;   // words of a lane's slice (int4, DL 8: 1)
  constexpr int EPW = 32 / Car::kBits;       // elements a word
  constexpr int HC = DL / 4;                 // head-dim columns a lane in P.V (32 apart)
  constexpr int NST = stages(RS);            // tiles in flight
  constexpr int SW = NST * kTile;            // scores a row keeps
  extern __shared__ uint4 smem4[];
  uint8_t* kst = reinterpret_cast<uint8_t*>(smem4);      // NST stages x kTile x RS
  uint8_t* vst = kst + NST * kTile * RS;                 // NST stages x kTile x RS
  float* ksc = reinterpret_cast<float*>(vst + NST * kTile * RS);  // NST x kTile
  float* vsc = ksc + NST * kTile;                        // NST x kTile
  float* qs = vsc + NST * kTile;                         // kMaxRows x QW
  float* ss = qs + kMaxRows * QW;                        // kMaxRows x SW
  float* smx = ss + kMaxRows * SW;                       // kMaxRows x NST tile maxima
  float* ssum = smx + kMaxRows * NST;                    // kMaxRows x NST weight sums
  float* tpv = ssum + kMaxRows * NST;                    // kMaxRows x NST x 32 HC P.V sums
  int* sqp = reinterpret_cast<int*>(tpv + kMaxRows * NST * 32 * HC);  // rows' positions

  const int bkv = blockIdx.x, b = bkv / KVH, head = bkv % KVH;
  const int r0 = blockIdx.y * kMaxRows;
  const int rb = min(kMaxRows, gt - r0);
  const int span = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qp0 = qpos[b];
  int tile_begin, tile_end;
  tile_range(qp0, t, L, window, tile_begin, tile_end);
  const int tile_lo = max(tile_begin, span * kTilesPerSpan);
  const int tile_hi = min(tile_end, span * kTilesPerSpan + kTilesPerSpan - 1);
  if (tile_lo > tile_hi) return;  // a span no row of the call can see: not folded

  // a tile's rows: 4 threads a key (the row's offset computed once a thread),
  // K and V chunks taken in turn; threads 0-63 also copy the key scale,
  // 64-127 the value scale
  const size_t cache_row0 = (size_t)bkv * L;
  const int* trow = PAGED ? table + (size_t)b * pps : nullptr;
  const int cpr = rowbytes / ch;
  auto issue = [&](int tile, int stage) {
    const int j = tid >> 2, part = tid & 3;
    const int kpos = tile * kTile + j;
    const bool live = kpos < L;
    size_t row = 0;
    if (live)
      row = PAGED ? ((size_t)trow[kpos / page_rows] * KVH + head) * page_rows + kpos % page_rows
                  : cache_row0 + kpos;
    uint8_t* kdst = kst + (stage * kTile + j) * RS;
    uint8_t* vdst = vst + (stage * kTile + j) * RS;
    const uint8_t* ksrc = kd + row * rowbytes;
    const uint8_t* vsrc = vd + row * rowbytes;
    for (int c = part; c < cpr; c += 4) {
      copy_async(kdst + c * ch, ksrc + c * ch, ch, live);
      copy_async(vdst + c * ch, vsrc + c * ch, ch, live);
    }
    if (Car::kQuant && part < 2) {
      const float* src = (part == 0 ? ks : vs) + row;
      float* dst = (part == 0 ? ksc : vsc) + stage * kTile + j;
      copy_async(reinterpret_cast<uint8_t*>(dst), reinterpret_cast<const uint8_t*>(src), 4,
                 live);
    }
    copy_commit();
  };
  const int ntiles = tile_hi - tile_lo + 1;
  for (int i = 0; i < min(NST, ntiles); ++i) issue(tile_lo + i, i);

  // the padded tail of every shared row (never copied) and q, zero-padded
  for (int i = tid; i < 2 * NST * kTile * (RS - rowbytes); i += kThreads) {
    const int r = i / (RS - rowbytes), c = rowbytes + i % (RS - rowbytes);
    (r < NST * kTile ? kst : vst)[(r % (NST * kTile)) * RS + c] = 0;
  }
  const float* qblk = q + ((size_t)bkv * gt + r0) * hd;
  for (int i = tid; i < rb * QW; i += kThreads) {
    const int r = i / QW, d = i % QW;
    qs[i] = d < hd ? qblk[(size_t)r * hd + d] : 0.f;
  }
  if (tid < rb) sqp[tid] = qp0 + (r0 + tid) % t;

  // scores of tile it (in stage) into ss[r][sbase + j]: warp w takes keys
  // 8w .. 8w + 7, four at a time, 8 lanes a key
  const int kq = lane >> 3, sl = lane & 7;  // key of the 4-key group, head-dim slice
  auto scores = [&](int it, int stage, int sbase) {
    const int kbase = (tile_lo + it) * kTile;
    const uint8_t* kt = kst + stage * kTile * RS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 8 * warp + 4 * h + kq;
      unsigned wk[NW];
      load_words<NW>(kt + j * RS + sl * (RS / kLanesPerKey), wk);
      float kf[DL];
#pragma unroll
      for (int e = 0; e < DL; ++e) kf[e] = word_elem<CARRIER>(wk[e / EPW], e % EPW);
      const int kpos = kbase + j;
      const float kscale = Car::kQuant ? ksc[stage * kTile + j] : 1.f;
      for (int r = 0; r < rb; ++r) {
        const float* qr = qs + r * QW + sl * DL;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < DL; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + e);
          dot = fmaf(qv.x, kf[e], dot);
          dot = fmaf(qv.y, kf[e + 1], dot);
          dot = fmaf(qv.z, kf[e + 2], dot);
          dot = fmaf(qv.w, kf[e + 3], dot);
        }
        dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, 4));
        dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, 2));
        dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, 1));
        if (sl == 0) {
          float sc = dot;
          if (Car::kQuant) sc = __fmul_rn(sc, kscale);
          sc = __fmul_rn(sc, scale);
          const int qp = sqp[r];
          bool ok = kpos <= qp && kpos < L;
          if (window > 0) ok = ok && kpos > qp - window;
          ss[r * SW + sbase + j] = ok ? sc : kMask;
        }
      }
    }
  };
  // a (row, tile)'s score maximum (two keys a lane, xor tree)
  auto tile_max = [&](const float* sr) {
    float mx = fmaxf(sr[lane], sr[lane + 32]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    return mx;
  };
  // its weights exp(s - m) (times the value scale, in place) and their sum
  auto weights = [&](float* sr, float m, int stage) {
    float p0 = expf(sr[lane] - m), p1 = expf(sr[lane + 32] - m);
    float sum = __fadd_rn(p0, p1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
    if (Car::kQuant) {
      p0 = __fmul_rn(p0, vsc[stage * kTile + lane]);
      p1 = __fmul_rn(p1, vsc[stage * kTile + lane + 32]);
    }
    sr[lane] = p0;
    sr[lane + 32] = p1;
    __syncwarp();
    return sum;
  };
  // its P.V sums: four chains over the keys j = u mod 4, (c0 + c1) + (c2 + c3)
  auto pv = [&](const float* sr, int stage, float* out) {
    const uint8_t* vt = vst + stage * kTile * RS;
    float c[HC][4];
#pragma unroll
    for (int h = 0; h < HC; ++h)
#pragma unroll
      for (int u = 0; u < 4; ++u) c[h][u] = 0.f;
#pragma unroll 4
    for (int j0 = 0; j0 < kTile; j0 += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(sr + j0);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float p = u == 0 ? p4.x : u == 1 ? p4.y : u == 2 ? p4.z : p4.w;
        const uint8_t* vrow = vt + (j0 + u) * RS;
#pragma unroll
        for (int h = 0; h < HC; ++h) {
          const int d = lane + 32 * h;
          const float v = d < hd ? row_elem<CARRIER>(vrow, d) : 0.f;
          c[h][u] = fmaf(p, v, c[h][u]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < HC; ++h)
      out[h] = __fadd_rn(__fadd_rn(c[h][0], c[h][1]), __fadd_rn(c[h][2], c[h][3]));
  };

  // this warp's row: the online softmax state
  float m = kInit, l = 0.f, acc[HC];
#pragma unroll
  for (int h = 0; h < HC; ++h) acc[h] = 0.f;
  const int r = warp;
  float* srow = ss + r * SW;

  if (NST == kTilesPerSpan) {
    // every tile of the span at once
    copy_wait(0);
    __syncthreads();
    for (int it = 0; it < ntiles; ++it) scores(it, it, it * kTile);
    __syncthreads();
    for (int p = warp; p < rb * ntiles; p += kWarps) {
      const float mx = tile_max(ss + (p / ntiles) * SW + (p % ntiles) * kTile);
      if (lane == 0) smx[(p / ntiles) * NST + p % ntiles] = mx;
    }
    __syncthreads();
    for (int p = warp; p < rb * ntiles; p += kWarps) {
      const int pr = p / ntiles, it = p % ntiles;
      float mi = kInit;  // the row's running maximum after tile it
      for (int u = 0; u <= it; ++u) mi = fmaxf(mi, smx[pr * NST + u]);
      float* sr = ss + pr * SW + it * kTile;
      const float sum = weights(sr, mi, it);
      float t_[HC];
      pv(sr, it, t_);
      if (lane == 0) ssum[pr * NST + it] = sum;
#pragma unroll
      for (int h = 0; h < HC; ++h) tpv[(pr * NST + it) * 32 * HC + 32 * h + lane] = t_[h];
    }
    __syncthreads();
    if (r < rb) {
      for (int it = 0; it < ntiles; ++it) {
        const float m_new = fmaxf(m, smx[r * NST + it]);
        const float alpha = expf(m - m_new);
        l = fmaf(l, alpha, ssum[r * NST + it]);
#pragma unroll
        for (int h = 0; h < HC; ++h)
          acc[h] = fmaf(acc[h], alpha, tpv[(r * NST + it) * 32 * HC + 32 * h + lane]);
        m = m_new;
      }
    }
  } else {
    // tile by tile, the next tile in flight
    for (int it = 0; it < ntiles; ++it) {
      const int stage = it % NST;
      // tiles issued so far: min(ntiles, NST + max(0, it - 1)); wait for this one
      copy_wait(min(ntiles, NST + max(0, it - 1)) - it - 1);
      __syncthreads();  // this tile landed; every warp is done with the last one
      // refill the last tile's stage
      if (it >= 1 && it - 1 + NST < ntiles) issue(tile_lo + it - 1 + NST, (it - 1) % NST);
      scores(it, stage, 0);
      __syncthreads();
      if (r < rb) {
        const float m_new = fmaxf(m, tile_max(srow));
        const float alpha = expf(m - m_new);
        l = fmaf(l, alpha, weights(srow, m_new, stage));
        float t_[HC];
        pv(srow, stage, t_);
#pragma unroll
        for (int h = 0; h < HC; ++h) acc[h] = fmaf(acc[h], alpha, t_[h]);
        m = m_new;
      }
    }
  }

  // this span's state of the warp's row
  if (r < rb) {
    const size_t st = ((size_t)bkv * gridDim.z + span) * gt + r0 + r;
    if (lane == 0) ws_ml[st] = make_float2(m, l);
#pragma unroll
    for (int h = 0; h < HC; ++h) {
      const int d = lane + 32 * h;
      if (d < hd) ws_acc[st * hd + d] = acc[h];
    }
  }
}

// The fold: one thread an output element (b * KVH + head, row, d); the spans
// its call walked, in ascending order (the span kernel's tile_range), the
// loads of 16 spans in flight.
__global__ void __launch_bounds__(kFoldThreads)
decode_attention_fold_kernel(const float2* __restrict__ ws_ml, const float* __restrict__ ws_acc,
                             const int* __restrict__ qpos, float* __restrict__ out, int KVH,
                             int L, int hd, int t, int gt, int window, int NS, size_t total) {
  constexpr int kAhead = 16;
  const size_t i = (size_t)blockIdx.x * kFoldThreads + threadIdx.x;
  if (i >= total) return;
  const int d = (int)(i % hd);
  const size_t rowi = i / hd;  // (bkv, row)
  const int r = (int)(rowi % gt);
  const int bkv = (int)(rowi / gt);
  int tile_begin, tile_end;
  tile_range(qpos[bkv / KVH], t, L, window, tile_begin, tile_end);
  float m = kInit, l = 0.f, a = 0.f;
  const int s_end = tile_end / kTilesPerSpan;
  for (int s0 = tile_begin / kTilesPerSpan; s0 <= s_end; s0 += kAhead) {
    float2 ml[kAhead];
    float as[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const size_t st = ((size_t)bkv * NS + min(s0 + u, s_end)) * gt + r;
      ml[u] = ws_ml[st];
      as[u] = ws_acc[st * hd + d];
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (s0 + u > s_end) break;
      const float m_new = fmaxf(m, ml[u].x);
      const float e = expf(m - m_new), es = expf(ml[u].x - m_new);
      l = fmaf(ml[u].y, es, __fmul_rn(l, e));
      a = fmaf(as[u], es, __fmul_rn(a, e));
      m = m_new;
    }
  }
  out[i] = __fdiv_rn(a, l);
}

template <int CARRIER, int DL>
constexpr size_t smem_bytes() {
  constexpr int RS = DL * Carrier<CARRIER>::kBits;
  constexpr int NST = stages(RS);
  return 2 * (size_t)NST * kTile * RS +
         sizeof(float) * (2 * (size_t)NST * kTile + kMaxRows * (kLanesPerKey * DL) +
                          kMaxRows * NST * (kTile + 2 + 8 * DL) + kMaxRows);
}

template <int CARRIER, bool PAGED, int DL>
cudaError_t launch_span(const float* q, const uint8_t* kd, const float* ks, const uint8_t* vd,
                        const float* vs, const int* qpos, const int* table, float2* ws_ml,
                        float* ws_acc, int B, int KVH, int L, int hd, int t, int gt, int NS,
                        int window, float scale, int ps, int pps, int rowbytes, int ch,
                        cudaStream_t stream) {
  auto kernel = decode_attention_span_kernel<CARRIER, PAGED, DL>;
  constexpr size_t smem = smem_bytes<CARRIER, DL>();
  static bool smem_set = smem <= 48 * 1024;  // this instance's limit raised
  if (!smem_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  dim3 grid(B * KVH, (gt + kMaxRows - 1) / kMaxRows, NS);
  kernel<<<grid, kThreads, smem, stream>>>(q, kd, ks, vd, vs, qpos, table, ws_ml, ws_acc, KVH,
                                           L, hd, t, gt, window, scale, ps, pps, rowbytes, ch);
  return cudaSuccess;
}

template <int CARRIER, bool PAGED>
cudaError_t launch_carrier(const float* q, const uint8_t* kd, const float* ks, const uint8_t* vd,
                           const float* vs, const int* qpos, const int* table, float2* ws_ml,
                           float* ws_acc, int B, int KVH, int L, int hd, int t, int gt, int NS,
                           int window, float scale, int ps, int pps, int rowbytes, int ch,
                           cudaStream_t stream) {
  if (hd <= 8 * kLanesPerKey)
    return launch_span<CARRIER, PAGED, 8>(q, kd, ks, vd, vs, qpos, table, ws_ml, ws_acc, B,
                                          KVH, L, hd, t, gt, NS, window, scale, ps, pps,
                                          rowbytes, ch, stream);
  return launch_span<CARRIER, PAGED, 16>(q, kd, ks, vd, vs, qpos, table, ws_ml, ws_acc, B,
                                         KVH, L, hd, t, gt, NS, window, scale, ps, pps,
                                         rowbytes, ch, stream);
}

template <bool PAGED>
int dispatch(const void* q, const void* kd, const void* ks, const void* vd, const void* vs,
             const void* qpos, const void* table, void* out, void* ws, int B, int KVH, int L,
             int hd, int t, int gt, int window, int carrier, float scale, int ps, int pps,
             void* stream) {
  if (carrier < 0 || carrier > 3 || hd < 1 || hd > 128 || (carrier == 3 && hd % 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int bits = carrier == 0 ? 32 : carrier == 1 ? 16 : carrier == 2 ? 8 : 4;
  const int rowbytes = hd * bits / 8;
  // the widest copy that the row length and both pools' alignment allow
  const int ch = jlt::copy_width((uintptr_t)kd | (uintptr_t)vd | (uintptr_t)rowbytes);
  const int NS = (L + kTile * kTilesPerSpan - 1) / (kTile * kTilesPerSpan);
  float2* ws_ml = static_cast<float2*>(ws);
  float* ws_acc = reinterpret_cast<float*>(ws_ml + (size_t)B * KVH * NS * gt);
  const float* qf = (const float*)q;
  const uint8_t* kb = (const uint8_t*)kd;
  const uint8_t* vb = (const uint8_t*)vd;
  const float* ksf = (const float*)ks;
  const float* vsf = (const float*)vs;
  const int* qp = (const int*)qpos;
  const int* tb = (const int*)table;
  cudaError_t err;
#define JLT_CARRIER(C)                                                                     \
  launch_carrier<C, PAGED>(qf, kb, ksf, vb, vsf, qp, tb, ws_ml, ws_acc, B, KVH, L, hd, t, \
                           gt, NS, window, scale, ps, pps, rowbytes, ch, s)
  switch (carrier) {
    case 0: err = JLT_CARRIER(0); break;
    case 1: err = JLT_CARRIER(1); break;
    case 2: err = JLT_CARRIER(2); break;
    default: err = JLT_CARRIER(3); break;
  }
#undef JLT_CARRIER
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)B * KVH * gt * hd;
  decode_attention_fold_kernel<<<(unsigned)((total + kFoldThreads - 1) / kFoldThreads),
                                 kFoldThreads, 0, s>>>(ws_ml, ws_acc, qp, (float*)out, KVH, L, hd, t, gt,
                                      window, NS, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Keys a span (the workspace holds B * KVH * ceil(L / span) * gt * (2 + hd)
// floats: the states (m, l), then acc).
int jlt_attention_span_keys() { return kTile * kTilesPerSpan; }

// q, out: f32 (B*KVH, gt, hd) contiguous; qpos: int32 (B,) position of the
// first new row per batch entry; window <= 0 means none; ws: the span states
// (jlt_attention_span_keys).  ks/vs are ignored for float carriers.  Two
// launches: the span kernel and the fold.  Returns cudaGetLastError().
int jlt_decode_attention(const void* q, const void* kd, const void* ks, const void* vd,
                         const void* vs, const void* qpos, void* out, void* ws, int B,
                         int KVH, int L, int hd, int t, int gt, int window, int carrier,
                         float scale, void* stream) {
  return dispatch<false>(q, kd, ks, vd, vs, qpos, nullptr, out, ws, B, KVH, L, hd, t, gt,
                         window, carrier, scale, L, 1, stream);
}

// The same over page pools: kd/vd (P, KVH, ps, hd or hd / 2), ks/vs
// (P, KVH, ps), table int32 (B, pps) of pool page ids (the caller keeps them
// below P).  Returns cudaGetLastError().
int jlt_paged_attention(const void* q, const void* kd, const void* ks, const void* vd,
                        const void* vs, const void* qpos, const void* table, void* out,
                        void* ws, int B, int KVH, int ps, int pps, int hd, int t, int gt,
                        int window, int carrier, float scale, void* stream) {
  return dispatch<true>(q, kd, ks, vd, vs, qpos, table, out, ws, B, KVH, ps * pps, hd, t, gt,
                        window, carrier, scale, ps, pps, stream);
}

}  // extern "C"
