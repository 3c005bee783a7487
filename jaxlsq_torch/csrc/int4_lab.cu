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
// Both run mma_bf16.cuh's body (its operands, its order and its two forms):
// wo4_bf16 the split-half layout with x rounded to bf16 once (one MMA pass),
// wo4_native the K-contiguous layout with x split exactly into three bf16
// parts (three passes); slices of 16 k-steps (128 byte rows).
//
// What bounds it on an H100: at decode M the weight bytes (K N / 2) streamed
// once: 10 us for K = N = 8192 at 3.35 TB/s; at prefill M the tensor cores,
// 2 M K N (x3 for wo4_native) at 989 TFLOP/s bf16 (mma.sync reaches part of
// that; wgmma is later work).  The decode form runs up to M = 16 (1 or 2 n8
// tiles), the tiled form (a 128 x 64 tile) above; x traffic from L2 in the
// tiled form is (N / 128) x the bytes of x (256 MiB at M = 128, K = N =
// 8192).
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

namespace mma = jlt::mma;

using Bf16 = mma::Op<mma::kSplitHalf4, 1, 16, false>;    // wo4_bf16
using Native = mma::Op<mma::kNative4, 3, 16, false>;     // wo4_native

template <class F, int NT>
__global__ void __launch_bounds__(mma::kThreads)
lab_decode_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, const int* __restrict__ zp,
                  float* __restrict__ out, int M, int K, int N, int per_channel, int wch) {
  mma::decode_body<F, NT, mma::kDTiles, 8>(x, w, scale, zp, out, M, K, N, per_channel, wch);
}

template <class F>
__global__ void __launch_bounds__(mma::kThreads)
lab_tiled_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, const int* __restrict__ zp,
                 float* __restrict__ out, int M, int K, int N, int per_channel, int xvec,
                 int wch) {
  mma::tiled_body<F, 64>(x, w, scale, zp, out, M, K, N, per_channel, xvec, wch);
}

template <class F>
cudaError_t launch_lab(const float* x, const int8_t* w, const float* scale, float* out, int M,
                       int K, int N, cudaStream_t stream) {
  if (M <= 8)
    return mma::launch_decode<F, 1, mma::kDTiles, 8>(lab_decode_kernel<F, 1>, x, w, scale, nullptr,
                                                  out, M, K, N, 1, stream);
  if (M <= 16)
    return mma::launch_decode<F, 2, mma::kDTiles, 8>(lab_decode_kernel<F, 2>, x, w, scale, nullptr,
                                                  out, M, K, N, 1, stream);
  return mma::launch_tiled<F, 64>(lab_tiled_kernel<F>, x, w, scale, nullptr, out, M, K, N, 1,
                                  stream);
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
    err = launch_lab<Native>(xf, wb, sf, (float*)out, M, K, N, s);
  } else {
    err = launch_lab<Bf16>(xf, wb, sf, (float*)out, M, K, N, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
