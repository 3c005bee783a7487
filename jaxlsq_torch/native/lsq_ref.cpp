// Native (host C++) reference implementation of the LSQ/LSQ+ fake-quant math.
//
// The PyTorch port's copy of jaxlsq/native/lsq_ref.cpp (the same code): an
// independent second oracle for the port's golden model
// (jaxlsq_torch/core/golden.py) and its CUDA fake-quant kernels, plus a
// zero-dependency host-side quantizer for offline weight packing.  It
// implements the equations of SURVEY.md §0 (the contract carried over from
// the reference's torchlsq/csrc/ops/kernels/lsq_kernel.h) from scratch:
// fresh structure (single C API, fused backward with accumulated reductions,
// one code path for per-tensor and per-channel via a channel-stride layout)
// rather than a translation of the reference's TensorIterator loops.
//
// Rounding contract: std::nearbyint under the default FP environment is
// round-half-to-even, matching torch.round (SURVEY.md §7 "hard parts" #2).
//
// Layout contract: x is contiguous with logical shape (outer, C, inner)
// flattened to n = outer*C*inner elements; channel(i) = (i / inner) % C.
// Per-tensor is the degenerate C = 1, inner = 1.
//
// Build: g++ -O3 -shared -fPIC (see jaxlsq_torch/native/build.py); OpenMP
// where the toolchain has it.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

struct LsqParams {
  double qmin;
  double qmax;
  double tmin;
  double tmax;
  double grad_scaler;   // fully resolved multiplier (host precomputes
                        // user_scaler / sqrt(N*qmax[/C]) when grad scaling on)
  int32_t symmetric;    // dB == 0
  int32_t eval_mode;    // plain FakeQuantize backward: STE dX, dS = dB = 0
  int32_t init_mode;    // LSQ+ backprop-init: identity fwd, MSE grads
};

static inline float clamp_scale(float s) {
  const float eps = 1.1920928955078125e-07f;  // FLT_EPSILON
  return std::max(std::fabs(s), eps);
}

static inline float zero_point(float s, float b, const LsqParams* p) {
  double zp = -static_cast<double>(b) / static_cast<double>(s);
  zp = std::min(std::max(zp, p->tmin), p->tmax);
  return static_cast<float>(std::nearbyint(zp));
}

// out = init_mode ? x : (nearbyint(clamp(x/s + zp, qmin, qmax)) - zp) * s
void lsq_forward_f32(const float* x, const float* scale, const float* shift,
                     float* out, int64_t n, int64_t channels, int64_t inner,
                     const LsqParams* p) {
  if (p->init_mode) {
    std::memcpy(out, x, sizeof(float) * static_cast<size_t>(n));
    return;
  }
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const int64_t c = (i / inner) % channels;
    const float s = clamp_scale(scale[c]);
    const float zp = zero_point(s, shift[c], p);
    float xq = x[i] / s + zp;
    xq = std::min(std::max(xq, static_cast<float>(p->qmin)),
                  static_cast<float>(p->qmax));
    out[i] = (static_cast<float>(std::nearbyint(xq)) - zp) * s;
  }
}

// Fused backward: dx elementwise + ds/db reduced per channel in one pass.
// ds/db must be zero-initialized float[channels] by the caller.
void lsq_backward_f32(const float* grad, const float* x, const float* scale,
                      const float* shift, float* dx, float* ds, float* db,
                      int64_t n, int64_t channels, int64_t inner,
                      const LsqParams* p) {
  const float qmin = static_cast<float>(p->qmin);
  const float qmax = static_cast<float>(p->qmax);
  const float gsc = static_cast<float>(p->grad_scaler);

  // Per-channel partial accumulation in double for reduction robustness; the
  // channel count is small so the buffers are negligible.
#pragma omp parallel
  {
#if defined(_OPENMP)
    const int tid = omp_get_thread_num();
    const int nthreads = omp_get_num_threads();
#else
    const int tid = 0;
    const int nthreads = 1;
#endif
    const int64_t chunk = (n + nthreads - 1) / nthreads;
    const int64_t lo = tid * chunk;
    const int64_t hi = std::min(n, lo + chunk);

    double* ds_acc = new double[channels]();
    double* db_acc = new double[channels]();

    for (int64_t i = lo; i < hi; ++i) {
      const int64_t c = (i / inner) % channels;
      const float s = clamp_scale(scale[c]);
      const float zp = zero_point(s, shift[c], p);
      const float xq_raw = x[i] / s + zp;
      const float xq = std::min(std::max(xq_raw, qmin), qmax);
      const bool in_range = (qmin < xq) && (xq < qmax);  // strict mask

      const float g = grad[i];
      dx[i] = p->init_mode ? g : (in_range ? g : 0.0f);
      if (p->eval_mode) continue;  // STE only: dS = dB = 0

      const float xfq = (static_cast<float>(std::nearbyint(xq)) - zp) * s;
      const float geff = p->init_mode ? 2.0f * (xfq - x[i]) : g;
      if (!p->symmetric && !in_range) db_acc[c] += geff;
      if (in_range) {
        ds_acc[c] += geff * (xfq - x[i]) / s;
      } else if (xq <= qmin) {
        ds_acc[c] += geff * (qmin - zp);
      } else {
        ds_acc[c] += geff * (qmax - zp);
      }
    }

#pragma omp critical
    {
      for (int64_t c = 0; c < channels; ++c) {
        ds[c] += static_cast<float>(ds_acc[c] * gsc);
        db[c] += static_cast<float>(db_acc[c] * gsc);
      }
    }
    delete[] ds_acc;
    delete[] db_acc;
  }
}

// Quantize-and-pack for the serving path: q = round(clamp(w/s + zp, qmin,
// qmax)) as int8 (pack.quantize_weight host fallback / oracle).
void lsq_quantize_i8(const float* w, const float* scale, const float* shift,
                     int8_t* out, int64_t n, int64_t channels, int64_t inner,
                     const LsqParams* p) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const int64_t c = (i / inner) % channels;
    const float s = clamp_scale(scale[c]);
    const float zp = zero_point(s, shift[c], p);
    float xq = w[i] / s + zp;
    xq = std::min(std::max(xq, static_cast<float>(p->qmin)),
                  static_cast<float>(p->qmax));
    out[i] = static_cast<int8_t>(std::nearbyint(xq));
  }
}

int lsq_native_abi_version() { return 1; }

}  // extern "C"
