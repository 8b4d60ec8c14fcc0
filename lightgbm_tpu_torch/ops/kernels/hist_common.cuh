// Shared pieces of the two histogram kernels (hist_full.cu, hist_leaves.cu).
//
// A histogram here is, per feature f and bin b, the three sums
// (sum g*m, sum h*m, sum m) over rows whose bin for f is b.  Bins >= B
// match nothing and are dropped.  Each CTA keeps a privatised histogram of
// a group of `fg` features in shared memory, laid out channel-major
// s[(c * fg + f) * B + b] so that the three channel planes are contiguous,
// accumulates rows into it with shared-memory atomics, and flushes it into
// a [.., F, B, 3] accumulator in device memory with global atomics.
//
// Both levels accumulate in float64 and the wrapper rounds the result to
// float32 once.  A float32 sum of ~4,000 gradients per bin (1M rows over
// 256 bins) drifts by ~1e-4 with the summation order when the gradients
// cancel, and atomics have no order; in float64 the drift is ~1e-13, so
// the rounded result is the correctly rounded sum whatever order the
// atomics took -- the same bits as the plain version in practice, which
// keeps trees grown through the kernels identical to the plain path's.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lgbt {

__device__ __forceinline__ void zero_shared(double* s, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) s[i] = 0.0;
}

// Rows [r0, r1) of a row-major u8 matrix (row stride `stride` bytes) into
// the shared histogram of features [f0, f0 + fg).  The channel values are
// the float32 products g*m and h*m (as the plain version forms them),
// widened to float64.  A row whose three values are all exactly zero adds
// nothing and is skipped; a NaN is not zero, so it is accumulated.
__device__ __forceinline__ void accumulate_rows(
    double* s, const uint8_t* __restrict__ bins, int64_t stride,
    const float* __restrict__ g, const float* __restrict__ h,
    const float* __restrict__ m, int64_t r0, int64_t r1, int f0, int fg,
    int B) {
  const int plane = fg * B;
  for (int64_t r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const float w = m[r];
    const float gw = g[r] * w;
    const float hw = h[r] * w;
    if (w == 0.f && gw == 0.f && hw == 0.f) continue;
    const uint8_t* row = bins + r * stride + f0;
    for (int f = 0; f < fg; ++f) {
      const int b = row[f];
      if (b < B) {
        double* p = s + f * B + b;
        atomicAdd(p, (double)gw);
        atomicAdd(p + plane, (double)hw);
        atomicAdd(p + 2 * plane, (double)w);
      }
    }
  }
}

// Add the shared histogram of features [f0, f0 + fg) into `out`, the
// [F, B, 3] float64 accumulator of one slot.  Zero entries are skipped
// (adding zero changes nothing); NaN != 0, so a NaN is flushed into this
// slot.
__device__ __forceinline__ void flush_shared(double* __restrict__ out,
                                             const double* s, int f0, int fg,
                                             int B) {
  const int plane = fg * B;
  for (int i = threadIdx.x; i < 3 * plane; i += blockDim.x) {
    const double v = s[i];
    if (v != 0.0) {
      const int c = i / plane;
      const int fb = i - c * plane;  // f * B + b
      atomicAdd(out + ((int64_t)f0 * B + fb) * 3 + c, v);
    }
  }
}

}  // namespace lgbt

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
