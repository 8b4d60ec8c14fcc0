// hist_full: the [F, B, 3] histogram of all rows of a row-major u8 bin
// matrix -- the frontier grower's root histogram, once per tree.
//
// Replaces lightgbm_tpu/ops/histogram.py::_hist_pallas (feature-major
// branch, kernel_fm), which builds the same sums as a bf16 (hi, lo) one-hot
// matmul over a transposed [f, N] copy of the bins.  Here there is no
// one-hot and no transpose: each CTA reads its own contiguous stretch of
// rows of the [N, stride] matrix as stored and scatters them into a
// float64 shared-memory histogram of its feature group (gridDim.y splits
// the features when F * B * 24 bytes exceeds the shared-memory budget the
// wrapper chose), then flushes with float64 global atomics into the zeroed
// accumulator, which the wrapper rounds to float32.
//
// Bound on an H100: it must read N * f bytes of bins and 12 * N bytes of
// (g, h, m) once, so the memory bound is (f + 12) * N / 3.35 TB/s; this
// simple version is limited by shared-memory atomics instead (3 per row and
// feature, float64), and by the flush (3 * F * B global atomics per CTA).
#include "hist_common.cuh"

__global__ void hist_full_kernel(const uint8_t* __restrict__ bins, int64_t n,
                                 int stride, int f, int B,
                                 const float* __restrict__ g,
                                 const float* __restrict__ h,
                                 const float* __restrict__ m,
                                 double* __restrict__ out, int fg) {
  extern __shared__ double s[];
  const int f0 = blockIdx.y * fg;
  const int fgc = min(fg, f - f0);
  lgbt::zero_shared(s, 3 * fgc * B);
  __syncthreads();
  const int64_t per_cta = (n + gridDim.x - 1) / gridDim.x;
  const int64_t r0 = (int64_t)blockIdx.x * per_cta;
  const int64_t r1 = (r0 + per_cta < n) ? r0 + per_cta : n;
  lgbt::accumulate_rows(s, bins, stride, g, h, m, r0, r1, f0, fgc, B);
  __syncthreads();
  lgbt::flush_shared(out, s, f0, fgc, B);
}

extern "C" int hist_full_launch(int device, const void* bins, long long n,
                                int stride, int f, int B, const void* g,
                                const void* h, const void* m, void* out,
                                int fg, int grid_x, int threads,
                                void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)3 * fg * B * sizeof(double);
  e = cudaFuncSetAttribute(hist_full_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(grid_x, (f + fg - 1) / fg);
  hist_full_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)bins, (int64_t)n, stride, f, B, (const float*)g,
      (const float*)h, (const float*)m, (double*)out, fg);
  return (int)cudaGetLastError();
}
