// hist_full: the [F, B, 3] histogram of all rows of a row-major u8 or u16
// bin matrix -- the frontier grower's root histogram, once per tree.
//
// Replaces lightgbm_tpu/ops/histogram.py::_hist_pallas (feature-major
// branch, kernel_fm), which builds the same sums as a bf16 (hi, lo) one-hot
// matmul over a transposed [f, N] copy of the bins.  Here there is no
// one-hot and no transpose: each CTA takes a contiguous stretch of rows of
// the [N, stride] matrix as stored, stages it tile by tile, and adds it
// into a float64 shared-memory histogram of its feature group -- each
// warp owning whole features, or, at wide bins, all warps dealt (step,
// feature) items whose lanes a warp sort groups by bin (hist_common.cuh);
// it writes that histogram once into its float64 partial, and
// hist_reduce_kernel sums the partials in a fixed order into the float32
// output.
//
// Bound on an H100: it must read N * f * esz bytes of bins (esz = 1 for
// u8, 2 for u16) and 12 * N bytes of (g, h, m) once and write F * B * 12
// bytes, so the byte bound is about (f * esz + 12) * N / 3.35 TB/s (0.012
// ms at 1M x 28 u8).  The update has a floor
// of its own: one read-add-write of three float64 values per (row,
// feature), 48 bytes through shared memory at 128 bytes a clock an SM
// (about 0.04 ms at 1M x 28).  The partials add 2 * (grid x) * F * B * 24
// bytes of device-memory traffic (about 45 MB at 1M x 28 with one CTA an
// SM).
#include "hist_common.cuh"

// T: the bin type (uint8_t or uint16_t); stride in bins; kDealt: the
// design (hist_common.cuh).
template <typename T, bool kDealt>
__global__ void __launch_bounds__(kDealt ? 32 * lgbt::kDealtWarps : 1024)
    hist_full_kernel(const T* __restrict__ bins, long long n,
                     long long stride, int f, int B,
                     const float* __restrict__ g, const float* __restrict__ h,
                     const float* __restrict__ m, double* __restrict__ partial,
                     int fg, int tile, long long rows_per_cta) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int f0 = blockIdx.y * fg;
  const int fgc = min(fg, f - f0);
  const lgbt::Smem sm = lgbt::carve<kDealt>(smem, fgc, B);
  const int esz = (int)sizeof(T);
  const lgbt::Stage st = lgbt::stage_of(tile, stride * esz, fg * esz);
  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  const long long r1 = min(n, r0 + rows_per_cta);
  lgbt::zero_hist(sm.hist, 3 * fgc * B);
  const lgbt::Rows src{reinterpret_cast<const uint8_t*>(bins), stride * esz,
                        esz, g, h, m};
  uint32_t ring = 0;
  lgbt::accumulate_rows<T, kDealt>(sm, st, src, r0, r1, f0, fgc, B, ring);
  __syncthreads();
  lgbt::write_partial(partial + ((long long)blockIdx.x * f + f0) * B * 3,
                      sm.hist, 3 * fgc * B);
}

// The launch plan of a shape (lgbt::plan_launch's eleven values); esz is
// the bin type's size (1: u8, 2: u16); design -1 (the plan's choice), 0
// (owned) or 1 (dealt).
extern "C" int hist_full_plan(int device, long long stride, int f, int B,
                              int esz, int design, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (esz == 1)
    return (int)lgbt::plan_launch(hist_full_kernel<uint8_t, false>,
                                  hist_full_kernel<uint8_t, true>, device,
                                  stride, f, B, 1, design, out);
  if (esz == 2)
    return (int)lgbt::plan_launch(hist_full_kernel<uint16_t, false>,
                                  hist_full_kernel<uint16_t, true>, device,
                                  stride, f, B, 2, design, out);
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool kDealt>
static cudaError_t launch_full_as(int device, const void* bins, long long n,
                                  long long stride, int f, int B,
                                  const void* g, const void* h,
                                  const void* m, void* partial, int fg,
                                  int tile, int threads, int grid_x,
                                  long long rows_per_cta, cudaStream_t s) {
  const int smem =
      (int)lgbt::smem_bytes(fg, B, tile, stride, sizeof(T), kDealt);
  cudaError_t e = lgbt::allow_smem(hist_full_kernel<T, kDealt>, device, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(grid_x, (f + fg - 1) / fg);
  hist_full_kernel<T, kDealt><<<grid, threads, smem, s>>>(
      (const T*)bins, n, stride, f, B, (const float*)g, (const float*)h,
      (const float*)m, (double*)partial, fg, tile, rows_per_cta);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_full(int device, const void* bins, long long n,
                               long long stride, int f, int B, const void* g,
                               const void* h, const void* m, void* partial,
                               int fg, int tile, int threads, int design,
                               int grid_x, long long rows_per_cta,
                               cudaStream_t s) {
  if (design == 0)
    return launch_full_as<T, false>(device, bins, n, stride, f, B, g, h, m,
                                    partial, fg, tile, threads, grid_x,
                                    rows_per_cta, s);
  if (design == 1)
    return launch_full_as<T, true>(device, bins, n, stride, f, B, g, h, m,
                                   partial, fg, tile, threads, grid_x,
                                   rows_per_cta, s);
  return cudaErrorInvalidValue;
}

// The main kernel over grid_x CTAs (rows_per_cta rows each) and the
// feature groups, then the reduce pass over its grid_x partials
// ([grid_x, f, B, 3] float64) into out ([f, B, 3] float32).  bins holds
// u8 (esz 1) or u16 (esz 2) values, rows of `stride` bins; fg, tile,
// threads and design are the plan's.
extern "C" int hist_full_launch(int device, const void* bins, long long n,
                                long long stride, int f, int B, int esz,
                                const void* g, const void* h, const void* m,
                                void* partial, void* out, int fg, int tile,
                                int threads, int design, int grid_x,
                                long long rows_per_cta, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  if (esz == 1)
    e = launch_full<uint8_t>(device, bins, n, stride, f, B, g, h, m, partial,
                             fg, tile, threads, design, grid_x, rows_per_cta,
                             s);
  else if (esz == 2)
    e = launch_full<uint16_t>(device, bins, n, stride, f, B, g, h, m,
                              partial, fg, tile, threads, design, grid_x,
                              rows_per_cta, s);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)lgbt::launch_reduce((const double*)partial, nullptr, grid_x,
                                  (long long)f * B * 3, 1, (float*)out, s);
}
