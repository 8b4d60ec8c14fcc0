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
// output.  Where one feature's histogram does not fit a CTA (B above
// ~8,900), the listed design takes the call (hist_common.cuh): the
// pre-pass (hist_lists.cu) lists each (feature, tile of 256 bins)'s rows,
// and hist_full_listed_kernel's warps each add a unit of one list into a
// histogram of their own, writing the float32 output themselves.
//
// Bound on an H100: it must read N * f * esz bytes of bins (esz = 1 for
// u8, 2 for u16) and 12 * N bytes of (g, h, m) once and write F * B * 12
// bytes, so the byte bound is about (f * esz + 12) * N / 3.35 TB/s (0.012
// ms at 1M x 28 u8).  The update has a floor
// of its own: one read-add-write of three float64 values per (row,
// feature), 48 bytes through shared memory at 128 bytes a clock an SM
// (about 0.04 ms at 1M x 28).  The partials add 2 * (grid x) * F * B * 24
// bytes of device-memory traffic (about 45 MB at 1M x 28 with one CTA an
// SM).  The listed design reads each (row, feature) twice in the pre-pass
// and once by its entry (6 bytes of list and a 32-byte sector of g, h, m).
#include "hist_common.cuh"

// T: the bin type (uint8_t or uint16_t); stride in bins; kDealt: the
// design (hist_common.cuh).  Grid (grid_x, groups): CTA (x, y) takes rows
// [x * rows_per_cta, ...) of feature group y.
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

// The listed design (hist_common.cuh::listed_units): a persistent grid
// whose warps take the lists' units; the output is the slot-0 [f, B, 3]
// histogram.
__global__ void __launch_bounds__(32 * lgbt::kListWarps, 3)
    hist_full_listed_kernel(const lgbt::ListedArgs a) {
  lgbt::listed_units(a);
}

// The launch plan of a shape (lgbt::plan_launch's fourteen values); esz
// is the bin type's size (1: u8, 2: u16); design -1 (the plan's choice),
// 0 (owned), 1 (dealt) or 2 (listed).
extern "C" int hist_full_plan(int device, long long stride, int f, int B,
                              int esz, int design, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (esz == 1)
    return (int)lgbt::plan_launch(hist_full_kernel<uint8_t, false>,
                                  hist_full_kernel<uint8_t, true>,
                                  hist_full_listed_kernel, device, stride,
                                  f, B, 1, design, out);
  if (esz == 2)
    return (int)lgbt::plan_launch(hist_full_kernel<uint16_t, false>,
                                  hist_full_kernel<uint16_t, true>,
                                  hist_full_listed_kernel, device, stride,
                                  f, B, 2, design, out);
  return (int)cudaErrorInvalidValue;
}

// The listed design's main kernel over the lists of one call (ptrs: see
// lgbt::launch_listed) of f features into out ([f, B, 3] float32 from the
// lists' first feature); partial holds a [tw][3] float64 sum for each
// segment (only split ones are touched); units = f * the lists' units a
// feature; grid = the plan's CTAs an SM times its SMs.
extern "C" int hist_full_listed_launch(int device, const long long* ptrs,
                                       void* partial, void* out, int f,
                                       int B, int tw_log2, int unit,
                                       int units, int grid, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return (int)lgbt::launch_listed(hist_full_listed_kernel, device, ptrs,
                                  partial, out, f, B, 1, tw_log2, unit, units,
                                  f, grid, (cudaStream_t)stream);
}

// The launch geometry: the plan's feature group, tile rows and threads;
// the CTAs along x and the rows each takes.
struct FullGrid {
  int fg, tile, threads, grid_x;
  long long rows_per_cta;
};

template <typename T, bool kDealt>
static cudaError_t launch_full_as(int device, const void* bins, long long n,
                                  long long stride, int f, int B,
                                  const void* g, const void* h,
                                  const void* m, void* partial,
                                  const FullGrid& q, cudaStream_t s) {
  const int smem = (int)lgbt::smem_bytes(q.fg, B, q.tile, stride, sizeof(T),
                                         kDealt);
  cudaError_t e = lgbt::allow_smem(hist_full_kernel<T, kDealt>, device, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(q.grid_x, (f + q.fg - 1) / q.fg);
  hist_full_kernel<T, kDealt><<<grid, q.threads, smem, s>>>(
      (const T*)bins, n, stride, f, B, (const float*)g, (const float*)h,
      (const float*)m, (double*)partial, q.fg, q.tile, q.rows_per_cta);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_full(int device, const void* bins, long long n,
                               long long stride, int f, int B, const void* g,
                               const void* h, const void* m, void* partial,
                               int design, const FullGrid& q,
                               cudaStream_t s) {
  if (design == 0)
    return launch_full_as<T, false>(device, bins, n, stride, f, B, g, h, m,
                                    partial, q, s);
  if (design == 1)
    return launch_full_as<T, true>(device, bins, n, stride, f, B, g, h, m,
                                   partial, q, s);
  return cudaErrorInvalidValue;
}

// The main kernel over grid_x CTAs (rows_per_cta rows each) by the
// feature groups, then the reduce pass over its grid_x partials ([grid_x,
// f, B, 3] float64) into out ([f, B, 3] float32).  bins holds u8 (esz 1)
// or u16 (esz 2) values, rows of `stride` bins; fg, tile, threads and
// design are the plan's.
extern "C" int hist_full_launch(int device, const void* bins, long long n,
                                long long stride, int f, int B, int esz,
                                const void* g, const void* h, const void* m,
                                void* partial, void* out, int fg, int tile,
                                int threads, int design, int grid_x,
                                long long rows_per_cta, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  const FullGrid q{fg, tile, threads, grid_x, rows_per_cta};
  if (esz == 1)
    e = launch_full<uint8_t>(device, bins, n, stride, f, B, g, h, m, partial,
                             design, q, s);
  else if (esz == 2)
    e = launch_full<uint16_t>(device, bins, n, stride, f, B, g, h, m,
                              partial, design, q, s);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)lgbt::launch_reduce((const double*)partial, nullptr, grid_x,
                                  (long long)f * B * 3, 1, (float*)out, s);
}
