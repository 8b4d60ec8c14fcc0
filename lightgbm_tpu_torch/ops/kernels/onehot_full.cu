// onehot_full: the [6, lanes] one-hot histogram of all rows -- the
// frontier grower's root histogram under force_row_wise, once per tree.
//
// Replaces lightgbm_tpu/ops/histogram.py::_hist_pallas in both of its
// layouts: `kFeatMajor` (kernel_fm) reads a [f, n] transposed copy of the
// bins that the wrapper makes once, as the Pallas path does; `kRowMajor`
// (kernel_rm) reads the [n, ld] matrix as stored and never reads the
// columns past f.  The one-hot body is the variant's (onehot_common.cuh);
// int8 has a kernel of its own, onehot_full_int8_kernel, which reads the
// quantize kernel's q and scales (onehot_quant.cu).
//
// It also replaces the shootout shell
// lightgbm_tpu/ops/onehot_variants.py::make_bench_kernel (K4), through its
// own entry point onehot_bench_launch: that shell computes the featmajor
// function over caller-transposed [f, N] bins, one feature block against
// a grid of BR-row blocks -- a TPU artefact with no Hopper counterpart, so
// the entry launches the featmajor kernels on the caller's bins as given.
//
// Grid: (row splits, lane blocks).  A CTA owns 512 lanes and a range of
// whole 128-row chunks; it keeps its sums in registers and adds them to the
// zeroed float64 [6, lanes] accumulator once, with atomics.
//
// Bound on an H100: it must read n * f bytes of bins and 12 * n bytes of
// gh once and write 48 * lanes bytes; the tensor cores must do
// 2 * 8 * lanes * n flops (6 of mma's 8 N columns are used) -- at
// n = 1M, lanes = 7168 that is 0.12 ms at 989 TFLOP/s, ten times the bytes'
// time, so the one-hot design is bounded by operations.  This simple
// version uses mma.sync (not wgmma) and builds every one-hot element with
// integer or bf16 instructions, which bound it well above that.
#include "onehot_common.cuh"

using namespace lgbt_oh;

template <int V, int L>
__global__ void __launch_bounds__(kThreads)
    onehot_full_kernel(const uint8_t* __restrict__ bins, int64_t ld,
                       int64_t n, int f, const uint16_t* __restrict__ gh,
                       double* __restrict__ out, int lpf_log2, int lanes,
                       int cps) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sg = reinterpret_cast<uint16_t*>(smem);
  uint8_t* sb = smem + kGhBytes;
  const int lb0 = blockIdx.y * kBlockLanes;
  int fa, nf;
  cta_features(lb0, f, lpf_log2, &fa, &nf);
  Lanes lm;
  init_lanes(lm, lb0, lanes, f, lpf_log2, fa);
  zero_gh_padding(sg);
  double acc[kTiles][4];
  zero_acc(acc);
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  const int64_t c0 = (int64_t)blockIdx.x * cps;
  const int64_t c1 = (c0 + cps < chunks) ? c0 + cps : chunks;
  if (c0 < c1)
    accumulate_rows<V, L>(acc, sg, sb, lm, bins, ld, n, fa, nf, gh,
                          c0 * kChunk, c1 * kChunk);
  flush(out, acc, lb0, lanes);
}

// The int8 body: q [9, n] int8 and scales [n / qbr blocks, 9] float32.
template <int L>
__global__ void __launch_bounds__(kThreads)
    onehot_full_int8_kernel(const uint8_t* __restrict__ bins, int64_t ld,
                            int64_t n, int f, const int8_t* __restrict__ q,
                            const float* __restrict__ scales, int qbr,
                            double* __restrict__ out, int lpf_log2,
                            int lanes, int cps) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* facc = reinterpret_cast<double*>(smem);
  uint8_t* sq = smem + kFaccBytes;
  uint8_t* sb = sq + kQBytes;
  const int lb0 = blockIdx.y * kBlockLanes;
  int fa, nf;
  cta_features(lb0, f, lpf_log2, &fa, &nf);
  Lanes lm;
  init_lanes(lm, lb0, lanes, f, lpf_log2, fa);
  zero_q_padding(sq);
  zero_facc(facc);
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  const int64_t c0 = (int64_t)blockIdx.x * cps;
  const int64_t c1 = (c0 + cps < chunks) ? c0 + cps : chunks;
  if (c0 < c1)
    accumulate_rows_int8<L>(facc, sq, sb, lm, bins, ld, n, fa, nf, q, scales,
                            qbr, c0 * kChunk, c1 * kChunk);
  flush_int8(out, facc, lb0, lanes);
}

template <int V, int L>
static int launch(const void* bins, long long ld, long long n, int f,
                  const void* gh, const void* scales, int qbr, void* out,
                  int lpf_log2, int lanes, int cps, int grid_x, int nf_max,
                  cudaStream_t stream) {
  const dim3 grid(grid_x, (lanes + kBlockLanes - 1) / kBlockLanes);
  const int smem = kGhBytes + nf_max * kChunk;
  onehot_full_kernel<V, L><<<grid, kThreads, smem, stream>>>(
      (const uint8_t*)bins, (int64_t)ld, (int64_t)n, f,
      (const uint16_t*)gh, (double*)out, lpf_log2, lanes, cps);
  return (int)cudaGetLastError();
}

template <int L>
static int launch_int8(const void* bins, long long ld, long long n, int f,
                       const void* q, const void* scales, int qbr, void* out,
                       int lpf_log2, int lanes, int cps, int grid_x,
                       int nf_max, cudaStream_t stream) {
  if (scales == nullptr || qbr <= 0 || qbr % kChunk != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x, (lanes + kBlockLanes - 1) / kBlockLanes);
  const int smem = kFaccBytes + kQBytes + nf_max * kChunk;
  onehot_full_int8_kernel<L><<<grid, kThreads, smem, stream>>>(
      (const uint8_t*)bins, (int64_t)ld, (int64_t)n, f, (const int8_t*)q,
      (const float*)scales, qbr, (double*)out, lpf_log2, lanes, cps);
  return (int)cudaGetLastError();
}

typedef int (*LaunchFn)(const void*, long long, long long, int, const void*,
                        const void*, int, void*, int, int, int, int, int,
                        cudaStream_t);

static const LaunchFn kLaunch[kNumVariants][2] = {
    {launch<kBase, kFeatMajor>, launch<kBase, kRowMajor>},
    {launch<kBf16Cmp, kFeatMajor>, launch<kBf16Cmp, kRowMajor>},
    {launch<kI16Cmp, kFeatMajor>, launch<kI16Cmp, kRowMajor>},
    {launch<kU8Cmp, kFeatMajor>, launch<kU8Cmp, kRowMajor>},
    {launch<kSub1Abs, kFeatMajor>, launch<kSub1Abs, kRowMajor>},
    {launch<kStaged, kFeatMajor>, launch<kStaged, kRowMajor>},
    {launch<kPacked, kFeatMajor>, launch<kPacked, kRowMajor>},
    {launch_int8<kFeatMajor>, launch_int8<kRowMajor>},
};

// bins: [f, ld] (featmajor) or [n, ld] (rowmajor) u8; gh: [6, n] bf16, or
// for int8 q [9, n] int8 with scales [ceil(n / qbr), 9] float32 (scales
// and qbr are not read by the other variants); out: zeroed [6, lanes]
// float64.  cps: 128-row chunks per CTA.
extern "C" int onehot_full_launch(int device, const void* bins,
                                  long long ld, long long n, int f,
                                  int layout, const void* gh,
                                  const void* scales, int qbr, void* out,
                                  int variant, int lpf_log2, int lanes,
                                  int nf_max, int cps, int grid_x,
                                  void* stream) {
  if (variant < 0 || variant >= kNumVariants || layout < 0 || layout > 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return kLaunch[variant][layout](bins, ld, n, f, gh, scales, qbr, out,
                                  lpf_log2, lanes, cps, grid_x,
                                  nf_max > 0 ? nf_max : 1,
                                  (cudaStream_t)stream);
}

// The shootout shell's entry (K4): bins_t [f, n] u8 as the caller
// transposed it, gh (or q and scales per qbr rows, n a multiple of qbr) as
// the variant's prep made it; the featmajor kernels.
extern "C" int onehot_bench_launch(int device, const void* bins_t,
                                   long long n, int f, const void* gh,
                                   const void* scales, int qbr, void* out,
                                   int variant, int lpf_log2, int lanes,
                                   int nf_max, int cps, int grid_x,
                                   void* stream) {
  return onehot_full_launch(device, bins_t, n, n, f, kFeatMajor, gh, scales,
                            qbr, out, variant, lpf_log2, lanes, nf_max, cps,
                            grid_x, stream);
}
