// onehot_full: the [6, lanes] one-hot histogram of all rows -- the
// frontier grower's root histogram under force_row_wise, once per tree.
//
// Replaces lightgbm_tpu/ops/histogram.py::_hist_pallas in both of its
// layouts: `kFeatMajor` (kernel_fm) reads a [f, n] transposed copy of the
// bins that the wrapper makes once, as the Pallas path does; `kRowMajor`
// (kernel_rm) reads the [n, ld] matrix as stored and never reads the
// columns past f.  The one-hot body is the variant's (onehot_common.cuh);
// int8 has a kernel of its own, onehot_full_int8_kernel, which reads the
// quantize kernel's q and scales (onehot_quant.cu) through the same
// staging and grid, keeps its int32 sums across a quantization block and
// folds them into float64 shared memory once a block.
//
// It also replaces the shootout shell
// lightgbm_tpu/ops/onehot_variants.py::make_bench_kernel (K4), through its
// own entry point onehot_bench_launch: that shell computes the featmajor
// function over caller-transposed [f, N] bins, one feature block against
// a grid of BR-row blocks -- a TPU artefact with no Hopper counterpart, so
// the entry launches the main path's featmajor kernels on the caller's
// bins and rows as given.
//
// Grid: (row splits, lane blocks), as many CTAs as the card holds at once.
// A CTA owns 512 lanes and a range of whole 128-row chunks, staged through
// cp.async buffers (onehot_common.cuh); it keeps its sums in registers and
// adds them to the zeroed float64 [6, lanes] accumulator once, with
// atomics.  The kernels read grad, hess and mask and split them into the
// bf16 pair themselves.
//
// Bound on an H100: it must read n * f bytes of bins and 12 * n bytes of
// gh once and write 48 * lanes bytes; the tensor cores must do
// 2 * 8 * lanes * n flops (6 of mma's 8 N columns are used) -- at
// n = 1M, lanes = 7168 that is 0.12 ms at 989 TFLOP/s, ten times the bytes'
// time, so the one-hot design is bounded by operations (int8: 2 * 16 *
// lanes * n operations, two n8 tiles for 9 channels, at 1979 TOP/s, the
// same 0.12 ms).  It uses mma.sync (not wgmma) and builds the one-hot
// fragments with integer or bf16 instructions, which take a large part of
// its time and keep it well above that (scripts/torch_onehot_ablation.py).
#include "onehot_common.cuh"

using namespace lgbt_oh;

template <int V, int L>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    onehot_full_kernel(Src S, int f, double* __restrict__ out, int lpf_log2,
                       int lanes, int64_t cps, int nf_max) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lb0 = blockIdx.y * kBlockLanes;
  cta_features(lb0, f, lpf_log2, &S.fa, &S.nf);
  const Geo geo = make_geo(lb0, lanes, f, lpf_log2, S.fa);
  const Ids ids = make_ids(geo.jb);
  double acc[kTiles][4];
  zero_acc(acc);
  const int64_t chunks = (S.n + kChunk - 1) / kChunk;
  const int64_t c0 = (int64_t)blockIdx.x * cps;
  const int64_t c1 = (c0 + cps < chunks) ? c0 + cps : chunks;
  if (c0 < c1)
    run_chunks<V, L>(S, smem, stage_bytes(L, nf_max, S.raw), c0, c1, geo,
                     ids, acc, [](int64_t) { return true; });
  flush(out, acc, lb0, lanes);
}

// The int8 body: q [9, ldq] int8 (ldq = n rounded up to kChunk, zero past
// n) and scales [blocks of cpb chunks, 9] float32.  A CTA's chunk range may
// start and end inside a block: the sums fold by the block of each chunk.
template <int L>
__global__ void __launch_bounds__(kThreads, kInt8MinBlocks)
    onehot_full_int8_kernel(Src S, int f, const int8_t* __restrict__ q,
                            const float* __restrict__ scales, int cpb,
                            double* __restrict__ out, int lpf_log2,
                            int lanes, int64_t cps, int nf_max) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* facc = reinterpret_cast<double*>(smem);
  const int lb0 = blockIdx.y * kBlockLanes;
  cta_features(lb0, f, lpf_log2, &S.fa, &S.nf);
  const Geo geo = make_geo(lb0, lanes, f, lpf_log2, S.fa);
  const Int8Ids ids = make_int8_ids(geo.jb);
  zero_facc(facc);
  const int64_t chunks = (S.n + kChunk - 1) / kChunk;
  const int64_t c0 = (int64_t)blockIdx.x * cps;
  const int64_t c1 = (c0 + cps < chunks) ? c0 + cps : chunks;
  if (c0 < c1)
    run_chunks_int8<L>(S, q, scales, cpb, smem + kFaccBytes,
                       stage_bytes_int8(L, nf_max, S.raw), c0, c1, geo, ids,
                       facc, [](int64_t) { return true; });
  flush_int8(out, facc, lb0, lanes);
}

// What one launch is given (the C entries' arguments).
struct Args {
  int device;
  const void* bins;
  long long ld, n;
  int f;
  const float *g, *h, *m;
  const void* q;              // int8: [9, n]
  const void* scales;         // int8
  int qbr;                    // int8
  void* out;
  int lpf_log2, lanes, nf_max;
  cudaStream_t stream;
};

static bool aligned16(const void* p) { return !((uintptr_t)p & 15); }

template <int V, int L>
static int launch(const Args& a) {
  const long long chunks = (a.n + kChunk - 1) / kChunk;
  // 16-byte copies: the rows, and the feature-major bins' rows, must start
  // 16-byte aligned (and the feature-major bins reach past the last chunk)
  if (!(aligned16(a.g) && aligned16(a.h) && aligned16(a.m)))
    return (int)cudaErrorInvalidValue;
  if (L == kFeatMajor &&
      (!aligned16(a.bins) || a.ld % 16 || a.ld < chunks * kChunk))
    return (int)cudaErrorInvalidValue;
  const bool aligned = aligned16(a.bins);
  const int smem = launch_smem(V, L, a.nf_max, a.ld, aligned);
  auto kern = onehot_full_kernel<V, L>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const int nlb = (a.lanes + kBlockLanes - 1) / kBlockLanes;
  int gx;
  const long long cps =
      split_units(chunks, nlb, resident_ctas(kern, smem, a.device), &gx);
  const Src S{(const uint8_t*)a.bins, (int64_t)a.ld, (int64_t)a.n, a.g, a.h,
              a.m, 0, 0, raw_bytes(L, a.ld, aligned)};
  kern<<<dim3(gx, nlb), kThreads, smem, a.stream>>>(
      S, a.f, (double*)a.out, a.lpf_log2, a.lanes, (int64_t)cps, a.nf_max);
  return (int)cudaGetLastError();
}

template <int L>
static int launch_int8(const Args& a) {
  const long long chunks = (a.n + kChunk - 1) / kChunk;
  // 16-byte copies: q's rows start 16-byte aligned (its row stride is a
  // multiple of kChunk), and so do the feature-major bins' rows, which
  // reach past the last chunk
  if (a.q == nullptr || a.scales == nullptr || a.qbr <= 0 ||
      a.qbr % kChunk != 0 || !aligned16(a.q))
    return (int)cudaErrorInvalidValue;
  if (L == kFeatMajor &&
      (!aligned16(a.bins) || a.ld % 16 || a.ld < chunks * kChunk))
    return (int)cudaErrorInvalidValue;
  const bool aligned = aligned16(a.bins);
  const int smem = launch_smem(kInt8, L, a.nf_max, a.ld, aligned);
  auto kern = onehot_full_int8_kernel<L>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const int nlb = (a.lanes + kBlockLanes - 1) / kBlockLanes;
  int gx;
  const long long cps =
      split_units(chunks, nlb, resident_ctas(kern, smem, a.device), &gx);
  const Src S{(const uint8_t*)a.bins, (int64_t)a.ld, (int64_t)a.n, nullptr,
              nullptr, nullptr, 0, 0, raw_bytes(L, a.ld, aligned)};
  kern<<<dim3(gx, nlb), kThreads, smem, a.stream>>>(
      S, a.f, (const int8_t*)a.q, (const float*)a.scales, a.qbr / kChunk,
      (double*)a.out, a.lpf_log2, a.lanes, (int64_t)cps, a.nf_max);
  return (int)cudaGetLastError();
}

typedef int (*LaunchFn)(const Args&);

// by (variant, layout)
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

// bins: [f, ld] (featmajor: ld a multiple of 16 covering n rounded up to
// 128) or [n, ld] (rowmajor) u8; g, h, m: [n] float32 (grad, hess, mask),
// or for int8 q [9, ldq] int8 (ldq = n rounded up to 128, zero past n)
// with scales [ceil(n / qbr), 9] float32 (g, h and m are not read by
// int8, q, scales and qbr not by the other variants); out: zeroed [6,
// lanes] float64.
extern "C" int onehot_full_launch(int device, const void* bins,
                                  long long ld, long long n, int f,
                                  int layout, const void* g, const void* h,
                                  const void* m, const void* q,
                                  const void* scales, int qbr, void* out,
                                  int variant, int lpf_log2, int lanes,
                                  int nf_max, void* stream) {
  if (variant < 0 || variant >= kNumVariants || layout < 0 || layout > 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Args a{device, bins, ld, n, f, (const float*)g, (const float*)h,
               (const float*)m, q, scales, qbr, out, lpf_log2, lanes,
               nf_max > 0 ? nf_max : 1, (cudaStream_t)stream};
  return kLaunch[variant][layout](a);
}

// The shootout shell's entry (K4): bins_t [f, n] u8 as the caller
// transposed it; rows [3, n] float32, the rows grad, hess and mask (or for
// int8 q [9, n] int8 with its scales per qbr rows: n is q's row stride);
// n a multiple of 128 (and of qbr).  The main path's featmajor kernels.
extern "C" int onehot_bench_launch(int device, const void* bins_t,
                                   long long n, int f, const void* rows,
                                   const void* scales, int qbr, void* out,
                                   int variant, int lpf_log2, int lanes,
                                   int nf_max, void* stream) {
  if (variant < 0 || variant >= kNumVariants || n % kChunk)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const float* r = (const float*)rows;
  const Args a{device, bins_t, n, n, f, r, r + n, r + 2 * n, rows, scales,
               qbr, out, lpf_log2, lanes, nf_max > 0 ? nf_max : 1,
               (cudaStream_t)stream};
  return kLaunch[variant][kFeatMajor](a);
}

template <int V, int L>
static cudaError_t attrs(int smem, int* out) {
  if constexpr (V == kInt8)
    return kernel_attrs(onehot_full_int8_kernel<L>, smem, out);
  else
    return kernel_attrs(onehot_full_kernel<V, L>, smem, out);
}

typedef cudaError_t (*AttrFn)(int, int*);
static const AttrFn kAttrs[kNumVariants][2] = {
    {attrs<kBase, kFeatMajor>, attrs<kBase, kRowMajor>},
    {attrs<kBf16Cmp, kFeatMajor>, attrs<kBf16Cmp, kRowMajor>},
    {attrs<kI16Cmp, kFeatMajor>, attrs<kI16Cmp, kRowMajor>},
    {attrs<kU8Cmp, kFeatMajor>, attrs<kU8Cmp, kRowMajor>},
    {attrs<kSub1Abs, kFeatMajor>, attrs<kSub1Abs, kRowMajor>},
    {attrs<kStaged, kFeatMajor>, attrs<kStaged, kRowMajor>},
    {attrs<kPacked, kFeatMajor>, attrs<kPacked, kRowMajor>},
    {attrs<kInt8, kFeatMajor>, attrs<kInt8, kRowMajor>},
};

// The kernel of (variant, layout): out[0] registers a thread, out[1]
// static shared bytes, out[2] the dynamic shared bytes of a launch with
// nf_max features a CTA (rowmajor: rows of ld bytes, 16-byte aligned),
// out[3] local (spill) bytes a thread, out[4] CTAs an SM at that launch.
extern "C" int onehot_full_query(int variant, int layout, int nf_max,
                                 long long ld, int* out) {
  if (variant < 0 || variant >= kNumVariants || layout < 0 || layout > 1)
    return (int)cudaErrorInvalidValue;
  return (int)kAttrs[variant][layout](
      launch_smem(variant, layout, nf_max > 0 ? nf_max : 1, ld, true), out);
}
