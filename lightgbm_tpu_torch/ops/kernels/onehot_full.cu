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
// Bins are u8 or u16 (the template's T; u16 serves base, i16cmp, staged
// and int8, the bodies the JAX package admits above 256 bins).  At u16
// widths (Bp = 384 .. 4,096 and beyond) a CTA's 512 lanes hold parts of
// one or two features, so each CTA stages one or two features' bins a
// chunk and the grid has f * Bp / 512 lane blocks.
//
// Bound on an H100: it must read n * f bins (1 or 2 bytes each) and 12 * n
// bytes of gh once and write 48 * lanes bytes; the tensor cores must do
// 2 * 8 * lanes * n flops (6 of mma's 8 N columns are used) -- at
// n = 1M, lanes = 7168 that is 0.12 ms at 989 TFLOP/s, ten times the bytes'
// time, so the one-hot design is bounded by operations (int8: 2 * 16 *
// lanes * n operations, two n8 tiles for 9 channels, at 1979 TOP/s, the
// same 0.12 ms); at B = 1,024 (lanes = 28,672) 0.46 ms.  It uses mma.sync
// (not wgmma) and builds the one-hot fragments with integer or bf16
// instructions, which take a large part of its time and keep it well
// above that (scripts/torch_onehot_ablation.py).
//
// At u16 widths the dense design's work grows with Bp, and the bucketed
// design (onehot_bucket.cuh: rows sorted by their 128-lane bucket, each
// warp multiplying only its bucket's rows) replaces it on the main path
// (onehot_full_bucket_kernel, every u16 body at every width; int8 over
// quantization blocks under 512 rows in a kernel of its own, kInt8Span,
// whose segments of 512 rows span the blocks; histogram.onehot_plan).  It
// gathers each CTA's feature from the rows itself, so the wrapper hands it
// the matrix as stored in both layouts (no transposed copy); K4's entry
// hands it the caller's transposed bins.  The design argument of the
// entries picks (0 dense, 1 bucketed; bucketed serves u16 bins only).
#include "onehot_bucket.cuh"

using namespace lgbt_oh;

template <int V, int L, typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    onehot_full_kernel(Src S, int f, double* __restrict__ out, int lpf,
                       int lpf_log2, int lanes, int64_t cps, int nf_max) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lb0 = blockIdx.y * kBlockLanes;
  cta_features<T>(lb0, f, lpf, lpf_log2, &S.fa, &S.nf);
  const Geo geo = make_geo<T>(lb0, lanes, f, lpf, lpf_log2, S.fa);
  const Ids ids = make_ids(geo.jb);
  double acc[kTiles][4];
  zero_acc(acc);
  const int64_t chunks = (S.n + kChunk - 1) / kChunk;
  const int64_t c0 = (int64_t)blockIdx.x * cps;
  const int64_t c1 = (c0 + cps < chunks) ? c0 + cps : chunks;
  if (c0 < c1)
    run_chunks<V, L, T>(S, smem, stage_bytes(L, nf_max, S.raw, sizeof(T)),
                        c0, c1, geo, ids, acc, [](int64_t) { return true; });
  flush(out, acc, lb0, lanes);
}

// The int8 body: q [9, ldq] int8 (ldq = n rounded up to kChunk, zero past
// n) and scales [blocks of cpb chunks, 9] float32.  A CTA's chunk range may
// start and end inside a block: the sums fold by the block of each chunk.
template <int L, typename T>
__global__ void __launch_bounds__(kThreads, kInt8MinBlocks)
    onehot_full_int8_kernel(Src S, int f, const int8_t* __restrict__ q,
                            const float* __restrict__ scales, int cpb,
                            double* __restrict__ out, int lpf,
                            int lpf_log2, int lanes, int64_t cps,
                            int nf_max) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* facc = reinterpret_cast<double*>(smem);
  const int lb0 = blockIdx.y * kBlockLanes;
  cta_features<T>(lb0, f, lpf, lpf_log2, &S.fa, &S.nf);
  const Geo geo = make_geo<T>(lb0, lanes, f, lpf, lpf_log2, S.fa);
  const Int8Ids ids = make_int8_ids(geo.jb);
  zero_facc(facc);
  const int64_t chunks = (S.n + kChunk - 1) / kChunk;
  const int64_t c0 = (int64_t)blockIdx.x * cps;
  const int64_t c1 = (c0 + cps < chunks) ? c0 + cps : chunks;
  if (c0 < c1)
    run_chunks_int8<L, T>(S, q, scales, cpb, smem + kFaccBytes,
                          stage_bytes_int8(L, nf_max, S.raw, sizeof(T)), c0,
                          c1, geo, ids, facc, [](int64_t) { return true; });
  flush_int8(out, facc, lb0, lanes);
}

// The bucketed design over u16 bins: grid (row splits, f * gpf), CTA y
// owning feature y / gpf and the buckets from (y % gpf) * bpg; a CTA's
// chunk range may start and end inside a quantization block of cpb chunks
// (int8, whose segments it cuts; kInt8Span: blocks of cpb < kSegChunks
// chunks, which its segments span; the bf16 bodies pass a cpb no range
// reaches).  out: zeroed [3, lanes] float64.
template <int V, int L>
__global__ void __launch_bounds__(kBThreads, kBMinBlocks)
    onehot_full_bucket_kernel(BSrc S, double* __restrict__ out, int nb,
                              int gpf, int bpg, int lanes, int64_t cps,
                              int cpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int fa = blockIdx.y / gpf, b0 = (blockIdx.y % gpf) * bpg;
  const int nbc = min(bpg, nb - b0);
  const int64_t chunks = (S.n + kChunk - 1) / kChunk;
  const int64_t c0 = (int64_t)blockIdx.x * cps;
  const int64_t c1 = (c0 + cps < chunks) ? c0 + cps : chunks;
  const int64_t lane0 = ((int64_t)fa * nb + b0) * kWarpLanes;
  if constexpr (V == kInt8Span) {
    const Segs G{c1, 1 << 30, nullptr, 0};
    bucket_cta_int8<L>(smem, S, G, cpb, c0, fa, b0, nbc, out, lane0, lanes,
                       0);
  } else {
    const Segs G{c1, cpb, nullptr, 0};
    bucket_cta<V, L>(smem, S, G, c0, fa, b0, nbc, out, lane0, lanes, 0);
  }
}

// What one launch is given (the C entries' arguments).
struct Args {
  int device;
  const void* bins;
  long long ld, n;            // ld in bins
  int f;
  const float *g, *h, *m;
  const void* q;              // int8: [9, n]
  const void* scales;         // int8
  int qbr;                    // int8
  void* out;
  int lpf, lanes, nf_max;
  cudaStream_t stream;
};

static bool aligned16(const void* p) { return !((uintptr_t)p & 15); }

// the feature-major bins' rows start 16-byte aligned and reach past the
// last chunk (the kernels copy whole chunks in 16-byte pieces)
template <typename T>
static bool featmajor_ok(const Args& a, long long chunks) {
  return aligned16(a.bins) && (a.ld * (long long)sizeof(T)) % 16 == 0 &&
         a.ld >= chunks * kChunk;
}

template <int V, int L, typename T>
static int launch(const Args& a) {
  const long long chunks = (a.n + kChunk - 1) / kChunk;
  // 16-byte copies: the rows, and the feature-major bins' rows, must start
  // 16-byte aligned
  if (!(aligned16(a.g) && aligned16(a.h) && aligned16(a.m)))
    return (int)cudaErrorInvalidValue;
  if (L == kFeatMajor && !featmajor_ok<T>(a, chunks))
    return (int)cudaErrorInvalidValue;
  const bool aligned = aligned16(a.bins);
  const int smem = launch_smem(V, L, a.nf_max, a.ld, aligned, sizeof(T));
  auto kern = onehot_full_kernel<V, L, T>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const int nlb = (a.lanes + kBlockLanes - 1) / kBlockLanes;
  int gx;
  const long long cps =
      split_units(chunks, nlb, resident_ctas(kern, smem, a.device), &gx);
  const Src S{(const uint8_t*)a.bins, (int64_t)a.ld, (int64_t)a.n, a.g, a.h,
              a.m, 0, 0, raw_bytes(L, a.ld, aligned, sizeof(T))};
  kern<<<dim3(gx, nlb), kThreads, smem, a.stream>>>(
      S, a.f, (double*)a.out, a.lpf, ilog2(a.lpf), a.lanes, (int64_t)cps,
      a.nf_max);
  return (int)cudaGetLastError();
}

template <int L, typename T>
static int launch_int8(const Args& a) {
  const long long chunks = (a.n + kChunk - 1) / kChunk;
  // 16-byte copies: q's rows start 16-byte aligned (its row stride is a
  // multiple of kChunk), and so do the feature-major bins' rows, which
  // reach past the last chunk
  if (a.q == nullptr || a.scales == nullptr || a.qbr <= 0 ||
      a.qbr % kChunk != 0 || !aligned16(a.q))
    return (int)cudaErrorInvalidValue;
  if (L == kFeatMajor && !featmajor_ok<T>(a, chunks))
    return (int)cudaErrorInvalidValue;
  const bool aligned = aligned16(a.bins);
  const int smem = launch_smem(kInt8, L, a.nf_max, a.ld, aligned, sizeof(T));
  auto kern = onehot_full_int8_kernel<L, T>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const int nlb = (a.lanes + kBlockLanes - 1) / kBlockLanes;
  int gx;
  const long long cps =
      split_units(chunks, nlb, resident_ctas(kern, smem, a.device), &gx);
  const Src S{(const uint8_t*)a.bins, (int64_t)a.ld, (int64_t)a.n, nullptr,
              nullptr, nullptr, 0, 0, raw_bytes(L, a.ld, aligned, sizeof(T))};
  kern<<<dim3(gx, nlb), kThreads, smem, a.stream>>>(
      S, a.f, (const int8_t*)a.q, (const float*)a.scales, a.qbr / kChunk,
      (double*)a.out, a.lpf, ilog2(a.lpf), a.lanes, (int64_t)cps,
      a.nf_max);
  return (int)cudaGetLastError();
}

// The bucketed kernel of body V (int8 asks for kInt8Span over blocks under
// kSegChunks chunks)
template <int V, int L>
static int run_bucket(const Args& a, long long chunks) {
  if (L == kFeatMajor && !featmajor_ok<uint16_t>(a, chunks))
    return (int)cudaErrorInvalidValue;
  if (a.lpf % kWarpLanes != 0) return (int)cudaErrorInvalidValue;
  const BucketGeo bg = bucket_geo(a.lpf);
  const int nlb = a.f * bg.gpf;
  if (nlb > 65535) return (int)cudaErrorInvalidValue;
  constexpr int smem = bucket_smem<V>();
  auto kern = onehot_full_bucket_kernel<V, L>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  int gx;
  const long long cps = split_units(
      chunks, nlb, resident_ctas(kern, smem, a.device, kBThreads),
      &gx);
  const BSrc S{(const uint16_t*)a.bins, (int64_t)a.ld, (int64_t)a.n,
               a.g, a.h, a.m, (const int8_t*)a.q,
               (int64_t)(chunks * kChunk), (const float*)a.scales};
  kern<<<dim3(gx, nlb), kBThreads, smem, a.stream>>>(
      S, (double*)a.out, bg.nb, bg.gpf, bg.bpg, a.lanes, (int64_t)cps,
      int8_rows(V) ? a.qbr / kChunk : (1 << 30));
  return (int)cudaGetLastError();
}

template <int V, int L>
static int launch_bucket(const Args& a) {
  const long long chunks = (a.n + kChunk - 1) / kChunk;
  if constexpr (V == kInt8) {
    if (a.q == nullptr || a.scales == nullptr || a.qbr <= 0 ||
        a.qbr % kChunk != 0 || !aligned16(a.q))
      return (int)cudaErrorInvalidValue;
    if (a.qbr / kChunk < kSegChunks)
      return run_bucket<kInt8Span, L>(a, chunks);
  } else if (!(aligned16(a.g) && aligned16(a.h) && aligned16(a.m))) {
    return (int)cudaErrorInvalidValue;
  }
  return run_bucket<V, L>(a, chunks);
}

// a body with no u16 instantiation (bf16cmp, u8cmp, sub1abs, packed: the
// JAX package admits them at B <= 256 only)
static int refuse(const Args&) { return (int)cudaErrorInvalidValue; }

typedef int (*LaunchFn)(const Args&);

// by (bin bytes - 1, variant, layout)
static const LaunchFn kLaunch[2][kNumVariants][2] = {
    {{launch<kBase, kFeatMajor, uint8_t>, launch<kBase, kRowMajor, uint8_t>},
     {launch<kBf16Cmp, kFeatMajor, uint8_t>,
      launch<kBf16Cmp, kRowMajor, uint8_t>},
     {launch<kI16Cmp, kFeatMajor, uint8_t>,
      launch<kI16Cmp, kRowMajor, uint8_t>},
     {launch<kU8Cmp, kFeatMajor, uint8_t>, launch<kU8Cmp, kRowMajor, uint8_t>},
     {launch<kSub1Abs, kFeatMajor, uint8_t>,
      launch<kSub1Abs, kRowMajor, uint8_t>},
     {launch<kStaged, kFeatMajor, uint8_t>,
      launch<kStaged, kRowMajor, uint8_t>},
     {launch<kPacked, kFeatMajor, uint8_t>,
      launch<kPacked, kRowMajor, uint8_t>},
     {launch_int8<kFeatMajor, uint8_t>, launch_int8<kRowMajor, uint8_t>}},
    {{launch<kBase, kFeatMajor, uint16_t>,
      launch<kBase, kRowMajor, uint16_t>},
     {refuse, refuse},
     {launch<kI16Cmp, kFeatMajor, uint16_t>,
      launch<kI16Cmp, kRowMajor, uint16_t>},
     {refuse, refuse},
     {refuse, refuse},
     {launch<kStaged, kFeatMajor, uint16_t>,
      launch<kStaged, kRowMajor, uint16_t>},
     {refuse, refuse},
     {launch_int8<kFeatMajor, uint16_t>, launch_int8<kRowMajor, uint16_t>}},
};

// the bucketed design (u16 bins), by (variant, layout)
static const LaunchFn kBucket[kNumVariants][2] = {
    {launch_bucket<kBase, kFeatMajor>, launch_bucket<kBase, kRowMajor>},
    {refuse, refuse},
    {launch_bucket<kI16Cmp, kFeatMajor>, launch_bucket<kI16Cmp, kRowMajor>},
    {refuse, refuse},
    {refuse, refuse},
    {launch_bucket<kStaged, kFeatMajor>, launch_bucket<kStaged, kRowMajor>},
    {refuse, refuse},
    {launch_bucket<kInt8, kFeatMajor>, launch_bucket<kInt8, kRowMajor>},
};

// The launch of (design, bin bytes, variant, layout); design 1 (bucketed)
// serves u16 bins only
static int dispatch(const Args& a, int design, int esz, int variant,
                    int layout) {
  if (design == 1)
    return esz == 2 ? kBucket[variant][layout](a)
                    : (int)cudaErrorInvalidValue;
  return kLaunch[esz - 1][variant][layout](a);
}

// bins: [f, ld] (featmajor: rows of a multiple of 16 bytes covering n
// rounded up to 128) or [n, ld] (rowmajor) of esz-byte bins (1: u8, 2:
// u16); g, h, m: [n] float32 (grad, hess, mask), or for int8 q [9, ldq]
// int8 (ldq = n rounded up to 128, zero past n) with scales [ceil(n /
// qbr), 9] float32 (g, h and m are not read by int8, q, scales and qbr
// not by the other variants); lpf: the lanes of one feature; design: 0
// dense, 1 bucketed; out: zeroed [6, lanes] float64 (bucketed: [3,
// lanes], hi + lo).
extern "C" int onehot_full_launch(int device, const void* bins,
                                  long long ld, long long n, int f,
                                  int layout, int esz, const void* g,
                                  const void* h, const void* m,
                                  const void* q, const void* scales, int qbr,
                                  void* out, int variant, int lpf, int lanes,
                                  int nf_max, int design, void* stream) {
  if (variant < 0 || variant >= kNumVariants || layout < 0 || layout > 1 ||
      esz < 1 || esz > 2 || lpf <= 0 || design < 0 || design > 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Args a{device, bins, ld, n, f, (const float*)g, (const float*)h,
               (const float*)m, q, scales, qbr, out, lpf, lanes,
               nf_max > 0 ? nf_max : 1, (cudaStream_t)stream};
  return dispatch(a, design, esz, variant, layout);
}

// The shootout shell's entry (K4): bins_t [f, n] u8 or u16 (esz bytes) as
// the caller transposed it; rows [3, n] float32, the rows grad, hess and
// mask (or for int8 q [9, n] int8 with its scales per qbr rows: n is q's
// row stride); n a multiple of 128 (and of qbr).  The main path's
// featmajor kernels, of the design asked for.
extern "C" int onehot_bench_launch(int device, const void* bins_t,
                                   long long n, int f, int esz,
                                   const void* rows, const void* scales,
                                   int qbr, void* out, int variant, int lpf,
                                   int lanes, int nf_max, int design,
                                   void* stream) {
  if (variant < 0 || variant >= kNumVariants || n % kChunk || esz < 1 ||
      esz > 2 || lpf <= 0 || design < 0 || design > 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const float* r = (const float*)rows;
  const Args a{device, bins_t, n, n, f, r, r + n, r + 2 * n, rows, scales,
               qbr, out, lpf, lanes, nf_max > 0 ? nf_max : 1,
               (cudaStream_t)stream};
  return dispatch(a, design, esz, variant, kFeatMajor);
}

template <int V, int L, typename T>
static cudaError_t attrs(int smem, int* out) {
  if constexpr (V == kInt8)
    return kernel_attrs(onehot_full_int8_kernel<L, T>, smem, out);
  else
    return kernel_attrs(onehot_full_kernel<V, L, T>, smem, out);
}

static cudaError_t no_attrs(int, int*) { return cudaErrorInvalidValue; }

// qbr: int8's quantization block rows (kInt8Span's kernel under
// kSegChunks chunks)
template <int V, int L>
static cudaError_t bucket_attrs(int qbr, int* out) {
  if constexpr (V == kInt8) {
    if (qbr > 0 && qbr < kSegRows)
      return kernel_attrs(onehot_full_bucket_kernel<kInt8Span, L>,
                          bucket_smem<kInt8Span>(), out, kBThreads);
  }
  return kernel_attrs(onehot_full_bucket_kernel<V, L>, bucket_smem<V>(), out,
                      kBThreads);
}

typedef cudaError_t (*AttrFn)(int, int*);
static const AttrFn kAttrs[2][kNumVariants][2] = {
    {{attrs<kBase, kFeatMajor, uint8_t>, attrs<kBase, kRowMajor, uint8_t>},
     {attrs<kBf16Cmp, kFeatMajor, uint8_t>,
      attrs<kBf16Cmp, kRowMajor, uint8_t>},
     {attrs<kI16Cmp, kFeatMajor, uint8_t>, attrs<kI16Cmp, kRowMajor, uint8_t>},
     {attrs<kU8Cmp, kFeatMajor, uint8_t>, attrs<kU8Cmp, kRowMajor, uint8_t>},
     {attrs<kSub1Abs, kFeatMajor, uint8_t>,
      attrs<kSub1Abs, kRowMajor, uint8_t>},
     {attrs<kStaged, kFeatMajor, uint8_t>, attrs<kStaged, kRowMajor, uint8_t>},
     {attrs<kPacked, kFeatMajor, uint8_t>, attrs<kPacked, kRowMajor, uint8_t>},
     {attrs<kInt8, kFeatMajor, uint8_t>, attrs<kInt8, kRowMajor, uint8_t>}},
    {{attrs<kBase, kFeatMajor, uint16_t>, attrs<kBase, kRowMajor, uint16_t>},
     {no_attrs, no_attrs},
     {attrs<kI16Cmp, kFeatMajor, uint16_t>,
      attrs<kI16Cmp, kRowMajor, uint16_t>},
     {no_attrs, no_attrs},
     {no_attrs, no_attrs},
     {attrs<kStaged, kFeatMajor, uint16_t>,
      attrs<kStaged, kRowMajor, uint16_t>},
     {no_attrs, no_attrs},
     {attrs<kInt8, kFeatMajor, uint16_t>, attrs<kInt8, kRowMajor, uint16_t>}},
};
static const AttrFn kBucketAttrs[kNumVariants][2] = {
    {bucket_attrs<kBase, kFeatMajor>, bucket_attrs<kBase, kRowMajor>},
    {no_attrs, no_attrs},
    {bucket_attrs<kI16Cmp, kFeatMajor>, bucket_attrs<kI16Cmp, kRowMajor>},
    {no_attrs, no_attrs},
    {no_attrs, no_attrs},
    {bucket_attrs<kStaged, kFeatMajor>, bucket_attrs<kStaged, kRowMajor>},
    {no_attrs, no_attrs},
    {bucket_attrs<kInt8, kFeatMajor>, bucket_attrs<kInt8, kRowMajor>},
};

// The kernel of (design, variant, layout) over esz-byte bins: out[0]
// registers a thread, out[1] static shared bytes, out[2] the dynamic shared
// bytes of a launch with nf_max features a CTA (rowmajor: rows of ld bins,
// 16-byte aligned; bucketed: a constant of the body), out[3] local (spill)
// bytes a thread, out[4] CTAs an SM at that launch.  qbr: int8's
// quantization block rows (the bucketed int8 kernel differs under 512).
extern "C" int onehot_full_query(int variant, int layout, int nf_max,
                                 long long ld, int esz, int design, int qbr,
                                 int* out) {
  if (variant < 0 || variant >= kNumVariants || layout < 0 || layout > 1 ||
      esz < 1 || esz > 2 || design < 0 || design > 1 ||
      (design == 1 && esz != 2))
    return (int)cudaErrorInvalidValue;
  if (design == 1) return (int)kBucketAttrs[variant][layout](qbr, out);
  return (int)kAttrs[esz - 1][variant][layout](
      launch_smem(variant, layout, nf_max > 0 ? nf_max : 1, ld, true, esz),
      out);
}
