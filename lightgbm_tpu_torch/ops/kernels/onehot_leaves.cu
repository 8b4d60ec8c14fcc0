// onehot_leaves: per-leaf [k, 6, lanes] one-hot histograms of leaf-grouped
// row blocks -- the frontier grower's batched smaller-child histograms
// under force_row_wise, once per round.
//
// Replaces lightgbm_tpu/ops/histogram.py::_hist_leaves_pallas, which keeps
// the whole [k, 6, lanes] accumulator resident and adds each BR-row
// block's one-hot product into slot block_leaf[blk] through a `where`.
// Here each CTA owns 512 lanes and a run of consecutive 128-row chunks
// (as many CTAs as the card holds at once), which it walks through
// cp.async buffers (onehot_common.cuh: the rows are staged as they lie and
// transposed in shared memory, and grad, hess and mask split into the bf16
// pair there), keeps its sums in registers, and adds them to slot
// block_leaf[blk] of the zeroed float64 accumulator (atomics) whenever the
// slot changes, then starts again from zero.  block_leaf need not be
// sorted; a block whose slot is outside [0, k) is skipped; a slot that no
// block names stays zero; and a block's NaN reaches only its own slot (it
// spreads over that slot's lanes of its channel, since 0 * NaN is NaN in
// the tensor cores, as in the MXU).  The bins are read as the frontier
// gathers them, [C, ld] row-major, and only the first f columns (the rest
// are the packed gradient bytes).  int8 has a kernel of its own,
// onehot_leaves_int8_kernel, over the quantize kernel's q and scales, one
// quantization block per BR-row block (so per slot), staged the same way:
// its CTAs own runs of whole blocks, keep a block's int32 sums in registers
// and fold them into float64 shared memory at the block's end.
//
// Bins are u8 or u16 (the template's T, as in onehot_full.cu).  The
// wrapper takes this kernel only inside the JAX package's cut for its
// Pallas leaves kernel (f * Bp <= 32,768 lanes, a [k, 6, f * Bp] float32
// accumulator <= 48 MB: histogram.onehot_leaves_fits), and the atomic
// hist_leaves outside it, as the JAX package takes its scatter there.
//
// Bound on an H100: C * f bins (1 or 2 bytes each), 12 * C bytes of gh and
// 4 * C / BR of block_leaf read once, k * 48 * lanes bytes written; the
// tensor cores must do 2 * 8 * lanes * C flops, which dominates (0.030 ms
// at C = 262,144, lanes = 7168, 989 TFLOP/s; 0.12 ms at lanes = 28,672,
// B = 1,024).
//
// At u16 widths the bucketed design (onehot_bucket.cuh) replaces the dense
// one on the main path (onehot_leaves_bucket_kernel): a CTA of 8 warps owns
// up to 8 buckets of one feature and a run of whole blocks, sorts each
// block's rows (in segments of at most 512) by bucket and 16-lane tile,
// multiplies each bucket's rows on its own warp, and adds its sums to
// slot block_leaf[blk] of the zeroed [k, 3, lanes] float64 accumulator
// whenever the slot changes; the design argument of the entries picks (0
// dense, 1 bucketed; bucketed serves u16 bins only).
#include "onehot_bucket.cuh"

using namespace lgbt_oh;

template <int V, typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    onehot_leaves_kernel(Src S, int f, const int32_t* __restrict__ block_leaf,
                         int br, int k, double* __restrict__ out, int lpf,
                         int lpf_log2, int lanes, int64_t cpc, int nf_max) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lb0 = blockIdx.y * kBlockLanes;
  cta_features<T>(lb0, f, lpf, lpf_log2, &S.fa, &S.nf);
  const Geo geo = make_geo<T>(lb0, lanes, f, lpf, lpf_log2, S.fa);
  const Ids ids = make_ids(geo.jb);
  double acc[kTiles][4];
  zero_acc(acc);
  const int64_t chunks = S.n / kChunk;
  const int64_t c0 = (int64_t)blockIdx.x * cpc;
  const int64_t c1 = (c0 + cpc < chunks) ? c0 + cpc : chunks;
  const int cpb = br / kChunk;                  // chunks a block
  const int64_t slot_size = (int64_t)6 * lanes;
  int cur = -1;
  // the block of the next chunk, and that chunk's place in it (chunks
  // come in order, one call each)
  int64_t blk = c0 / cpb;
  int sub = (int)(c0 - blk * cpb);
  if (c0 < c1)
    run_chunks<V, kRowMajor, T>(
        S, smem, stage_bytes(kRowMajor, nf_max, S.raw, sizeof(T)), c0, c1,
        geo, ids, acc, [&](int64_t) {
          const int slot = block_leaf[blk];
          if (++sub == cpb) {
            sub = 0;
            ++blk;
          }
          if (slot < 0 || slot >= k) return false;
          if (slot != cur) {
            if (cur >= 0) {
              flush(out + cur * slot_size, acc, lb0, lanes);
              zero_acc(acc);
            }
            cur = slot;
          }
          return true;
        });
  if (cur >= 0) flush(out + cur * slot_size, acc, lb0, lanes);
}

// The int8 body: q [9, C] int8 and scales [C / br, 9] float32, block blk
// (cpb chunks) quantized on its own and owned by one slot: a CTA owns a run
// of whole blocks, folds each block's int32 sums into its float64 sums at
// the block's end, and flushes those when the slot changes.
template <typename T>
__global__ void __launch_bounds__(kThreads, kInt8LeavesMinBlocks)
    onehot_leaves_int8_kernel(Src S, int f, const int8_t* __restrict__ q,
                              const float* __restrict__ scales,
                              const int32_t* __restrict__ block_leaf,
                              int cpb, int k, double* __restrict__ out,
                              int lpf, int lpf_log2, int lanes, int64_t bpc,
                              int nf_max) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* facc = reinterpret_cast<double*>(smem);
  const int lb0 = blockIdx.y * kBlockLanes;
  cta_features<T>(lb0, f, lpf, lpf_log2, &S.fa, &S.nf);
  const Geo geo = make_geo<T>(lb0, lanes, f, lpf, lpf_log2, S.fa);
  const Int8Ids ids = make_int8_ids(geo.jb);
  zero_facc(facc);
  const int64_t nb = S.n / ((int64_t)cpb * kChunk);
  const int64_t b0 = (int64_t)blockIdx.x * bpc;
  const int64_t b1 = (b0 + bpc < nb) ? b0 + bpc : nb;
  const int64_t slot_size = (int64_t)6 * lanes;
  int cur = -1;
  if (b0 < b1)
    run_chunks_int8<kRowMajor, T>(
        S, q, scales, cpb, smem + kFaccBytes,
        stage_bytes_int8(kRowMajor, nf_max, S.raw, sizeof(T)), b0 * cpb,
        b1 * cpb, geo, ids, facc, [&](int64_t blk) {
          const int slot = block_leaf[blk];
          if (slot < 0 || slot >= k) return false;
          if (slot != cur) {
            if (cur >= 0) flush_int8(out + cur * slot_size, facc, lb0, lanes);
            cur = slot;
          }
          return true;
        });
  if (cur >= 0) flush_int8(out + cur * slot_size, facc, lb0, lanes);
}

// The bucketed design over u16 bins: grid (block splits, f * gpf) as in
// onehot_full_bucket_kernel; a CTA owns blocks [bpc x, bpc (x + 1)) of cpb
// chunks each, skips a block whose slot is outside [0, k), and keeps a
// block's rows apart from the next block's (int8: one quantization block).
template <int V>
__global__ void __launch_bounds__(kBThreads, kBMinBlocks)
    onehot_leaves_bucket_kernel(BSrc S,
                                const int32_t* __restrict__ block_leaf,
                                int cpb, int k, double* __restrict__ out,
                                int nb, int gpf, int bpg, int lanes,
                                int64_t bpc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int fa = blockIdx.y / gpf, b0 = (blockIdx.y % gpf) * bpg;
  const int nbc = min(bpg, nb - b0);
  const int64_t nblk = S.n / ((int64_t)cpb * kChunk);
  const int64_t blk0 = (int64_t)blockIdx.x * bpc;
  const int64_t blk1 = (blk0 + bpc < nblk) ? blk0 + bpc : nblk;
  const Segs G{blk1 * cpb, cpb, block_leaf, k};
  bucket_cta<V, kRowMajor>(smem, S, G, blk0 * cpb, fa, b0, nbc, out,
                           ((int64_t)fa * nb + b0) * kWarpLanes, lanes,
                           (int64_t)3 * lanes);
}

static bool aligned16(const void* p) { return !((uintptr_t)p & 15); }

template <int V, typename T>
static int launch(const void* comb, long long ld, long long c, int f,
                  const float* g, const float* h, const float* m,
                  const void*, const void*, const void* block_leaf, int br,
                  int k, void* out, int lpf, int lanes, int nf_max,
                  int device, cudaStream_t stream) {
  if (!(aligned16(g) && aligned16(h) && aligned16(m)))
    return (int)cudaErrorInvalidValue;
  const bool aligned = aligned16(comb);
  const int smem =
      launch_smem(V, kRowMajor, nf_max, ld, aligned, sizeof(T));
  auto kern = onehot_leaves_kernel<V, T>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const int nlb = (lanes + kBlockLanes - 1) / kBlockLanes;
  int gx;
  const long long cpc = split_units(c / kChunk, nlb,
                                    resident_ctas(kern, smem, device), &gx);
  const Src S{(const uint8_t*)comb, (int64_t)ld, (int64_t)c, g, h, m, 0, 0,
              raw_bytes(kRowMajor, ld, aligned, sizeof(T))};
  kern<<<dim3(gx, nlb), kThreads, smem, stream>>>(
      S, f, (const int32_t*)block_leaf, br, k, (double*)out, lpf, ilog2(lpf),
      lanes, (int64_t)cpc, nf_max);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_int8(const void* comb, long long ld, long long c, int f,
                       const float*, const float*, const float*,
                       const void* q, const void* scales,
                       const void* block_leaf, int br, int k, void* out,
                       int lpf, int lanes, int nf_max, int device,
                       cudaStream_t stream) {
  // whole chunks a block; q's rows start 16-byte aligned (C, its row
  // stride, is a multiple of kChunk)
  if (q == nullptr || scales == nullptr || br <= 0 || br % kChunk != 0 ||
      c % br != 0 || !aligned16(q))
    return (int)cudaErrorInvalidValue;
  const bool aligned = aligned16(comb);
  const int smem =
      launch_smem(kInt8, kRowMajor, nf_max, ld, aligned, sizeof(T));
  auto kern = onehot_leaves_int8_kernel<T>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const int nlb = (lanes + kBlockLanes - 1) / kBlockLanes;
  int gx;
  const long long bpc =
      split_units(c / br, nlb, resident_ctas(kern, smem, device), &gx);
  const Src S{(const uint8_t*)comb, (int64_t)ld, (int64_t)c, nullptr,
              nullptr, nullptr, 0, 0,
              raw_bytes(kRowMajor, ld, aligned, sizeof(T))};
  kern<<<dim3(gx, nlb), kThreads, smem, stream>>>(
      S, f, (const int8_t*)q, (const float*)scales,
      (const int32_t*)block_leaf, br / kChunk, k, (double*)out, lpf,
      ilog2(lpf), lanes, (int64_t)bpc, nf_max);
  return (int)cudaGetLastError();
}

template <int V>
static int launch_bucket(const void* comb, long long ld, long long c, int f,
                         const float* g, const float* h, const float* m,
                         const void* q, const void* scales,
                         const void* block_leaf, int br, int k, void* out,
                         int lpf, int lanes, int, int device,
                         cudaStream_t stream) {
  if (V == kInt8) {
    // whole chunks a block; q's rows start 16-byte aligned (C, its row
    // stride, is a multiple of kChunk)
    if (q == nullptr || scales == nullptr || c % br != 0 || !aligned16(q))
      return (int)cudaErrorInvalidValue;
  } else if (!(aligned16(g) && aligned16(h) && aligned16(m))) {
    return (int)cudaErrorInvalidValue;
  }
  if (lpf % kWarpLanes != 0) return (int)cudaErrorInvalidValue;
  const BucketGeo bg = bucket_geo(lpf);
  const int nlb = f * bg.gpf;
  if (nlb > 65535) return (int)cudaErrorInvalidValue;
  constexpr int smem = bucket_smem<V>();
  auto kern = onehot_leaves_bucket_kernel<V>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  int gx;
  const long long bpc = split_units(
      c / br, nlb, resident_ctas(kern, smem, device, kBThreads),
      &gx);
  const BSrc S{(const uint16_t*)comb, (int64_t)ld, (int64_t)c, g, h, m,
               (const int8_t*)q, (int64_t)c, (const float*)scales};
  kern<<<dim3(gx, nlb), kBThreads, smem, stream>>>(
      S, (const int32_t*)block_leaf, br / kChunk, k, (double*)out, bg.nb,
      bg.gpf, bg.bpg, lanes, (int64_t)bpc);
  return (int)cudaGetLastError();
}

typedef int (*LaunchFn)(const void*, long long, long long, int, const float*,
                        const float*, const float*, const void*, const void*,
                        const void*, int, int, void*, int, int, int, int,
                        cudaStream_t);

// a body with no u16 instantiation (the JAX package admits it at B <= 256
// only)
static int refuse(const void*, long long, long long, int, const float*,
                  const float*, const float*, const void*, const void*,
                  const void*, int, int, void*, int, int, int, int,
                  cudaStream_t) {
  return (int)cudaErrorInvalidValue;
}

// by (bin bytes - 1, variant)
static const LaunchFn kLaunch[2][kNumVariants] = {
    {launch<kBase, uint8_t>, launch<kBf16Cmp, uint8_t>,
     launch<kI16Cmp, uint8_t>, launch<kU8Cmp, uint8_t>,
     launch<kSub1Abs, uint8_t>, launch<kStaged, uint8_t>,
     launch<kPacked, uint8_t>, launch_int8<uint8_t>},
    {launch<kBase, uint16_t>, refuse, launch<kI16Cmp, uint16_t>, refuse,
     refuse, launch<kStaged, uint16_t>, refuse, launch_int8<uint16_t>},
};
// the bucketed design (u16 bins), by variant
static const LaunchFn kBucket[kNumVariants] = {
    launch_bucket<kBase>, refuse, launch_bucket<kI16Cmp>, refuse, refuse,
    launch_bucket<kStaged>, refuse, launch_bucket<kInt8>};

// comb: [C, ld] of esz-byte bins (1: u8, 2: u16), row-major; g, h, m: [C]
// float32 (grad, hess, mask), or for int8 q [9, C] int8 with scales [C /
// br, 9] float32 (g, h and m are not read by int8, q and scales not by the
// other variants); block_leaf: [C / br] i32; lpf: the lanes of one
// feature; design: 0 dense, 1 bucketed (u16 only); out: zeroed [k, 6,
// lanes] float64 (bucketed: [k, 3, lanes], hi + lo).  br must be a
// multiple of 128.
extern "C" int onehot_leaves_launch(int device, const void* comb,
                                    long long ld, long long c, int f,
                                    int esz, const void* g, const void* h,
                                    const void* m, const void* q,
                                    const void* scales,
                                    const void* block_leaf, int br, int k,
                                    void* out, int variant, int lpf,
                                    int lanes, int nf_max, int design,
                                    void* stream) {
  if (variant < 0 || variant >= kNumVariants || br <= 0 ||
      br % kChunk != 0 || esz < 1 || esz > 2 || lpf <= 0 || design < 0 ||
      design > 1 || (design == 1 && esz != 2))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return (design == 1 ? kBucket[variant] : kLaunch[esz - 1][variant])(
      comb, ld, c, f, (const float*)g, (const float*)h, (const float*)m, q,
      scales, block_leaf, br, k, out, lpf, lanes, nf_max > 0 ? nf_max : 1,
      device, (cudaStream_t)stream);
}

template <int V, typename T>
static cudaError_t attrs(int smem, int* out) {
  if constexpr (V == kInt8)
    return kernel_attrs(onehot_leaves_int8_kernel<T>, smem, out);
  else
    return kernel_attrs(onehot_leaves_kernel<V, T>, smem, out);
}

static cudaError_t no_attrs(int, int*) { return cudaErrorInvalidValue; }

template <int V>
static cudaError_t bucket_attrs(int, int* out) {
  return kernel_attrs(onehot_leaves_bucket_kernel<V>, bucket_smem<V>(), out,
                      kBThreads);
}

typedef cudaError_t (*AttrFn)(int, int*);
static const AttrFn kAttrs[2][kNumVariants] = {
    {attrs<kBase, uint8_t>, attrs<kBf16Cmp, uint8_t>,
     attrs<kI16Cmp, uint8_t>, attrs<kU8Cmp, uint8_t>,
     attrs<kSub1Abs, uint8_t>, attrs<kStaged, uint8_t>,
     attrs<kPacked, uint8_t>, attrs<kInt8, uint8_t>},
    {attrs<kBase, uint16_t>, no_attrs, attrs<kI16Cmp, uint16_t>, no_attrs,
     no_attrs, attrs<kStaged, uint16_t>, no_attrs, attrs<kInt8, uint16_t>},
};
static const AttrFn kBucketAttrs[kNumVariants] = {
    bucket_attrs<kBase>, no_attrs, bucket_attrs<kI16Cmp>, no_attrs, no_attrs,
    bucket_attrs<kStaged>, no_attrs, bucket_attrs<kInt8>};

// The kernel of (design, variant) over esz-byte bins: out[0] registers a
// thread, out[1] static shared bytes, out[2] the dynamic shared bytes of a
// launch with nf_max features a CTA over rows of ld bins, 16-byte aligned
// (bucketed: a constant of the body), out[3] local (spill) bytes a thread,
// out[4] CTAs an SM at that launch.
extern "C" int onehot_leaves_query(int variant, int nf_max, long long ld,
                                   int esz, int design, int* out) {
  if (variant < 0 || variant >= kNumVariants || esz < 1 || esz > 2 ||
      design < 0 || design > 1 || (design == 1 && esz != 2))
    return (int)cudaErrorInvalidValue;
  if (design == 1) return (int)kBucketAttrs[variant](0, out);
  return (int)kAttrs[esz - 1][variant](
      launch_smem(variant, kRowMajor, nf_max > 0 ? nf_max : 1, ld, true,
                  esz),
      out);
}
