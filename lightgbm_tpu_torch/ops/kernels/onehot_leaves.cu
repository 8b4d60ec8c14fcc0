// onehot_leaves: per-leaf [k, 6, lanes] one-hot histograms of leaf-grouped
// row blocks -- the frontier grower's batched smaller-child histograms
// under force_row_wise, once per round.
//
// Replaces lightgbm_tpu/ops/histogram.py::_hist_leaves_pallas, which keeps
// the whole [k, 6, lanes] accumulator resident and adds each BR-row
// block's one-hot product into slot block_leaf[blk] through a `where`.
// Here each CTA owns 512 lanes and a run of `bpc` consecutive BR-row
// blocks, keeps its sums in registers, and adds them to slot
// block_leaf[blk] of the zeroed float64 accumulator (atomics) whenever the
// slot changes, then starts again from zero.  block_leaf need not be
// sorted; a block whose slot is outside [0, k) is skipped; a slot that no
// block names stays zero; and a block's NaN reaches only its own slot (it
// spreads over that slot's lanes of its channel, since 0 * NaN is NaN in
// the tensor cores, as in the MXU).  The bins are read as the frontier
// gathers them, [C, ld] row-major, and only the first f columns (the rest
// are the packed gradient bytes).  int8 has a kernel of its own,
// onehot_leaves_int8_kernel, over the quantize kernel's q and scales, one
// quantization block per BR-row block (so per slot).
//
// Bound on an H100: C * f bytes of bins, 12 * C bytes of gh and 4 * C / BR
// of block_leaf read once, k * 48 * lanes bytes written; the tensor cores
// must do 2 * 8 * lanes * C flops, which dominates (0.030 ms at C = 262,144,
// lanes = 7168, 989 TFLOP/s).
#include "onehot_common.cuh"

using namespace lgbt_oh;

template <int V>
__global__ void __launch_bounds__(kThreads)
    onehot_leaves_kernel(const uint8_t* __restrict__ comb, int64_t ld,
                         int64_t c, int f, const uint16_t* __restrict__ gh,
                         const int32_t* __restrict__ block_leaf, int br,
                         int k, double* __restrict__ out, int lpf_log2,
                         int lanes, int bpc) {
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
  const int64_t nb = c / br;
  const int64_t b0 = (int64_t)blockIdx.x * bpc;
  const int64_t b1 = (b0 + bpc < nb) ? b0 + bpc : nb;
  const int64_t slot_size = (int64_t)6 * lanes;
  int cur = -1;
  for (int64_t blk = b0; blk < b1; ++blk) {
    const int slot = block_leaf[blk];
    if (slot < 0 || slot >= k) continue;
    if (slot != cur) {
      if (cur >= 0) {
        flush(out + cur * slot_size, acc, lb0, lanes);
        zero_acc(acc);
      }
      cur = slot;
    }
    accumulate_rows<V, kRowMajor>(acc, sg, sb, lm, comb, ld, c, fa, nf,
                                  gh, blk * br, blk * br + br);
  }
  if (cur >= 0) flush(out + cur * slot_size, acc, lb0, lanes);
}

// The int8 body: q [9, C] int8 and scales [C / br, 9] float32, block blk
// quantized on its own.
__global__ void __launch_bounds__(kThreads)
    onehot_leaves_int8_kernel(const uint8_t* __restrict__ comb, int64_t ld,
                              int64_t c, int f, const int8_t* __restrict__ q,
                              const float* __restrict__ scales,
                              const int32_t* __restrict__ block_leaf, int br,
                              int k, double* __restrict__ out, int lpf_log2,
                              int lanes, int bpc) {
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
  const int64_t nb = c / br;
  const int64_t b0 = (int64_t)blockIdx.x * bpc;
  const int64_t b1 = (b0 + bpc < nb) ? b0 + bpc : nb;
  const int64_t slot_size = (int64_t)6 * lanes;
  int cur = -1;
  for (int64_t blk = b0; blk < b1; ++blk) {
    const int slot = block_leaf[blk];
    if (slot < 0 || slot >= k) continue;
    if (slot != cur) {
      if (cur >= 0) flush_int8(out + cur * slot_size, facc, lb0, lanes);
      cur = slot;
    }
    accumulate_rows_int8<kRowMajor>(facc, sq, sb, lm, comb, ld, c, fa, nf, q,
                                    scales, br, blk * br, blk * br + br);
  }
  if (cur >= 0) flush_int8(out + cur * slot_size, facc, lb0, lanes);
}

template <int V>
static int launch(const void* comb, long long ld, long long c, int f,
                  const void* gh, const void* scales, const void* block_leaf,
                  int br, int k, void* out, int lpf_log2, int lanes, int bpc,
                  int nf_max, cudaStream_t stream) {
  const long long nb = c / br;
  const dim3 grid((unsigned)((nb + bpc - 1) / bpc),
                  (lanes + kBlockLanes - 1) / kBlockLanes);
  const int smem = kGhBytes + nf_max * kChunk;
  onehot_leaves_kernel<V><<<grid, kThreads, smem, stream>>>(
      (const uint8_t*)comb, (int64_t)ld, (int64_t)c, f, (const uint16_t*)gh,
      (const int32_t*)block_leaf, br, k, (double*)out, lpf_log2, lanes, bpc);
  return (int)cudaGetLastError();
}

static int launch_int8(const void* comb, long long ld, long long c, int f,
                       const void* q, const void* scales,
                       const void* block_leaf, int br, int k, void* out,
                       int lpf_log2, int lanes, int bpc, int nf_max,
                       cudaStream_t stream) {
  if (scales == nullptr) return (int)cudaErrorInvalidValue;
  const long long nb = c / br;
  const dim3 grid((unsigned)((nb + bpc - 1) / bpc),
                  (lanes + kBlockLanes - 1) / kBlockLanes);
  const int smem = kFaccBytes + kQBytes + nf_max * kChunk;
  onehot_leaves_int8_kernel<<<grid, kThreads, smem, stream>>>(
      (const uint8_t*)comb, (int64_t)ld, (int64_t)c, f, (const int8_t*)q,
      (const float*)scales, (const int32_t*)block_leaf, br, k, (double*)out,
      lpf_log2, lanes, bpc);
  return (int)cudaGetLastError();
}

typedef int (*LaunchFn)(const void*, long long, long long, int, const void*,
                        const void*, const void*, int, int, void*, int, int,
                        int, int, cudaStream_t);

static const LaunchFn kLaunch[kNumVariants] = {
    launch<kBase>, launch<kBf16Cmp>, launch<kI16Cmp>, launch<kU8Cmp>,
    launch<kSub1Abs>, launch<kStaged>, launch<kPacked>, launch_int8,
};

// comb: [C, ld] u8, row-major; gh: [6, C] bf16, or for int8 q [9, C] int8
// with scales [C / br, 9] float32 (not read by the other variants);
// block_leaf: [C / br] i32; out: zeroed [k, 6, lanes] float64.  br must be
// a multiple of 128; bpc: blocks per CTA.
extern "C" int onehot_leaves_launch(int device, const void* comb,
                                    long long ld, long long c, int f,
                                    const void* gh, const void* scales,
                                    const void* block_leaf, int br, int k,
                                    void* out, int variant, int lpf_log2,
                                    int lanes, int nf_max, int bpc,
                                    void* stream) {
  if (variant < 0 || variant >= kNumVariants || br <= 0 || br % kChunk != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return kLaunch[variant](comb, ld, c, f, gh, scales, block_leaf, br, k, out,
                          lpf_log2, lanes, bpc, nf_max > 0 ? nf_max : 1,
                          (cudaStream_t)stream);
}
