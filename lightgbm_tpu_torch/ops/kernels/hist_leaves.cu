// hist_leaves: per-leaf [k, F, B, 3] histograms of leaf-grouped row blocks
// -- the frontier grower's batched smaller-child histograms, once per round.
//
// Replaces lightgbm_tpu/ops/histogram.py::_hist_leaves_pallas, which keeps
// the whole [k, 6, F * Bp] accumulator resident and adds each BR-row
// block's one-hot matmul into slot block_leaf[blk] through a slot select.
// Here each CTA takes `bpc` consecutive BR-row blocks and one feature
// group.  It takes the slots its blocks name one at a time, in the order
// each first appears, and adds every run of that slot's blocks (a
// contiguous stretch of rows) into a float64 shared-memory histogram
// (hist_common.cuh: each warp owning whole features, or at wide bins all
// warps dealt (step, feature) items in turn); then it writes
// that histogram once into its partial blockIdx.x * parts + j for its
// j-th slot, naming the slot in pslot (-1 for the partials it leaves
// unused).  So a CTA holds at most parts = min(bpc, k) partials, and
// hist_reduce_kernel sums each slot's partials, at most one a CTA, in the
// order of their index into the float32 output.  The frontier lays a
// round's blocks out slot by slot, so a CTA usually writes one or two.
// block_leaf need not be sorted; a block whose slot is outside [0, k) is
// dropped, as in the Pallas kernel's `where`.  A slot no block names is
// zero, and a NaN stays in the (slot, feature, bin) entries of the row
// that carried it.  comb holds u8 or u16 bins (the template parameter T);
// only the first `f` columns of each `stride`-bin row are read (the rest
// are the packed g/h/w columns: 12 u8 or 6 u16).  Where one feature's
// histogram does not fit a CTA (B above ~8,900), the listed design takes
// the call (hist_common.cuh): the pre-pass (hist_lists.cu) orders the
// blocks by slot and lists each (slot, feature, tile of 256 bins)'s rows
// in row order, and hist_leaves_listed_kernel's warps each add a unit of
// one list and write that slot's output themselves.
//
// Bound on an H100: C * f * esz bytes of bins (esz = 1 for u8, 2 for
// u16), 12 * C bytes of (g, h, m) and 4 * C / BR bytes of block_leaf read
// once, k * F * B * 12 bytes written: the byte bound is about (f * esz +
// 12) * C / 3.35 TB/s (0.0035 ms at C = 262,144, f = 28 u8, k = 16).  The update's shared-memory floor is 48 bytes
// per (row, feature) at 128 bytes a clock an SM (about 0.011 ms there).
// Each partial adds 2 * F * B * 24 bytes of device-memory traffic.  The
// listed design walks each segment's rows only.
#include "hist_common.cuh"

// Whether a block of [b0, blk) names `slot` (nearest first, so a block
// inside a run answers at once).
__device__ __forceinline__ bool named_before(const int32_t* block_leaf,
                                             int b0, int blk, int slot) {
  for (int b = blk - 1; b >= b0; --b)
    if (block_leaf[b] == slot) return true;
  return false;
}

// T: the bin type (uint8_t or uint16_t); stride in bins; kDealt: the
// design (hist_common.cuh).  Grid (grid_x, groups): CTA (x, y) takes
// blocks [x * bpc, ...) of feature group y.
template <typename T, bool kDealt>
__global__ void __launch_bounds__(kDealt ? 32 * lgbt::kDealtWarps : 1024)
    hist_leaves_kernel(const T* __restrict__ comb, long long c,
                       long long stride, int f, int B,
                       const float* __restrict__ g,
                       const float* __restrict__ h,
                       const float* __restrict__ m,
                       const int32_t* __restrict__ block_leaf, int br, int k,
                       double* __restrict__ partial,
                       int32_t* __restrict__ pslot, int fg, int tile,
                       int bpc, int parts) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int f0 = blockIdx.y * fg;
  const int fgc = min(fg, f - f0);
  const lgbt::Smem sm = lgbt::carve<kDealt>(smem, fgc, B);
  const int esz = (int)sizeof(T);
  const lgbt::Stage st = lgbt::stage_of(tile, stride * esz, fg * esz);
  const int nb = (int)(c / br);
  const int b0 = blockIdx.x * bpc;
  const int b1 = min(nb, b0 + bpc);
  const lgbt::Rows src{reinterpret_cast<const uint8_t*>(comb), stride * esz,
                        esz, g, h, m};
  int j = 0;
  uint32_t ring = 0;  // tiles through the dealt design's ring
  for (int first = b0; first < b1; ++first) {
    const int slot = block_leaf[first];
    if (slot < 0 || slot >= k || named_before(block_leaf, b0, first, slot))
      continue;
    __syncthreads();  // the last slot's partial is written
    lgbt::zero_hist(sm.hist, 3 * fgc * B);
    for (int blk = first; blk < b1;) {  // each run of the slot
      if (block_leaf[blk] != slot) {
        ++blk;
        continue;
      }
      int end = blk + 1;
      while (end < b1 && block_leaf[end] == slot) ++end;
      lgbt::accumulate_rows<T, kDealt>(sm, st, src, (long long)blk * br,
                                       (long long)end * br, f0, fgc, B,
                                       ring);
      blk = end;
    }
    __syncthreads();
    const long long p = (long long)blockIdx.x * parts + j;
    lgbt::write_partial(partial + (p * f + f0) * B * 3, sm.hist,
                        3 * fgc * B);
    if (blockIdx.y == 0 && threadIdx.x == 0) pslot[p] = slot;
    ++j;
  }
  if (blockIdx.y == 0)
    for (int r = j + threadIdx.x; r < parts; r += blockDim.x)
      pslot[(long long)blockIdx.x * parts + r] = -1;
}

// The listed design (hist_common.cuh::listed_units) for k slots: a unit
// writes its slot's [B, 3] of one feature's tile.
__global__ void __launch_bounds__(32 * lgbt::kListWarps, 3)
    hist_leaves_listed_kernel(const lgbt::ListedArgs a) {
  lgbt::listed_units(a);
}

// The launch plan of a shape (lgbt::plan_launch's fourteen values); esz
// is the bin type's size (1: u8, 2: u16); design -1 (the plan's choice),
// 0 (owned), 1 (dealt) or 2 (listed).
extern "C" int hist_leaves_plan(int device, long long stride, int f, int B,
                                int esz, int design, int* out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (esz == 1)
    return (int)lgbt::plan_launch(hist_leaves_kernel<uint8_t, false>,
                                  hist_leaves_kernel<uint8_t, true>,
                                  hist_leaves_listed_kernel, device, stride,
                                  f, B, 1, design, out);
  if (esz == 2)
    return (int)lgbt::plan_launch(hist_leaves_kernel<uint16_t, false>,
                                  hist_leaves_kernel<uint16_t, true>,
                                  hist_leaves_listed_kernel, device, stride,
                                  f, B, 2, design, out);
  return (int)cudaErrorInvalidValue;
}

// The listed design's main kernel over the lists of one call (ptrs: see
// lgbt::launch_listed; k slots) of f features into out ([k, fout, B, 3]
// float32 from the lists' first feature); partial, units and grid as
// hist_full_listed_launch's.
extern "C" int hist_leaves_listed_launch(int device, const long long* ptrs,
                                         void* partial, void* out, int f,
                                         int B, int k, int tw_log2, int unit,
                                         int units, int fout, int grid,
                                         void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return (int)lgbt::launch_listed(hist_leaves_listed_kernel, device, ptrs,
                                  partial, out, f, B, k, tw_log2, unit, units,
                                  fout, grid, (cudaStream_t)stream);
}

// The launch geometry: the plan's feature group, tile rows and threads;
// the CTAs along x, the blocks each takes and the partials each may
// write.
struct LeavesGrid {
  int fg, tile, threads, grid_x, bpc, parts;
};

template <typename T, bool kDealt>
static cudaError_t launch_leaves_as(int device, const void* comb,
                                    long long c, long long stride, int f,
                                    int B, const void* g, const void* h,
                                    const void* m, const void* block_leaf,
                                    int br, int k, double* partial,
                                    int32_t* pslot, const LeavesGrid& q,
                                    cudaStream_t s) {
  const int smem = (int)lgbt::smem_bytes(q.fg, B, q.tile, stride, sizeof(T),
                                         kDealt);
  cudaError_t e =
      lgbt::allow_smem(hist_leaves_kernel<T, kDealt>, device, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(q.grid_x, (f + q.fg - 1) / q.fg);
  hist_leaves_kernel<T, kDealt><<<grid, q.threads, smem, s>>>(
      (const T*)comb, c, stride, f, B, (const float*)g, (const float*)h,
      (const float*)m, (const int32_t*)block_leaf, br, k, partial, pslot,
      q.fg, q.tile, q.bpc, q.parts);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_leaves(int device, const void* comb, long long c,
                                 long long stride, int f, int B,
                                 const void* g, const void* h, const void* m,
                                 const void* block_leaf, int br, int k,
                                 double* partial, int32_t* pslot, int design,
                                 const LeavesGrid& q, cudaStream_t s) {
  if (design == 0)
    return launch_leaves_as<T, false>(device, comb, c, stride, f, B, g, h, m,
                                      block_leaf, br, k, partial, pslot, q, s);
  if (design == 1)
    return launch_leaves_as<T, true>(device, comb, c, stride, f, B, g, h, m,
                                     block_leaf, br, k, partial, pslot, q, s);
  return cudaErrorInvalidValue;
}

// The main kernel over grid_x CTAs (bpc blocks each) by the feature
// groups, then the reduce pass over its grid_x * parts partials into out
// ([k, f, B, 3] float32).  parts >= min(bpc, k); scratch holds the
// partials ([grid_x * parts, f, B, 3] float64), then their slots (int32
// each).  comb holds u8 (esz 1) or u16 (esz 2) values, rows of `stride`
// bins; fg, tile, threads and design are the plan's.
extern "C" int hist_leaves_launch(int device, const void* comb, long long c,
                                  long long stride, int f, int B, int esz,
                                  const void* g, const void* h, const void* m,
                                  const void* block_leaf, int br, int k,
                                  void* scratch, void* out, int fg, int tile,
                                  int threads, int design, int grid_x,
                                  int bpc, int parts, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (parts < (bpc < k ? bpc : k)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long E = (long long)f * B * 3;
  double* partial = (double*)scratch;
  int32_t* pslot = (int32_t*)(partial + (long long)grid_x * parts * E);
  const LeavesGrid q{fg, tile, threads, grid_x, bpc, parts};
  if (esz == 1)
    e = launch_leaves<uint8_t>(device, comb, c, stride, f, B, g, h, m,
                               block_leaf, br, k, partial, pslot, design, q,
                               s);
  else if (esz == 2)
    e = launch_leaves<uint16_t>(device, comb, c, stride, f, B, g, h, m,
                                block_leaf, br, k, partial, pslot, design, q,
                                s);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)lgbt::launch_reduce(partial, pslot, grid_x * parts, E, k,
                                  (float*)out, s);
}
