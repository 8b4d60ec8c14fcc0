// hist_leaves: per-leaf [k, F, B, 3] histograms of leaf-grouped row blocks
// -- the frontier grower's batched smaller-child histograms, once per round.
//
// Replaces lightgbm_tpu/ops/histogram.py::_hist_leaves_pallas, which keeps
// the whole [k, 6, F * Bp] accumulator resident and adds each BR-row
// block's one-hot matmul into slot block_leaf[blk] through a slot select.
// Here each CTA takes a run of `bpc` consecutive BR-row blocks and one
// feature group, accumulates rows into a float64 shared-memory histogram,
// and flushes it into slot block_leaf[blk] of the zeroed float64
// accumulator whenever the slot changes (the frontier lays blocks out
// grouped by leaf, so a run usually flushes once); the wrapper rounds the
// accumulator to float32.  block_leaf need not be sorted; a block whose
// slot is outside [0, k) matches no slot and is dropped, as in the Pallas
// kernel's `where`.  A slot no block names stays zero, and a NaN stays in
// the slot of the block that carried it.  Only the first `f` columns of
// each `stride`-byte row are read (the rest are packed g/h/w bytes).
//
// Bound on an H100: C * f bytes of bins, 12 * C bytes of (g, h, m) and
// 4 * C / BR bytes of block_leaf read once, k * F * B * 12 bytes written:
// memory bound (f + 12) * C / 3.35 TB/s.  This simple version is limited by
// shared-memory atomics and by the flush (3 * F * B global atomics per CTA
// and slot change).
#include "hist_common.cuh"

__global__ void hist_leaves_kernel(const uint8_t* __restrict__ comb,
                                   int64_t c, int stride, int f, int B,
                                   const float* __restrict__ g,
                                   const float* __restrict__ h,
                                   const float* __restrict__ m,
                                   const int32_t* __restrict__ block_leaf,
                                   int br, int k, double* __restrict__ out,
                                   int fg, int bpc) {
  extern __shared__ double s[];
  const int f0 = blockIdx.y * fg;
  const int fgc = min(fg, f - f0);
  const int64_t nb = c / br;
  const int64_t b0 = (int64_t)blockIdx.x * bpc;
  const int64_t b1 = (b0 + bpc < nb) ? b0 + bpc : nb;
  const int64_t slot_size = (int64_t)f * B * 3;
  int cur = -1;
  lgbt::zero_shared(s, 3 * fgc * B);
  __syncthreads();
  for (int64_t blk = b0; blk < b1; ++blk) {
    const int slot = block_leaf[blk];
    if (slot < 0 || slot >= k) continue;
    if (slot != cur) {
      if (cur >= 0) {
        __syncthreads();
        lgbt::flush_shared(out + cur * slot_size, s, f0, fgc, B);
        __syncthreads();
        lgbt::zero_shared(s, 3 * fgc * B);
        __syncthreads();
      }
      cur = slot;
    }
    lgbt::accumulate_rows(s, comb, stride, g, h, m, blk * br,
                          blk * br + br, f0, fgc, B);
  }
  __syncthreads();
  if (cur >= 0) lgbt::flush_shared(out + cur * slot_size, s, f0, fgc, B);
}

extern "C" int hist_leaves_launch(int device, const void* comb, long long c,
                                  int stride, int f, int B, const void* g,
                                  const void* h, const void* m,
                                  const void* block_leaf, int br, int k,
                                  void* out, int fg, int bpc, int threads,
                                  void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)3 * fg * B * sizeof(double);
  e = cudaFuncSetAttribute(hist_leaves_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long nb = c / br;
  const dim3 grid((unsigned)((nb + bpc - 1) / bpc), (f + fg - 1) / fg);
  hist_leaves_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)comb, (int64_t)c, stride, f, B, (const float*)g,
      (const float*)h, (const float*)m, (const int32_t*)block_leaf, br, k,
      (double*)out, fg, bpc);
  return (int)cudaGetLastError();
}
