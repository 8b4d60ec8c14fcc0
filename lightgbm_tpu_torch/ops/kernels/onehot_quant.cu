// onehot_quant: the int8 one-hot variant's three-level quantization of the
// [3, n] float32 rows (g*m, h*m, m), per block of br rows.
//
// Replaces the `level` chain of
// lightgbm_tpu/ops/onehot_variants.py::_contrib_int8, which the Pallas
// kernels run on each BR-row block they multiply.  Here it runs once,
// before the one-hot kernels, and every lane block of theirs reads the same
// q: the same function, computed once instead of once per feature block.
//
// Per block and per row c, three times, the next level quantizing r:
//   s = max(max|x| * f32(1/127), 1e-30)   a NaN in max|x| stays NaN
//   q = rint(x / s)                        IEEE division, half to even
//   r = fma(-q, s, x)                      one rounding
// which is what the JAX package's jitted chain computes: XLA turns
// `/ 127.0` into a multiply by the float32 reciprocal and contracts
// `x - q * s` into a fused multiply-add.  q goes to row 3 * level + c of
// q [9, ldq] int8 (0 where it is NaN), s to s[block][3 * level + c].
// Bit-identical to onehot_variants.quantize_int8_blocks_plain.  The rows
// of q are ldq >= n bytes apart and the last block writes zeros from n to
// ldq: with ldq = n rounded up to 128 the one-hot kernels copy q in whole
// 16-byte pieces of 128-row chunks.
//
// One CTA a block; the block's rows stay in shared memory (12 * br bytes).
// Bound on an H100: it reads 12 n bytes and writes 9 n + 36 n / br bytes,
// 0.0063 ms at n = 1M; the reductions between the levels keep it well
// above that, but it runs once per histogram.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16384;
constexpr float kRecip127 = 0x1.020408p-7f;   // float32(1 / 127)
constexpr float kTiny = 1e-30f;

// max that keeps a NaN, as XLA's and PyTorch's reductions do
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__global__ void __launch_bounds__(kThreads)
    quant_kernel(const float* __restrict__ rows, int64_t n, int br,
                 int8_t* __restrict__ q, int64_t ldq,
                 float* __restrict__ s) {
  extern __shared__ float xs[];               // [3][br]
  __shared__ float red[3][kWarps];
  __shared__ float scale[3];
  const int64_t r0 = (int64_t)blockIdx.x * br;
  const int len = (int)((n - r0 < br) ? n - r0 : br);
  // the rows of q this block writes: its own, and (the last) the padding
  const int span = (int)((ldq - r0 < br) ? ldq - r0 : br);
  for (int c = 0; c < 3; ++c)
    for (int i = threadIdx.x; i < len; i += kThreads)
      xs[c * br + i] = rows[c * n + r0 + i];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int lvl = 0; lvl < 3; ++lvl) {
    float m[3] = {0.f, 0.f, 0.f};
    for (int i = threadIdx.x; i < len; i += kThreads)
#pragma unroll
      for (int c = 0; c < 3; ++c) m[c] = nanmax(m[c], fabsf(xs[c * br + i]));
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      for (int off = 16; off > 0; off >>= 1)
        m[c] = nanmax(m[c], __shfl_xor_sync(0xffffffffu, m[c], off));
      if (lane == 0) red[c][warp] = m[c];
    }
    __syncthreads();
    if (threadIdx.x < 3) {
      float v = 0.f;
      for (int w = 0; w < kWarps; ++w) v = nanmax(v, red[threadIdx.x][w]);
      float sc = __fmul_rn(v, kRecip127);
      sc = (sc != sc) ? sc : fmaxf(sc, kTiny);
      scale[threadIdx.x] = sc;
      s[(int64_t)blockIdx.x * 9 + 3 * lvl + threadIdx.x] = sc;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float sc = scale[c];
      int8_t* qrow = q + (int64_t)(3 * lvl + c) * ldq + r0;
      for (int i = threadIdx.x; i < len; i += kThreads) {
        const float x = xs[c * br + i];
        const float qf = rintf(__fdiv_rn(x, sc));
        xs[c * br + i] = __fmaf_rn(-qf, sc, x);
        qrow[i] = (qf != qf) ? (int8_t)0 : (int8_t)(int)qf;
      }
      for (int i = len + threadIdx.x; i < span; i += kThreads) qrow[i] = 0;
    }
    __syncthreads();
  }
}

}  // namespace

// rows: [3, n] float32; q: [9, ldq] int8, n <= ldq <= the blocks' rows;
// s: [ceil(n / br), 9] float32.  br: a multiple of 128, at most kMaxRows.
extern "C" int onehot_quant_launch(int device, const void* rows, long long n,
                                   int br, void* q, long long ldq, void* s,
                                   void* stream) {
  if (br <= 0 || br % 128 != 0 || br > kMaxRows || n < 0 || ldq < n ||
      ldq > (n + br - 1) / br * br)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n == 0) return 0;
  const int smem = 3 * br * (int)sizeof(float);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(quant_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long nb = (n + br - 1) / br;
  quant_kernel<<<(unsigned)nb, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)rows, (int64_t)n, br, (int8_t*)q, (int64_t)ldq,
      (float*)s);
  return (int)cudaGetLastError();
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
