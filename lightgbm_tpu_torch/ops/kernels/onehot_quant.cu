// onehot_quant: the int8 one-hot variant's pre-pass.  It reads the three
// float32 vectors the caller has, grad, hess and mask, forms the rows
// x = (g*m, h*m, m) (one IEEE multiply each, as prep_f32 does; no row is
// skipped for m == 0, so a NaN times 0 stays NaN), and quantizes them in
// three levels per block of br rows.  The shootout shell passes rows it
// prepped itself, [3, n], with prep = 0: then x is read as given.
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
// `x - q * s` into a fused multiply-add.  A zero x (a masked row, the
// padding) has the quotient x itself, NaN where s is NaN, and is divided as
// s / s times x: the division's slow path, which a zero dividend on any
// lane sends the whole warp through, then never runs for it (PERF.md times
// a copy without this).  No fast-math and no reciprocal: every other x is
// divided by __fdiv_rn.  q goes to row 3 * level + c of
// q [9, ldq] int8 (0 where it is NaN), s to s[block][3 * level + c].
// Bit-identical to onehot_variants.quantize_int8_blocks_plain(prep_f32(...)).
// ldq is n rounded up to 128 and q is 0 from n to ldq: the one-hot kernels
// copy q in whole 16-byte pieces of 128-row chunks.
//
// Bound on an H100: it reads 12 n bytes and writes 9 n + 36 n / br bytes,
// 0.0063 ms at n = 1M; with the IEEE divisions, nine a row, it issues
// about a thousand instructions a thread.  The design keeps the rows out of
// shared memory, the barriers few and the reductions short:
// - each thread owns R consecutive rows of its block (R = 4 up to 4096-row
//   blocks, so 256 threads at the main path's 1024 rows and 128 at 512;
//   8 and 16 for the larger blocks, at most 1024 threads a block), loads
//   them with one 16-byte load a channel where the pointer allows, and
//   keeps x, then the residual, in registers through the three levels;
// - a level is one warp-wide max a channel (max|x| keeping a NaN is the
//   unsigned max of the bits of |x|, so one __reduce_max_sync), the warp
//   partials in a small shared array indexed by level, one barrier, and
//   every warp reducing its block's partials itself the same way: 3
//   barriers a block;
// - a thread writes its R q bytes of a (level, channel) as one 4-, 8- or
//   16-byte store; the rows past n are loaded as 0, give q = 0 (NaN, stored
//   as 0, in a NaN block) and leave max|x| alone, so the same stores write
//   q's padding;
// - blocks below 512 rows share a CTA, so a CTA has at least 128 threads
//   (a 128-row block is one warp; 32-thread CTAs would leave an SM half
//   empty at its 32-CTA limit).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMinCtaThreads = 128;
constexpr int kMaxRows = 16384;
constexpr int kChunk = 128;
constexpr float kRecip127 = 0x1.020408p-7f;   // float32(1 / 127)
constexpr float kTiny = 1e-30f;

// |x| as bits: a non-negative float's bits order as the float does, and
// a NaN's (sign cleared, any payload) above +inf's, so the unsigned max of
// these bits is max|x| keeping a NaN, as XLA's and PyTorch's reductions do
__device__ __forceinline__ uint32_t abs_bits(float x) {
  return __float_as_uint(x) & 0x7fffffffu;
}

// R rows of one channel from `row`, 0 at and past `end`
template <int R>
__device__ __forceinline__ void load_rows(const float* __restrict__ p,
                                          int64_t row, int64_t end,
                                          float (&v)[R]) {
  if (row + R <= end && (reinterpret_cast<uintptr_t>(p + row) & 15) == 0) {
#pragma unroll
    for (int k = 0; k < R; k += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + row + k));
      v[k] = t.x;
      v[k + 1] = t.y;
      v[k + 2] = t.z;
      v[k + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k)
      v[k] = row + k < end ? __ldg(p + row + k) : 0.f;
  }
}

template <int R>
__device__ __forceinline__ void store_q(int8_t* dst,
                                        const uint32_t (&w)[R / 4]) {
  if constexpr (R == 4) {
    *reinterpret_cast<uint32_t*>(dst) = w[0];
  } else if constexpr (R == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
    static_assert(R == 16, "rows a thread: 4, 8 or 16");
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// One CTA holds blockDim.x / tpb blocks of br rows, tpb (a multiple of 32)
// threads each; thread lt of a block owns rows r0 + lt * R ... + R - 1 (a
// thread with lt * R >= br owns none, when br / R is not a multiple of 32).
template <int R>
__global__ void __launch_bounds__(kMaxThreads)
    quant_kernel(const float* __restrict__ x0, const float* __restrict__ x1,
                 const float* __restrict__ x2, int prep, int64_t n, int br,
                 int tpb, int64_t nb, int8_t* __restrict__ q, int64_t ldq,
                 float* __restrict__ s) {
  __shared__ uint32_t red[3][3][kMaxWarps];  // [level][channel][warp]
  const int j = threadIdx.x / tpb;
  const int lt = threadIdx.x - j * tpb;
  const int64_t blk = (int64_t)blockIdx.x * (blockDim.x / tpb) + j;
  const int64_t r0 = blk * br;
  const int64_t row = r0 + (int64_t)lt * R;
  const int64_t end = n < r0 + br ? n : r0 + br;
  // ldq and br are multiples of 128, so R rows are all below ldq or none
  const bool writes = lt * R < br && row < ldq;
  float v[3][R];
  load_rows<R>(x0, row, end, v[0]);
  load_rows<R>(x1, row, end, v[1]);
  load_rows<R>(x2, row, end, v[2]);
  if (prep) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      v[0][k] = __fmul_rn(v[0][k], v[2][k]);
      v[1][k] = __fmul_rn(v[1][k], v[2][k]);
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpb = tpb >> 5, w0 = j * wpb;
#pragma unroll
  for (int lvl = 0; lvl < 3; ++lvl) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      uint32_t m = 0;
#pragma unroll
      for (int k = 0; k < R; ++k) m = max(m, abs_bits(v[c][k]));
      m = __reduce_max_sync(0xffffffffu, m);
      if (lane == 0) red[lvl][c][warp] = m;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const uint32_t m = __reduce_max_sync(
          0xffffffffu, lane < wpb ? red[lvl][c][w0 + lane] : 0u);
      float sc = __fmul_rn(__uint_as_float(m), kRecip127);
      sc = (sc != sc) ? sc : fmaxf(sc, kTiny);
      if (lt == 0 && blk < nb) s[blk * 9 + 3 * lvl + c] = sc;
      uint32_t w[R / 4] = {};
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float x = v[c][k];
        // 0 / s is x itself, NaN where s is: x * (s / s).  (Where s is
        // +inf that gives NaN for 0: q is stored as 0 and r is NaN either
        // way.)
        const bool zero = x == 0.f;
        const float d = __fdiv_rn(zero ? sc : x, sc);
        const float qf = rintf(zero ? __fmul_rn(x, d) : d);
        v[c][k] = __fmaf_rn(-qf, sc, x);
        const uint32_t b =
            (qf != qf) ? 0u : (uint32_t)(uint8_t)(int8_t)(int)qf;
        w[k >> 2] |= b << (8 * (k & 3));
      }
      if (writes) store_q<R>(q + (int64_t)(3 * lvl + c) * ldq + row, w);
    }
  }
}

struct Geometry {
  int rows;      // rows a thread
  int tpb;       // threads a block (a multiple of 32)
  int blocks;    // blocks a CTA
};

Geometry geometry(int br) {
  Geometry g;
  g.rows = br <= 4096 ? 4 : br <= 8192 ? 8 : 16;
  g.tpb = (br / g.rows + 31) / 32 * 32;
  g.blocks = g.tpb < kMinCtaThreads ? kMinCtaThreads / g.tpb : 1;
  return g;
}

bool valid_rows(int br) {
  return br > 0 && br % kChunk == 0 && br <= kMaxRows;
}

}  // namespace

// x0, x1, x2: [n] float32 each, 4-byte aligned: grad, hess and mask
// (prep != 0: the kernel forms g*m and h*m) or the rows of a prepped
// [3, n] tensor (prep == 0); q: [9, ldq] int8, ldq = n rounded up to 128,
// 16-byte aligned; s: [ceil(n / br), 9] float32.  br: a multiple of 128, at
// most kMaxRows.
extern "C" int onehot_quant_launch(int device, const void* x0, const void* x1,
                                   const void* x2, int prep, long long n,
                                   int br, void* q, void* s, void* stream) {
  const uintptr_t misaligned = ((uintptr_t)x0 | (uintptr_t)x1 |
                                (uintptr_t)x2) & 3;
  if (!valid_rows(br) || n < 0 || misaligned || ((uintptr_t)q & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n == 0) return 0;
  const Geometry g = geometry(br);
  const long long nb = (n + br - 1) / br;
  const long long ldq = (n + kChunk - 1) / kChunk * kChunk;
  const unsigned grid = (unsigned)((nb + g.blocks - 1) / g.blocks);
  const unsigned threads = (unsigned)(g.blocks * g.tpb);
  cudaStream_t st = (cudaStream_t)stream;
  const float *a = (const float*)x0, *b = (const float*)x1,
              *c = (const float*)x2;
  if (g.rows == 4)
    quant_kernel<4><<<grid, threads, 0, st>>>(a, b, c, prep, n, br, g.tpb, nb,
                                              (int8_t*)q, ldq, (float*)s);
  else if (g.rows == 8)
    quant_kernel<8><<<grid, threads, 0, st>>>(a, b, c, prep, n, br, g.tpb, nb,
                                              (int8_t*)q, ldq, (float*)s);
  else
    quant_kernel<16><<<grid, threads, 0, st>>>(a, b, c, prep, n, br, g.tpb,
                                               nb, (int8_t*)q, ldq, (float*)s);
  return (int)cudaGetLastError();
}

// out[5]: registers a thread, spilled (local) bytes a thread, rows a
// thread, threads a block and blocks a CTA of the kernel that serves
// br-row blocks
extern "C" int onehot_quant_query(int br, int* out) {
  if (!valid_rows(br)) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(br);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(
      &a, g.rows == 4   ? (const void*)quant_kernel<4>
          : g.rows == 8 ? (const void*)quant_kernel<8>
                        : (const void*)quant_kernel<16>);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = g.rows;
  out[3] = g.tpb;
  out[4] = g.blocks;
  return 0;
}

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
