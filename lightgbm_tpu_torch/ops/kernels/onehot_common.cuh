// Shared pieces of the one-hot (row-wise) histogram kernels
// (onehot_full.cu, onehot_leaves.cu): the seven bf16-pair one-hot bodies
// of lightgbm_tpu/ops/onehot_variants.py and their tensor-core tile
// product, and the int8 body (the last part of this file).
//
// The function: out[c][lane] = sum over rows r of gh[c][r] * onehot(lane, r)
// where gh is the [6, N] bf16 (hi, lo) split of (g*m, h*m, m) and
// onehot(lane, r) is 1 when row r's bin for the lane's feature equals the
// lane's bin id.  The lane map is lane = feature * lpf + bin, lpf being the
// lanes of one feature (Bp = 128 or 256 for the unpacked variants, B for
// `packed`), always a power of two.  A bin that no lane of its feature
// carries (>= Bp, or >= B under packing) matches nothing.
//
// Tile product: mma.sync.m16n8k16, bf16 inputs, f32 sums.  The one-hot
// lanes go on M (16 lanes a tile), the rows on K (16 rows a step) and the
// six channel rows on N (8, two of them zero) -- the TPU kernel put gh on
// M only because the MXU's sublanes are 8 wide.  So the B fragment (gh of
// 16 rows) is loaded once per step and reused by every lane tile, and each
// thread builds its A fragment -- the one-hot of its 2 lanes x 4 rows --
// in registers, in the variant's own compare domain:
//
//   base, packed  int32 compare          bf16cmp  bf16 compare (__heq2)
//   i16cmp        int16 compare (SIMD)   u8cmp    uint8 compare (SIMD)
//   sub1abs       max(0, 1 - |b - j|) in bf16 arithmetic
//   staged        (hi digit one-hot) * (lo digit one-hot), digit width 16
//
// Each one-hot element is exactly 0 or 1 and each product exact, so every
// body gives the same sums.
//
// Accumulation: a CTA owns kBlockLanes lanes and a range of rows.  Rows
// are staged kChunk at a time in shared memory (bins as [feature][row]
// bytes, gh as [8][row] bf16); the tile sums of one chunk stay in f32 mma
// registers (at most kChunk rows per lane, which in practice sum exactly
// in f32), then fold into float64 registers.  The float64 sums leave the
// CTA through float64 global atomics and the wrapper rounds to float32
// once, after adding hi and lo, as the plain version does.
#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lgbt_oh {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTiles = 8;                             // 16-lane tiles a warp
constexpr int kWarpLanes = kTiles * 16;               // 128
constexpr int kBlockLanes = kWarps * kWarpLanes;      // 512 lanes a CTA
constexpr int kChunk = 128;                           // rows staged at once
constexpr int kGhBytes = 8 * kChunk * 2;              // staged gh, 8 rows

enum Variant { kBase = 0, kBf16Cmp, kI16Cmp, kU8Cmp, kSub1Abs, kStaged,
               kPacked, kInt8, kNumVariants };
enum Layout { kFeatMajor = 0, kRowMajor = 1 };

constexpr uint32_t kOneLo = 0x3F80u;        // bf16 1.0 in the low half
constexpr uint32_t kOneHi = 0x3F800000u;    // bf16 1.0 in the high half

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

__device__ __forceinline__ uint32_t pair(bool lo, bool hi) {
  return (lo ? kOneLo : 0u) | (hi ? kOneHi : 0u);
}

// bf16x2 one-hot {onehot(b0, j), onehot(b1, j)} of two rows' bins b0, b1
// (0..255) against lane bin id j; j < 0 marks a lane with no feature, which
// matches nothing.
template <int V>
__device__ __forceinline__ uint32_t onehot2(int b0, int b1, int j);

template <>
__device__ __forceinline__ uint32_t onehot2<kBase>(int b0, int b1, int j) {
  return pair(b0 == j, b1 == j);
}

template <>
__device__ __forceinline__ uint32_t onehot2<kPacked>(int b0, int b1, int j) {
  return pair(b0 == j, b1 == j);
}

template <>
__device__ __forceinline__ uint32_t onehot2<kBf16Cmp>(int b0, int b1,
                                                      int j) {
  const __nv_bfloat162 b = __floats2bfloat162_rn((float)b0, (float)b1);
  return bits(__heq2(b, __float2bfloat162_rn((float)j)));
}

template <>
__device__ __forceinline__ uint32_t onehot2<kI16Cmp>(int b0, int b1, int j) {
  const uint32_t jj = (uint32_t)(j & 0xFFFF) * 0x00010001u;
  return (__vcmpeq2((uint32_t)b0 | ((uint32_t)b1 << 16), jj) & 0x00010001u)
         * kOneLo;
}

template <>
__device__ __forceinline__ uint32_t onehot2<kU8Cmp>(int b0, int b1, int j) {
  // bytes 0 and 2 carry the bins; bytes 1 and 3 compare 0 with 0 and are
  // masked off
  const uint32_t jj = (uint32_t)(j & 0xFF) * 0x00010001u;
  const uint32_t eq =
      (__vcmpeq4((uint32_t)b0 | ((uint32_t)b1 << 16), jj) & 0x00010001u)
      * kOneLo;
  return j < 0 ? 0u : eq;
}

template <>
__device__ __forceinline__ uint32_t onehot2<kSub1Abs>(int b0, int b1,
                                                      int j) {
  const __nv_bfloat162 b = __floats2bfloat162_rn((float)b0, (float)b1);
  const __nv_bfloat162 d = __hsub2(b, __float2bfloat162_rn((float)j));
  const __nv_bfloat162 one = __float2bfloat162_rn(1.f);
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
  return bits(__hmax2(__hsub2(one, __habs2(d)), zero));
}

template <>
__device__ __forceinline__ uint32_t onehot2<kStaged>(int b0, int b1, int j) {
  // bin = hi * 16 + lo; the one-hot is the product of the two digits'
  // one-hots (both 0/1, so the bf16 product is exact)
  const int jh = j >> 4, jl = j & 15;
  uint32_t hi = pair((b0 >> 4) == jh, (b1 >> 4) == jh);
  uint32_t lo = pair((b0 & 15) == jl, (b1 & 15) == jl);
  __nv_bfloat162 h, l;
  memcpy(&h, &hi, 4);
  memcpy(&l, &lo, 4);
  return bits(__hmul2(h, l));
}

// d += A(16 x 16, bf16, row) * B(16 x 8, bf16, col), f32 sums
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// What one thread needs to know about its lanes.  In the m16n8k16
// fragments thread (g = lane_id / 4, t = lane_id % 4) builds the one-hot of
// tile lanes g and g + 8 for rows 2t, 2t+1, 2t+8, 2t+9 of a 16-row step,
// and ends with the sums of channels 2t, 2t+1 of those two lanes (the int8
// body's m16n8k32 fragments: rows 4t..4t+3 and 16+4t..16+4t+3 of a 32-row
// step, the same lanes and channels).
struct Lanes {
  int off[kTiles][2];   // byte offset of the lane's feature row in smem
  int bin[kTiles][2];   // lane bin id, or -1 for a lane with no feature
};

// The CTA's lanes [lb0, lb0 + kBlockLanes) read features [fa, fa + nf).
__device__ __forceinline__ void cta_features(int lb0, int f, int lpf_log2,
                                             int* fa, int* nf) {
  *fa = lb0 >> lpf_log2;
  const int fb = min(f, ((lb0 + kBlockLanes - 1) >> lpf_log2) + 1);
  *nf = max(0, fb - *fa);
}

__device__ __forceinline__ void init_lanes(Lanes& L, int lb0, int lanes,
                                           int f, int lpf_log2, int fa) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int tl = 0; tl < kTiles; ++tl) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lane = lb0 + warp * kWarpLanes + tl * 16 + g + 8 * h;
      const int feat = lane >> lpf_log2;
      const bool ok = lane < lanes && feat < f;
      L.off[tl][h] = ok ? (feat - fa) * kChunk : 0;
      L.bin[tl][h] = ok ? (lane & ((1 << lpf_log2) - 1)) : -1;
    }
  }
}

// Stage rows [r0, r0 + kChunk) of the bins of features [fa, fa + nf) into
// shared memory as [feature][row] bytes; rows >= n read as bin 0 (their
// weights are staged as zero).  kFeatMajor reads a [f, ld] transposed copy,
// kRowMajor the [n, ld] matrix as stored (columns past f are never read).
template <int L>
__device__ __forceinline__ void stage_bins(uint8_t* sb,
                                           const uint8_t* __restrict__ bins,
                                           int64_t ld, int64_t n, int fa,
                                           int nf, int64_t r0) {
  for (int i = threadIdx.x; i < nf * kChunk; i += kThreads) {
    int fl, r;
    if (L == kFeatMajor) {
      fl = i / kChunk;
      r = i - fl * kChunk;
    } else {
      r = i / nf;
      fl = i - r * nf;
    }
    const int64_t row = r0 + r;
    uint8_t v = 0;
    if (row < n)
      v = (L == kFeatMajor) ? bins[(int64_t)(fa + fl) * ld + row]
                            : bins[row * ld + fa + fl];
    sb[fl * kChunk + r] = v;
  }
}

// Stage rows [r0, r0 + kChunk) of gh ([6, n] bf16) and of the bins;
// rows >= n read as zero weight.
template <int L>
__device__ __forceinline__ void stage(uint16_t* sg, uint8_t* sb,
                                      const uint8_t* __restrict__ bins,
                                      int64_t ld, int64_t n, int fa, int nf,
                                      const uint16_t* __restrict__ gh,
                                      int64_t r0) {
  for (int i = threadIdx.x; i < 6 * kChunk; i += kThreads) {
    const int c = i / kChunk, r = i - c * kChunk;
    const int64_t row = r0 + r;
    sg[i] = row < n ? gh[c * n + row] : (uint16_t)0;
  }
  stage_bins<L>(sb, bins, ld, n, fa, nf, r0);
}

// The staged chunk's contribution to this thread's tile sums.
template <int V>
__device__ __forceinline__ void mma_chunk(float (&c)[kTiles][4],
                                          const uint16_t* sg,
                                          const uint8_t* sb, const Lanes& L) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll 2
  for (int ks = 0; ks < kChunk; ks += 16) {
    const uint16_t* gp = sg + g * kChunk + ks + 2 * t;
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(gp);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(gp + 8);
#pragma unroll
    for (int tl = 0; tl < kTiles; ++tl) {
      const uint8_t* p0 = sb + L.off[tl][0] + ks + 2 * t;   // lane g
      const uint8_t* p1 = sb + L.off[tl][1] + ks + 2 * t;   // lane g + 8
      const int j0 = L.bin[tl][0], j1 = L.bin[tl][1];
      const uint32_t a0 = onehot2<V>(p0[0], p0[1], j0);
      const uint32_t a1 = onehot2<V>(p1[0], p1[1], j1);
      const uint32_t a2 = onehot2<V>(p0[8], p0[9], j0);
      const uint32_t a3 = onehot2<V>(p1[8], p1[9], j1);
      mma16816(c[tl], a0, a1, a2, a3, b0, b1);
    }
  }
}

__device__ __forceinline__ void zero_acc(double (&acc)[kTiles][4]) {
#pragma unroll
  for (int tl = 0; tl < kTiles; ++tl)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[tl][i] = 0.0;
}

// Stage and multiply rows [r0, r1) chunk by chunk, folding each chunk's
// f32 tile sums into acc.  Every thread of the CTA must call it.
template <int V, int L>
__device__ __forceinline__ void accumulate_rows(
    double (&acc)[kTiles][4], uint16_t* sg, uint8_t* sb, const Lanes& lanes,
    const uint8_t* __restrict__ bins, int64_t ld, int64_t n, int fa, int nf,
    const uint16_t* __restrict__ gh, int64_t r0, int64_t r1) {
  for (int64_t r = r0; r < r1; r += kChunk) {
    __syncthreads();                       // the last chunk has been read
    stage<L>(sg, sb, bins, ld, n, fa, nf, gh, r);
    __syncthreads();
    float c[kTiles][4];
#pragma unroll
    for (int tl = 0; tl < kTiles; ++tl)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[tl][i] = 0.f;
    mma_chunk<V>(c, sg, sb, lanes);
#pragma unroll
    for (int tl = 0; tl < kTiles; ++tl)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[tl][i] += (double)c[tl][i];
  }
}

// Add this thread's sums into out, the [6, lanes] float64 accumulator of
// one slot.  Zeros are skipped (a NaN is not zero, so it is added).
__device__ __forceinline__ void flush(double* __restrict__ out,
                                      const double (&acc)[kTiles][4],
                                      int lb0, int lanes) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  if (t == 3) return;                      // channels 6 and 7 are padding
#pragma unroll
  for (int tl = 0; tl < kTiles; ++tl) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lane = lb0 + warp * kWarpLanes + tl * 16 + g + 8 * (i >> 1);
      const int ch = 2 * t + (i & 1);
      const double v = acc[tl][i];
      if (lane < lanes && v != 0.0) atomicAdd(out + ch * lanes + lane, v);
    }
  }
}

// Rows 6 and 7 of the staged gh are the padding of mma's N = 8.
__device__ __forceinline__ void zero_gh_padding(uint16_t* sg) {
  for (int i = threadIdx.x; i < 2 * kChunk; i += kThreads)
    sg[6 * kChunk + i] = 0;
}

// ---------------------------------------------------------------------------
// The int8 body (lightgbm_tpu/ops/onehot_variants.py::_contrib_int8).
//
// The nine int8 rows q (3 levels x 3 channels, quantized per block of rows
// by onehot_quant.cu) times the int8 one-hot: mma.sync.m16n8k32, int8
// inputs, int32 sums, each exact.  Lanes on M (16 a tile), rows on K (32 a
// step), channels on N in two n8 tiles: channels 0-7, and channel 8 with
// seven zero rows.  Thread (g, t) builds A, the one-hot of lanes g and g+8
// for rows 4t..4t+3 and 16+4t..16+4t+3 of the step: four consecutive rows'
// bins are one 32-bit word of the [feature][row] staged bytes (byte i is
// row 4t+i, the PTX fragment's element order), and __vcmpeq4 compares all
// four with the lane's bin at once.
//
// Each staged chunk (128 rows) lies inside one quantization block (every
// block is a multiple of 128 rows), so its int32 sums fold into float64 by
// that block's scales: acc += sum * s[block][channel], zero sums too, so a
// NaN or infinite scale reaches every lane, as acc * s does in the Pallas
// kernel.  The float64 sums live in shared memory, a [9][kBlockLanes]
// array whose entries each belong to one thread (no races, no atomics),
// which leaves the registers to the mma sums.  They leave the CTA as
// hi = level 1 (channels 0-2 -> rows 0-2) and lo = levels 2 + 3 (channels
// 3-5 and 6-8 -> rows 3-5) of the [6, lanes] output, so finish_hist is
// the bf16 bodies'.
// ---------------------------------------------------------------------------

constexpr int kQRows = 16;                          // 9 channel rows + pad
constexpr int kQBytes = kQRows * kChunk;            // staged q
constexpr int kFaccBytes = 9 * kBlockLanes * 8;     // float64 sums

// d += A(16 x 32, s8, row) * B(32 x 8, s8, col), s32 sums
__device__ __forceinline__ void mma16832(int (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// int8 one-hot of four rows' bins (the bytes of v) against lane bin j;
// j < 0 marks a lane with no feature, which matches nothing
__device__ __forceinline__ uint32_t onehot4(uint32_t v, int j) {
  return j < 0 ? 0u : (__vcmpeq4(v, (uint32_t)j * 0x01010101u) & 0x01010101u);
}

// Stage rows [r0, r0 + kChunk) of q ([9, n] int8) as [channel][row] bytes;
// rows >= n read as zero.
__device__ __forceinline__ void stage_q(uint8_t* sq,
                                        const int8_t* __restrict__ q,
                                        int64_t n, int64_t r0) {
  for (int i = threadIdx.x; i < 9 * kChunk; i += kThreads) {
    const int c = i / kChunk, r = i - c * kChunk;
    const int64_t row = r0 + r;
    sq[i] = row < n ? (uint8_t)q[c * n + row] : (uint8_t)0;
  }
}

// Rows 9-15 of the staged q are the padding of the second n8 tile.
__device__ __forceinline__ void zero_q_padding(uint8_t* sq) {
  for (int i = threadIdx.x; i < (kQRows - 9) * kChunk; i += kThreads)
    sq[9 * kChunk + i] = 0;
}

// The staged chunk's int32 sums: c[tile][n-tile][fragment].
__device__ __forceinline__ void mma_chunk_int8(int (&c)[kTiles][2][4],
                                               const uint8_t* sq,
                                               const uint8_t* sb,
                                               const Lanes& L) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll 1
  for (int ks = 0; ks < kChunk; ks += 32) {
    const uint8_t* qp = sq + g * kChunk + ks + 4 * t;
    const uint32_t b0 = ld32(qp), b1 = ld32(qp + 16);
    const uint32_t b2 = ld32(qp + 8 * kChunk), b3 = ld32(qp + 8 * kChunk + 16);
#pragma unroll
    for (int tl = 0; tl < kTiles; ++tl) {
      const uint8_t* p0 = sb + L.off[tl][0] + ks + 4 * t;   // lane g
      const uint8_t* p1 = sb + L.off[tl][1] + ks + 4 * t;   // lane g + 8
      const int j0 = L.bin[tl][0], j1 = L.bin[tl][1];
      const uint32_t a0 = onehot4(ld32(p0), j0);
      const uint32_t a1 = onehot4(ld32(p1), j1);
      const uint32_t a2 = onehot4(ld32(p0 + 16), j0);
      const uint32_t a3 = onehot4(ld32(p1 + 16), j1);
      mma16832(c[tl][0], a0, a1, a2, a3, b0, b1);
      mma16832(c[tl][1], a0, a1, a2, a3, b2, b3);
    }
  }
}

// The float64 sums this thread owns: channels 2t and 2t+1 (and 8, for
// t == 0) of its lanes g and g + 8 in each tile.  fn(channel, local lane).
template <typename Fn>
__device__ __forceinline__ void for_owned(Fn fn) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  for (int h = 0; h < (t == 0 ? 3 : 2); ++h) {
    const int ch = h < 2 ? 2 * t + h : 8;
#pragma unroll
    for (int tl = 0; tl < kTiles; ++tl) {
      fn(ch, warp * kWarpLanes + tl * 16 + g);
      fn(ch, warp * kWarpLanes + tl * 16 + g + 8);
    }
  }
}

__device__ __forceinline__ void zero_facc(double* facc) {
  for_owned([&](int ch, int ll) { facc[ch * kBlockLanes + ll] = 0.0; });
}

// Fold one chunk's int32 sums into facc by the chunk's block scales sc[9].
__device__ __forceinline__ void fold_int8(double* facc,
                                          const int (&c)[kTiles][2][4],
                                          const float* __restrict__ sc) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const double s0 = sc[2 * t], s1 = sc[2 * t + 1];
  double* f0 = facc + (2 * t) * kBlockLanes + warp * kWarpLanes + g;
  double* f1 = f0 + kBlockLanes;
#pragma unroll
  for (int tl = 0; tl < kTiles; ++tl) {
    f0[tl * 16] += (double)c[tl][0][0] * s0;
    f1[tl * 16] += (double)c[tl][0][1] * s1;
    f0[tl * 16 + 8] += (double)c[tl][0][2] * s0;
    f1[tl * 16 + 8] += (double)c[tl][0][3] * s1;
  }
  if (t == 0) {
    const double s8 = sc[8];
    double* f8 = facc + 8 * kBlockLanes + warp * kWarpLanes + g;
#pragma unroll
    for (int tl = 0; tl < kTiles; ++tl) {
      f8[tl * 16] += (double)c[tl][1][0] * s8;
      f8[tl * 16 + 8] += (double)c[tl][1][2] * s8;
    }
  }
}

// Stage and multiply rows [r0, r1) chunk by chunk, folding each chunk into
// facc by the scales of its block (row / qbr).  Every thread must call it.
template <int L>
__device__ __forceinline__ void accumulate_rows_int8(
    double* facc, uint8_t* sq, uint8_t* sb, const Lanes& lanes,
    const uint8_t* __restrict__ bins, int64_t ld, int64_t n, int fa, int nf,
    const int8_t* __restrict__ q, const float* __restrict__ scales, int qbr,
    int64_t r0, int64_t r1) {
  for (int64_t r = r0; r < r1; r += kChunk) {
    __syncthreads();                       // the last chunk has been read
    stage_q(sq, q, n, r);
    stage_bins<L>(sb, bins, ld, n, fa, nf, r);
    __syncthreads();
    int c[kTiles][2][4];
#pragma unroll
    for (int tl = 0; tl < kTiles; ++tl)
#pragma unroll
      for (int i = 0; i < 8; ++i) c[tl][i >> 2][i & 3] = 0;
    mma_chunk_int8(c, sq, sb, lanes);
    fold_int8(facc, c, scales + (r / qbr) * 9);
  }
}

// Add this thread's float64 sums to out, the [6, lanes] float64
// accumulator of one slot (hi = level 1, lo = levels 2 and 3), and zero
// them.  Zeros are skipped (a NaN is not zero, so it is added).
__device__ __forceinline__ void flush_int8(double* __restrict__ out,
                                           double* facc, int lb0,
                                           int lanes) {
  for_owned([&](int ch, int ll) {
    double& v = facc[ch * kBlockLanes + ll];
    const int lane = lb0 + ll, row = ch < 6 ? ch : ch - 3;
    if (lane < lanes && v != 0.0) atomicAdd(out + row * lanes + lane, v);
    v = 0.0;
  });
}

}  // namespace lgbt_oh

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
