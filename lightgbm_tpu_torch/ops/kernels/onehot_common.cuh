// Shared pieces of the one-hot (row-wise) histogram kernels
// (onehot_full.cu, onehot_leaves.cu): the seven bf16-pair one-hot bodies
// of lightgbm_tpu/ops/onehot_variants.py, their tensor-core tile product
// and the asynchronous staging that feeds it, and the int8 body (the last
// part of this file).
//
// The function: out[c][lane] = sum over rows r of gh[c][r] * onehot(lane, r)
// where gh is the [6, N] bf16 (hi, lo) split of (g*m, h*m, m) and
// onehot(lane, r) is 1 when row r's bin for the lane's feature equals the
// lane's bin id.  The lane map is lane = feature * lpf + bin, lpf being the
// lanes of one feature (Bp, a multiple of 128, for the unpacked variants;
// B, a power of two that divides 128, for `packed`), so feature = lane /
// lpf and bin = lane % lpf.  A bin that no lane of its feature carries (>=
// Bp, or >= B under packing) matches nothing.
//
// Bins are u8 or u16 (a feature of more than 256 bins, or an EFB bundle):
// every kernel is a template on the bin type T, and u16 serves the four
// bodies the JAX package admits above 256 bins (base, i16cmp, staged,
// int8).  At u16 a step's four rows are one 64-bit word; base and i16cmp
// compare its halfwords, staged and int8 first map each bin to its place
// in the warp's 128 lanes as a byte (rel_bytes) and then build as at u8.
//
// Tile product: mma.sync.m16n8k16, bf16 inputs, f32 sums.  The one-hot
// lanes go on M (16 lanes a tile, 8 tiles a warp), the rows on K (16 rows
// a step) and the six channel rows on N (8, two of them zero) -- the TPU
// kernel put gh on M only because the MXU's sublanes are 8 wide.
//
// On an H100 the instructions that build the one-hot fragment take about
// half of a kernel's time and the mma about a quarter
// (scripts/torch_onehot_ablation.py), far above the tensor cores' floor
// (0.116 ms a full pass at 1M x 28, B = 256) and the bytes' (0.012 ms).
// The design spends as few build instructions as it can:
//
// * Rows inside a K step may go in any order, so thread (g, t) takes rows
//   4t..4t+3 of the step for both fragments: A's k = 2t, 2t+1 are rows
//   4t, 4t+1 and k = 2t+8, 2t+9 are rows 4t+2, 4t+3, and B's two
//   registers are one 64-bit load of gh at row 4t.  One 32-bit shared
//   load (u16: 64-bit) then gives the thread its four bins of the step.
//   A warp's 128 lanes are 128-aligned and an unpacked feature's lanes are
//   a multiple of 128, so the warp's lanes lie in one feature and that
//   word serves all 8 tiles; the lane bin ids follow from the tile
//   index (tile tl, thread g: j = jb + 16 tl and j + 8, jb = the warp's
//   first bin + g).  `packed` loads a word per feature of the warp when
//   B >= 16 (a tile lies in one feature) and builds its tiles as base
//   does, or a word per tile and lane half when a tile spans features
//   (B <= 8).
// * Each body builds its registers from that word in its own compare
//   domain and hoists what no tile changes:
//
//   base, packed  int32 compare of each row's bin with j
//   bf16cmp       bf16 compare (__heq2) of the rows' bins with j
//   i16cmp        int16 SIMD compare of two rows' bins with j
//   u8cmp         uint8 SIMD compare of the four rows' bins with j
//   sub1abs       max(0, 1 - |b - j|) in bf16 arithmetic
//   staged        bin = 16 hi + lo: the lo-digit one-hot of the four rows
//                 for lanes g and g + 8 is built once per step (it is the
//                 same in every tile); each tile has one hi digit, so a
//                 tile costs one SIMD byte compare of the four rows' hi
//                 digits (>= the tile's, shared with the next tile, which
//                 needs >= its own), two byte permutes into halfword
//                 masks and four three-input ANDs (the product of two 0/1
//                 bf16 values is the AND of their bits)
//
//   Each one-hot element is exactly 0 or 1 and each product exact, so
//   every body gives the same sums.
// * Staging: a CTA walks its 128-row chunks through kStages shared-memory
//   buffers filled by cp.async (16-byte copies, addresses fixed per
//   thread), so chunk i+1's and i+2's loads fly while chunk i multiplies.
//   The kernels stage grad, hess and mask as float rows and split them
//   into the six bf16 rows in shared memory (no prep pass in device
//   memory).  The feature-major bins ([f, ld] bytes) land as
//   [feature][row] bytes; the row-major ones ([n, ld]: onehot_leaves,
//   rowmajor) land as the rows lie and are transposed to [feature][row]
//   in shared memory (rows too wide for the buffers, or an unaligned
//   matrix, are read straight from global memory instead), in the same
//   phase as the split, before a second barrier.  The bf16 rows are
//   padded to kGhStride, so the eight rows g of a fragment load fall in
//   distinct banks.
// * Grid: as many CTAs as the card holds at once (the occupancy
//   calculator's count), each with an equal run of chunks: no second,
//   partly empty wave.
//
// Accumulation: a CTA owns kBlockLanes lanes and a range of chunks; the
// tile sums of one chunk stay in f32 mma registers (at most kChunk rows
// per lane, which in practice sum exactly in f32; the chunk's first mma
// takes a zero accumulator), then fold into float64 registers.  The
// float64 sums leave the CTA through float64 global atomics and the
// wrapper rounds to float32 once, after adding hi and lo, as the plain
// version does.  A non-finite gh value reaches every lane of
// its channel (0 * NaN is NaN in the tensor cores), as in the Pallas
// kernels.
//
// The int8 body (the last part of this file, with its own design notes)
// takes the same grid, lane map and bin staging with q in place of gh:
// mma.sync.m16n8k32 on a u8 one-hot built as `staged` builds it, one
// 64-bit bin load and one 64-bit q load a thread per 32-row step shared
// by the 8 tiles, int32 sums kept across a quantization block and folded
// into float64 shared memory once a block.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lgbt_oh {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTiles = 8;                             // 16-lane tiles a warp
constexpr int kWarpLanes = kTiles * 16;               // 128
constexpr int kBlockLanes = kWarps * kWarpLanes;      // 512 lanes a CTA
constexpr int kChunk = 128;                           // rows staged at once
// registers: at most 168 a thread, so that three CTAs share an SM (the
// sweep of 1, 3 and 4 on the card: 3 is fastest; 4 spills)
constexpr int kMinBlocks = 3;
constexpr int kUnroll = 4;                            // 16-row steps
constexpr int kStages = 3;                            // cp.async buffers
constexpr int kGhStride = kChunk + 16;                // bf16, padded row
constexpr int kGhStageBytes = 8 * kGhStride * 2;      // staged gh, 8 rows
// widest row-major row staged as it lies (wider ones are read directly)
constexpr int kMaxRawLd = 256;

enum Variant { kBase = 0, kBf16Cmp, kI16Cmp, kU8Cmp, kSub1Abs, kStaged,
               kPacked, kInt8, kNumVariants };
enum Layout { kFeatMajor = 0, kRowMajor = 1 };

constexpr uint32_t kOneLo = 0x3F80u;        // bf16 1.0 in the low half
constexpr uint32_t kOneHi = 0x3F800000u;    // bf16 1.0 in the high half
constexpr uint32_t kOnes = kOneLo | kOneHi;
constexpr uint32_t kRep = 0x01010101u;      // a byte in all four bytes

// the bits of a bf16 pair (low half first); by the raw struct, not a byte
// copy, which the compiler may lower to byte conversions
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  const __nv_bfloat162_raw r = v;
  return (uint32_t)r.x | ((uint32_t)r.y << 16);
}

__device__ __forceinline__ uint32_t pair(bool lo, bool hi) {
  return (lo ? kOneLo : 0u) | (hi ? kOneHi : 0u);
}

// PTX prmt (default mode) of {0, a}: selector nibble i picks result byte
// i -- 0..3 a byte of a, 4..7 zero; with its top bit set (8 + k) the
// sign bit of byte k fills the result byte
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(0u), "r"(sel));
  return d;
}

// prmt of {b, a}: selector nibbles 0..3 pick a byte of a, 4..7 of b
__device__ __forceinline__ uint32_t prmt2(uint32_t a, uint32_t b,
                                          uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// u16: four rows' bins (w.x rows 0, 1; w.y rows 2, 3; the earlier row in
// the low half) as their places in the warp's 128 lanes, one byte a row:
// bin - base (base: the warp's first bin, in both halfwords), or 0xFF
// where that is not below 256 -- a bin below base wraps to a halfword
// above it, so the min catches both sides.  A byte >= 128 has a hi digit
// >= 8, which no tile of the warp takes, and a lane's lo digit is g or g +
// 8 as at u8 (base is a multiple of 128), so staged and int8 build from
// these bytes as they build from u8 bins, on the warp's first hi digit 0.
__device__ __forceinline__ uint32_t rel_bytes(uint2 w, uint32_t base) {
  const uint32_t x = __vminu2(__vsub2(w.x, base), 0x00FF00FFu);
  const uint32_t y = __vminu2(__vsub2(w.y, base), 0x00FF00FFu);
  return prmt2(x, y, 0x6420);
}

// A step's bins of rows 4t..4t+3: one 32-bit word of u8 bins (byte i is
// row 4t+i), or one 64-bit word of u16 bins
template <typename T>
struct Word4;
template <>
struct Word4<uint8_t> {
  using type = uint32_t;
};
template <>
struct Word4<uint16_t> {
  using type = uint2;
};

__device__ __forceinline__ uint32_t load4(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint2 load4(const uint16_t* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// d += A(16 x 16, bf16, row) * B(16 x 8, bf16, col), f32 sums; with
// kFirst, d = A * B (a zero accumulator operand, so a chunk's sums need
// no zeroing first)
template <bool kFirst = false>
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  if (kFirst)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.f));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// The bodies.  A step's word w holds the bins of rows 4t..4t+3 (byte i is
// row 4t+i).  Step<V> is what the body derives from w once per step;
// tile<V>(s, tl, a) writes the four A registers of tile tl:
//   a[0] = lane g, rows 4t, 4t+1      a[1] = lane g+8, rows 4t, 4t+1
//   a[2] = lane g, rows 4t+2, 4t+3    a[3] = lane g+8, rows 4t+2, 4t+3
// (the earlier row in the low half).  Lane bin ids: j = jb + 16 tl (lane
// g) and j + 8 (lane g + 8).
// ---------------------------------------------------------------------------

// per-thread constants of the unpacked bodies, derived from jb
struct Ids {
  int jb;                 // lane g's bin id in tile 0
  uint32_t hb;            // staged u8: the warp's first hi digit, each byte
  uint32_t lo_g;          // staged: g in each byte
  uint32_t base;          // staged u16: the warp's first bin, each halfword
  __nv_bfloat162 jg, j8;  // bf16cmp, sub1abs: {jb, jb}, {jb + 8, jb + 8}
};

__device__ __forceinline__ Ids make_ids(int jb) {
  const int g = (threadIdx.x & 31) >> 2;
  Ids d;
  d.jb = jb;
  d.hb = (uint32_t)(jb >> 4) * kRep;     // u8: jb - g is 0 or 128: 0 or 8
  d.lo_g = (uint32_t)(jb & 15) * kRep;   // = g
  d.base = (uint32_t)(jb - g) * 0x00010001u;
  d.jg = __float2bfloat162_rn((float)jb);
  d.j8 = __float2bfloat162_rn((float)(jb + 8));
  return d;
}

template <int V>
struct Step;

// base: int32 compares of each row's bin, less jb, with 16 tl and 16 tl + 8
template <>
struct Step<kBase> {
  int d0, d1, d2, d3;
  __device__ __forceinline__ Step(uint32_t w, int jb) {
    d0 = (int)(w & 0xFFu) - jb;
    d1 = (int)((w >> 8) & 0xFFu) - jb;
    d2 = (int)((w >> 16) & 0xFFu) - jb;
    d3 = (int)(w >> 24) - jb;
  }
  __device__ __forceinline__ Step(uint32_t w, const Ids& ids)
      : Step(w, ids.jb) {}
  // u16: the four halfwords
  __device__ __forceinline__ Step(uint2 w, const Ids& ids) {
    d0 = (int)(w.x & 0xFFFFu) - ids.jb;
    d1 = (int)(w.x >> 16) - ids.jb;
    d2 = (int)(w.y & 0xFFFFu) - ids.jb;
    d3 = (int)(w.y >> 16) - ids.jb;
  }
  __device__ __forceinline__ void tile(int tl, uint32_t (&a)[4]) const {
    const int c = 16 * tl, c8 = c + 8;
    a[0] = pair(d0 == c, d1 == c);
    a[1] = pair(d0 == c8, d1 == c8);
    a[2] = pair(d2 == c, d3 == c);
    a[3] = pair(d2 == c8, d3 == c8);
  }
};

// bins < 256 are exact in bf16, and so is every j + 16 tl
__device__ __forceinline__ void bins_bf16(uint32_t w, __nv_bfloat162& b01,
                                          __nv_bfloat162& b23) {
  b01 = __floats2bfloat162_rn((float)(w & 0xFFu), (float)((w >> 8) & 0xFFu));
  b23 = __floats2bfloat162_rn((float)((w >> 16) & 0xFFu), (float)(w >> 24));
}

__device__ __forceinline__ __nv_bfloat162 plus16(__nv_bfloat162 j, int tl) {
  return __hadd2(j, __float2bfloat162_rn(16.f * tl));
}

template <>
struct Step<kBf16Cmp> {
  __nv_bfloat162 b01, b23, jg, j8;
  __device__ __forceinline__ Step(uint32_t w, const Ids& ids)
      : jg(ids.jg), j8(ids.j8) {
    bins_bf16(w, b01, b23);
  }
  __device__ __forceinline__ void tile(int tl, uint32_t (&a)[4]) const {
    const __nv_bfloat162 j = plus16(jg, tl), k = plus16(j8, tl);
    a[0] = bits(__heq2(b01, j));
    a[1] = bits(__heq2(b01, k));
    a[2] = bits(__heq2(b23, j));
    a[3] = bits(__heq2(b23, k));
  }
};

// i16cmp: two rows' bins as the halves of one word, compared as int16
// (u16: the halfwords as loaded; jb + 16 tl + 8 < 2^15 at B <= 32,768)
template <>
struct Step<kI16Cmp> {
  uint32_t p01, p23;
  int jb;
  __device__ __forceinline__ Step(uint32_t w, const Ids& ids) : jb(ids.jb) {
    p01 = prmt(w, 0x4140);               // {b0, 0, b1, 0}
    p23 = prmt(w, 0x4342);
  }
  __device__ __forceinline__ Step(uint2 w, const Ids& ids)
      : p01(w.x), p23(w.y), jb(ids.jb) {}
  __device__ __forceinline__ void tile(int tl, uint32_t (&a)[4]) const {
    const uint32_t j = (uint32_t)(jb + 16 * tl) * 0x00010001u;
    const uint32_t k = j + 8 * 0x00010001u;
    a[0] = __vcmpeq2(p01, j) & kOnes;
    a[1] = __vcmpeq2(p01, k) & kOnes;
    a[2] = __vcmpeq2(p23, j) & kOnes;
    a[3] = __vcmpeq2(p23, k) & kOnes;
  }
};

// u8cmp: the four rows' bins compared as bytes at once; the byte masks
// become halfword masks by permutes
template <>
struct Step<kU8Cmp> {
  uint32_t w;
  int jb;
  __device__ __forceinline__ Step(uint32_t w_, const Ids& ids)
      : w(w_), jb(ids.jb) {}
  __device__ __forceinline__ void tile(int tl, uint32_t (&a)[4]) const {
    const uint32_t mg = __vcmpeq4(w, (uint32_t)(jb + 16 * tl) * kRep);
    const uint32_t m8 = __vcmpeq4(w, (uint32_t)(jb + 16 * tl + 8) * kRep);
    a[0] = prmt(mg, 0x1100) & kOnes;
    a[1] = prmt(m8, 0x1100) & kOnes;
    a[2] = prmt(mg, 0x3322) & kOnes;
    a[3] = prmt(m8, 0x3322) & kOnes;
  }
};

__device__ __forceinline__ uint32_t sub1abs(__nv_bfloat162 b,
                                            __nv_bfloat162 j) {
  const __nv_bfloat162 one = __float2bfloat162_rn(1.f);
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
  return bits(__hmax2(__hsub2(one, __habs2(__hsub2(b, j))), zero));
}

template <>
struct Step<kSub1Abs> {
  __nv_bfloat162 b01, b23, jg, j8;
  __device__ __forceinline__ Step(uint32_t w, const Ids& ids)
      : jg(ids.jg), j8(ids.j8) {
    bins_bf16(w, b01, b23);
  }
  __device__ __forceinline__ void tile(int tl, uint32_t (&a)[4]) const {
    const __nv_bfloat162 j = plus16(jg, tl), k = plus16(j8, tl);
    a[0] = sub1abs(b01, j);
    a[1] = sub1abs(b01, k);
    a[2] = sub1abs(b23, j);
    a[3] = sub1abs(b23, k);
  }
};

// A byte of x is <= 15.  Returns x + 0x7F in each byte, whose top bit is
// set exactly where the byte of x is not zero (no carry crosses a byte).
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return x + 0x7F7F7F7Fu;
}

// staged: lo[] = the lo-digit one-hot of the four rows for lanes g and
// g + 8, as bf16 pairs (built once per step); hi = the rows' hi digits,
// XOR the warp's first hi digit, so that tile tl's rows match where a
// byte equals tl.  Byte permutes with the sign-replicate selector (8 + i:
// byte i's top bit in all 8 bits) turn a byte's top bit into a halfword
// mask.
template <>
struct Step<kStaged> {
  uint32_t lo[4], hi;
  __device__ __forceinline__ Step(uint32_t w, const Ids& ids) {
    init(w, ids.lo_g, ids.hb);
  }
  // u16: the rows' places in the warp's lanes, as bytes
  __device__ __forceinline__ Step(uint2 w, const Ids& ids) {
    init(rel_bytes(w, ids.base), ids.lo_g, 0u);
  }
  __device__ __forceinline__ void init(uint32_t w, uint32_t lo_g,
                                       uint32_t hb) {
    const uint32_t xg = (w & 0x0F0F0F0Fu) ^ lo_g;         // 0 where lo == g
    const uint32_t ng = nonzero_bytes(xg);
    const uint32_t n8 = nonzero_bytes(xg ^ 0x08080808u);  // lo == g + 8
    lo[0] = ~prmt(ng, 0x9988) & kOnes;
    lo[1] = ~prmt(n8, 0x9988) & kOnes;
    lo[2] = ~prmt(ng, 0xBBAA) & kOnes;
    lo[3] = ~prmt(n8, 0xBBAA) & kOnes;
    hi = ((w >> 4) & 0x0F0F0F0Fu) ^ hb;
  }
  // the rows whose hi digit is >= tl: hi + (0x80 - tl) has its top bit
  // set exactly there (bytes <= 15, no carry)
  __device__ __forceinline__ uint32_t ge(int tl, uint32_t sel) const {
    return prmt(hi + (uint32_t)(0x80 - tl) * kRep, sel);
  }
  __device__ __forceinline__ void tile(int tl, uint32_t (&a)[4]) const {
    // equal to tl: >= tl and not >= tl + 1 (a hi digit >= 8 is a bin
    // >= Bp at Bp = 128, which no tile takes)
    const uint32_t g01 = tl == 0 ? ~0u : ge(tl, 0x9988);
    const uint32_t g23 = tl == 0 ? ~0u : ge(tl, 0xBBAA);
    const uint32_t n01 = ge(tl + 1, 0x9988), n23 = ge(tl + 1, 0xBBAA);
    a[0] = lo[0] & g01 & ~n01;
    a[1] = lo[1] & g01 & ~n01;
    a[2] = lo[2] & g23 & ~n23;
    a[3] = lo[3] & g23 & ~n23;
  }
};

// packed (int32 compares): the pair of one word's rows against lane bin j
// (j < 0: a lane with no feature, which matches nothing)
__device__ __forceinline__ uint32_t packed_pair(uint32_t w, int shift,
                                                int j) {
  return pair((int)((w >> shift) & 0xFFu) == j,
              (int)((w >> (shift + 8)) & 0xFFu) == j);
}

// ---------------------------------------------------------------------------
// The CTA's geometry and the per-chunk tile product.
// ---------------------------------------------------------------------------

// lane / lpf.  At u8 lpf is a power of two (128, 256, or packed B), and
// the kernels shift by lpf_log2, their argument: a value the compiler
// reads where it needs it (a quotient it computes stays in a register,
// which pushed the packed leaves kernel into spilling).  At u16 lpf is
// any multiple of 128: a division.
template <typename T>
__device__ __forceinline__ int lane_feature(int lane, int lpf,
                                            int lpf_log2) {
  if constexpr (sizeof(T) == 1)
    return lane >> lpf_log2;
  else
    return lane / lpf;
}

// The CTA's lanes [lb0, lb0 + kBlockLanes) read features [fa, fa + nf)
// (at lpf >= 1,024 part of one feature; the wrapper sizes the shared bin
// buffers by the largest nf of any CTA, histogram._cta_features_max).
template <typename T>
__device__ __forceinline__ void cta_features(int lb0, int f, int lpf,
                                             int lpf_log2, int* fa,
                                             int* nf) {
  *fa = lane_feature<T>(lb0, lpf, lpf_log2);
  const int fb =
      min(f, lane_feature<T>(lb0 + kBlockLanes - 1, lpf, lpf_log2) + 1);
  *nf = max(0, fb - *fa);
}

// What a thread needs about its lanes: its warp's first lane wl0, and the
// CTA's first feature fa.  Unpacked bodies: the warp's feature row in the
// staged bins (or -1: the warp's lanes have no feature) and jb.  packed
// (u8) reads lpf_log2.
struct Geo {
  int wl0, fa, f, lanes, lpf_log2;
  int frow;
  int jb;
};

template <typename T>
__device__ __forceinline__ Geo make_geo(int lb0, int lanes, int f, int lpf,
                                        int lpf_log2, int fa) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  Geo G;
  G.wl0 = lb0 + warp * kWarpLanes;
  G.fa = fa;
  G.f = f;
  G.lanes = lanes;
  G.lpf_log2 = lpf_log2;
  const int feat = lane_feature<T>(G.wl0, lpf, lpf_log2);
  G.frow = (G.wl0 < lanes && feat < f) ? feat - fa : -1;
  G.jb = G.wl0 - feat * lpf + g;
  return G;
}

// One 16-row step of the unpacked bodies: gp, bp point at the thread's
// rows 4t..4t+3 of the step in the staged gh and bins.
template <int V, bool kFirst, typename T>
__device__ __forceinline__ void step(float (&c)[kTiles][4],
                                     const uint16_t* gp, const T* bp,
                                     const Ids& ids) {
  const uint2 b = *reinterpret_cast<const uint2*>(gp);
  const Step<V> s(load4(bp), ids);
#pragma unroll
  for (int tl = 0; tl < kTiles; ++tl) {
    uint32_t a[4];
    s.tile(tl, a);
    mma16816<kFirst>(c[tl], a[0], a[1], a[2], a[3], b.x, b.y);
  }
}


// packed at B >= 16: a warp's 128 lanes start at a feature and hold
// kFeats = 128 / B features of kTpf = B / 16 tiles each, so a step loads
// one word per feature and builds each of its tiles as base does (bins
// less g against 16 k and 16 k + 8, k the tile's place in the feature).
// A feature >= f takes jb = 1024, which no bin minus it can match.
template <int kTpf, bool kFirst>
__device__ __forceinline__ void packed_step(float (&c)[kTiles][4],
                                            const uint16_t* gp,
                                            const uint8_t* sb,
                                            const int (&off)[kTiles / kTpf],
                                            const int (&jb)[kTiles / kTpf]) {
  const uint2 b = *reinterpret_cast<const uint2*>(gp);
#pragma unroll
  for (int fi = 0; fi < kTiles / kTpf; ++fi) {
    const Step<kBase> s(*reinterpret_cast<const uint32_t*>(sb + off[fi]),
                        jb[fi]);
#pragma unroll
    for (int k = 0; k < kTpf; ++k) {
      uint32_t a[4];
      s.tile(k, a);
      mma16816<kFirst>(c[fi * kTpf + k], a[0], a[1], a[2], a[3], b.x, b.y);
    }
  }
}

template <int kTpf>
__device__ __forceinline__ void mma_chunk_packed(float (&c)[kTiles][4],
                                                 const uint16_t* sg,
                                                 const uint8_t* sb,
                                                 const Geo& G) {
  constexpr int kFeats = kTiles / kTpf;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int f0 = G.wl0 >> G.lpf_log2;     // the warp's first feature
  int off[kFeats], jb[kFeats];
#pragma unroll
  for (int fi = 0; fi < kFeats; ++fi) {
    const bool ok = f0 + fi < G.f;
    off[fi] = (ok ? f0 + fi - G.fa : 0) * kChunk + 4 * t;
    jb[fi] = ok ? g : 1024;
  }
  const uint16_t* gp = sg + g * kGhStride + 4 * t;
  packed_step<kTpf, true>(c, gp, sb, off, jb);
#pragma unroll kUnroll
  for (int ks = 16; ks < kChunk; ks += 16)
    packed_step<kTpf, false>(c, gp + ks, sb + ks, off, jb);
}

// packed at B <= 8: a tile spans 16 / B features, so lanes g and g + 8
// of a tile may read different features.  Each tile reads the word of
// lane g's feature and of lane g + 8's; the lane table is rebuilt per
// chunk from the tile index.
__device__ __forceinline__ void packed_chunk(float (&c)[kTiles][4],
                                             const uint16_t* sg,
                                             const uint8_t* sb,
                                             const Geo& G) {
  if (G.lpf_log2 >= 6) return mma_chunk_packed<4>(c, sg, sb, G);
  if (G.lpf_log2 == 5) return mma_chunk_packed<2>(c, sg, sb, G);
  if (G.lpf_log2 == 4) return mma_chunk_packed<1>(c, sg, sb, G);
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int bmask = (1 << G.lpf_log2) - 1;
  int off[kTiles][2], jj[kTiles][2];
#pragma unroll
  for (int tl = 0; tl < kTiles; ++tl) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lane = G.wl0 + tl * 16 + g + 8 * h;
      const int feat = lane >> G.lpf_log2;
      const bool ok = lane < G.lanes && feat < G.f;
      off[tl][h] = (ok ? feat - G.fa : 0) * kChunk + 4 * t;
      jj[tl][h] = ok ? (lane & bmask) : -1;
    }
  }
  const uint16_t* gp = sg + g * kGhStride + 4 * t;
#pragma unroll 1
  for (int ks = 0; ks < kChunk; ks += 16) {
    const uint2 b = *reinterpret_cast<const uint2*>(gp + ks);
#pragma unroll
    for (int tl = 0; tl < kTiles; ++tl) {
      const uint32_t w0 =
          *reinterpret_cast<const uint32_t*>(sb + off[tl][0] + ks);
      const uint32_t w1 =
          *reinterpret_cast<const uint32_t*>(sb + off[tl][1] + ks);
      const int j0 = jj[tl][0], j1 = jj[tl][1];
      const uint32_t a0 = packed_pair(w0, 0, j0), a1 = packed_pair(w1, 0, j1),
                     a2 = packed_pair(w0, 16, j0),
                     a3 = packed_pair(w1, 16, j1);
      if (ks == 0)
        mma16816<true>(c[tl], a0, a1, a2, a3, b.x, b.y);
      else
        mma16816(c[tl], a0, a1, a2, a3, b.x, b.y);
    }
  }
}

// The staged chunk's tile sums (replacing c): sg is the chunk's gh
// ([8][kGhStride] bf16), sb its bins ([feature][kChunk] of T).  Called
// only by a warp whose lanes have a feature (G.frow >= 0).
template <int V, typename T>
__device__ __forceinline__ void mma_chunk(float (&c)[kTiles][4],
                                          const uint16_t* sg, const T* sb,
                                          const Geo& G, const Ids& ids) {
  if constexpr (V == kPacked) {
    packed_chunk(c, sg, sb, G);             // u8 only
  } else {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const uint16_t* gp = sg + g * kGhStride + 4 * t;
    const T* bp = sb + G.frow * kChunk + 4 * t;
    step<V, true>(c, gp, bp, ids);
#pragma unroll kUnroll
    for (int ks = 16; ks < kChunk; ks += 16)
      step<V, false>(c, gp + ks, bp + ks, ids);
  }
}

__device__ __forceinline__ void zero_acc(double (&acc)[kTiles][4]) {
#pragma unroll
  for (int tl = 0; tl < kTiles; ++tl)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[tl][i] = 0.0;
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

// ---------------------------------------------------------------------------
// Asynchronous staging.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// What a CTA reads.  bins: [f, ld] (kFeatMajor; rows of a multiple of 16
// bytes, at least the rows rounded up to kChunk) or [n, ld] (kRowMajor) of
// the kernel's bin type T, addressed in bytes here; grad, hess and mask:
// [n] float32 each, 16-byte aligned, split into the (hi, lo) bf16 pair of
// (g*m, h*m, m) in shared memory as each chunk lands; the CTA's features
// [fa, fa + nf).  raw: the bytes of one row-major chunk staged as it lies
// (kChunk * ld * sizeof(T)), or 0 to read the bins straight from global
// memory.
struct Src {
  const uint8_t* bins;
  int64_t ld, n;
  const float* g;
  const float* h;
  const float* m;
  int fa, nf, raw;
};

// Shared memory: kStages buffers of [float rows | bins], then the current
// chunk's bf16 rows ([8][kGhStride]) and (row-major only) its transposed
// bins, [nf_max][kChunk] of esz-byte bins.
constexpr int kRowsBytes = 3 * kChunk * 4;

__host__ __device__ __forceinline__ int stage_bytes(int layout, int nf_max,
                                                    int raw, int esz) {
  return kRowsBytes + (layout == kFeatMajor ? nf_max * kChunk * esz : raw);
}

__host__ __device__ __forceinline__ int smem_bytes(int layout, int nf_max,
                                                   int raw, int esz) {
  return kStages * stage_bytes(layout, nf_max, raw, esz) + kGhStageBytes +
         (layout == kRowMajor ? nf_max * kChunk * esz : 0);
}

// One thread's share of a chunk's copies, fixed for the kernel: its
// 16-byte piece of the rows (bf16 shells: 4 rows of grad, hess or mask;
// int8: 16 rows of one q row), and its first piece of the feature-major
// bins (16 bytes of one feature: 16 u8 rows or 8 u16 rows), at an offset
// in the bins' part of the stage buffer; the chunk adds its row offset.
// A thread without a piece holds a null source.
struct Copies {
  const void* rsrc;   // rows: source at chunk 0
  int rdst;           // rows: byte offset in the stage buffer
  int rrow;           // rows: the piece's first row in the chunk
  const uint8_t* bsrc;
  int bdst;
};

// 16-byte pieces of one feature's chunk of feature-major bins
template <typename T>
constexpr int kBinPieces = kChunk * (int)sizeof(T) / 16;

template <typename T>
__device__ __forceinline__ void bin_copies(const Src& S, int L, Copies& K) {
  const int i = threadIdx.x;
  if (L == kFeatMajor && i < S.nf * kBinPieces<T>) {
    const int fl = i / kBinPieces<T>, q = i % kBinPieces<T>;
    K.bsrc = S.bins + (int64_t)(S.fa + fl) * S.ld * sizeof(T) + 16 * q;
    K.bdst = fl * kChunk * (int)sizeof(T) + 16 * q;
  }
}

template <typename T>
__device__ __forceinline__ Copies make_copies(const Src& S, int L) {
  const int i = threadIdx.x;
  Copies K{nullptr, 0, 0, nullptr, 0};
  if (i < 3 * (kChunk / 4)) {
    const int c = i >> 5, q = i & 31;
    K.rsrc = (c == 0 ? S.g : (c == 1 ? S.h : S.m)) + 4 * q;
    K.rdst = (c * kChunk + 4 * q) * 4;
    K.rrow = 4 * q;
  }
  bin_copies<T>(S, L, K);
  return K;
}

// Start the copies of chunk ci's bins into sb, the bins' part of a stage
// buffer.  The feature-major bins are copied whole (they reach the last
// chunk's end); the row-major rows as they lie, when S.raw > 0.
template <int L, typename T>
__device__ __forceinline__ void issue_bins(const Src& S, const Copies& K,
                                           uint8_t* sb, int64_t ci) {
  constexpr int kEsz = sizeof(T);
  const int64_t r0 = ci * kChunk;
  if (L == kFeatMajor) {
    if (K.bsrc != nullptr) cp16(sb + K.bdst, K.bsrc + r0 * kEsz);
    // more features than a chunk's pieces per thread (packed, B <= 8)
    for (int i = threadIdx.x + kThreads; i < S.nf * kBinPieces<T>;
         i += kThreads) {
      const int fl = i / kBinPieces<T>, q = i % kBinPieces<T>;
      cp16(sb + fl * kChunk * kEsz + 16 * q,
           S.bins + ((int64_t)(S.fa + fl) * S.ld + r0) * kEsz + 16 * q);
    }
  } else if (S.raw > 0) {
    // the chunk's rows as they lie: kChunk * ld * kEsz contiguous bytes,
    // a multiple of 16 from a 16-aligned start; a ragged last chunk copies
    // its whole 16-byte pieces and then its tail byte by byte
    const int64_t left = S.n - r0;
    const int bytes = (int)((left < kChunk ? left : kChunk) * S.ld * kEsz);
    const uint8_t* src = S.bins + r0 * S.ld * kEsz;
    const int whole = bytes >> 4;
    for (int i = threadIdx.x; i < whole; i += kThreads)
      cp16(sb + 16 * i, src + 16 * i);
    for (int i = (whole << 4) + threadIdx.x; i < bytes; i += kThreads)
      sb[i] = src[i];
  }
}

// Start the copies of chunk ci into one stage buffer.  A ragged last
// chunk copies the float rows' whole pieces below n and its tail row by
// row (rows >= n are never read).
template <int L, typename T>
__device__ __forceinline__ void issue(const Src& S, const Copies& K,
                                      uint8_t* st, int64_t ci) {
  const int64_t r0 = ci * kChunk;
  const int64_t left = S.n - r0;
  if (K.rsrc != nullptr && K.rrow + 4 <= left)
    cp16(st + K.rdst, reinterpret_cast<const float*>(K.rsrc) + r0);
  if (left < kChunk && threadIdx.x < 3 * 4) {
    const int c = threadIdx.x >> 2, r = (int)(left & ~3) + (threadIdx.x & 3);
    const float* src = c == 0 ? S.g : (c == 1 ? S.h : S.m);
    if (r < left)
      reinterpret_cast<float*>(st)[c * kChunk + r] = src[r0 + r];
  }
  issue_bins<L, T>(S, K, st + kRowsBytes, ci);
}

// The chunk's six bf16 rows from its staged float rows: hi = bf16(x) and
// lo = bf16(x - hi) of x = (g*m, h*m, m), as split_bf16_pair makes them;
// rows >= n are zero.  One row a thread.
__device__ __forceinline__ void split_rows(const Src& S, const float* sf,
                                           uint16_t* sg, int64_t ci) {
  const int r = threadIdx.x;
  float x[3] = {0.f, 0.f, 0.f};
  if (ci * kChunk + r < S.n) {
    const float m = sf[2 * kChunk + r];
    x[0] = sf[r] * m;
    x[1] = sf[kChunk + r] * m;
    x[2] = m;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const __nv_bfloat16 hi = __float2bfloat16_rn(x[c]);
    const __nv_bfloat16 lo = __float2bfloat16_rn(x[c] - __bfloat162float(hi));
    sg[c * kGhStride + r] = __bfloat16_as_ushort(hi);
    sg[(c + 3) * kGhStride + r] = __bfloat16_as_ushort(lo);
  }
}

// The bins of rows r..r+3 of row-major chunk ci for the CTA's feature fl,
// as one step word (Word4): from the staged rows, or (S.raw == 0) from
// global memory; rows >= n read as 0.
template <typename T>
__device__ __forceinline__ typename Word4<T>::type transpose_word(
    const Src& S, const uint8_t* raw, int64_t ci, int fl, int r) {
  const T* rb = reinterpret_cast<const T*>(raw);
  const T* gb = reinterpret_cast<const T*>(S.bins);
  uint32_t v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (S.raw > 0) {
      v[k] = rb[(r + k) * S.ld + S.fa + fl];
    } else {
      const int64_t row = ci * kChunk + r + k;
      v[k] = row < S.n ? gb[row * S.ld + S.fa + fl] : 0u;
    }
  }
  if constexpr (sizeof(T) == 1)
    return v[0] | (v[1] << 8) | (v[2] << 16) | (v[3] << 24);
  else
    return make_uint2(v[0] | (v[1] << 16), v[2] | (v[3] << 16));
}

// Row-major bins of chunk ci as [feature][row] bins in tb.
template <typename T>
__device__ __forceinline__ void transpose(const Src& S, const uint8_t* raw,
                                          T* tb, int64_t ci) {
  for (int i = threadIdx.x; i < S.nf * (kChunk / 4); i += kThreads) {
    const int fl = i >> 5, r = (i & 31) * 4;
    *reinterpret_cast<typename Word4<T>::type*>(tb + fl * kChunk + r) =
        transpose_word<T>(S, raw, ci, fl, r);
  }
}

// Multiply the CTA's chunks [c0, c1) into acc, kStages - 1 chunks' copies
// in flight while one multiplies.  use(ci), called once per chunk in
// order, says whether chunk ci counts (the same answer in every thread);
// it may flush and zero acc first.  Every thread of the CTA must call it.
template <int V, int L, typename T, typename Use>
__device__ __forceinline__ void run_chunks(const Src& S, uint8_t* smem,
                                           int sbytes, int64_t c0,
                                           int64_t c1, const Geo& geo,
                                           const Ids& ids,
                                           double (&acc)[kTiles][4],
                                           Use use) {
  // after the stages: the split rows, then the transposed bins
  uint16_t* sg = reinterpret_cast<uint16_t*>(smem + kStages * sbytes);
  T* tb = reinterpret_cast<T*>(smem + kStages * sbytes + kGhStageBytes);
  // rows 6, 7 of the bf16 rows: mma's N padding
  for (int i = threadIdx.x; i < 2 * kGhStride; i += kThreads)
    sg[6 * kGhStride + i] = 0;
  const Copies K = make_copies<T>(S, L);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (c0 + s < c1) issue<L, T>(S, K, smem + s * sbytes, c0 + s);
    cp_commit();
  }
  int s = 0;
  for (int64_t ci = c0; ci < c1; ++ci) {
    cp_wait<kStages - 2>();                // chunk ci has landed
    __syncthreads();                       // ... for all; chunk ci-1 done
    int sn = s + kStages - 1;
    if (sn >= kStages) sn -= kStages;
    if (ci + kStages - 1 < c1)
      issue<L, T>(S, K, smem + sn * sbytes, ci + kStages - 1);
    cp_commit();
    uint8_t* st = smem + s * sbytes;
    const bool on = use(ci);
    if (on) {
      split_rows(S, reinterpret_cast<const float*>(st), sg, ci);
      if (L == kRowMajor) transpose<T>(S, st + kRowsBytes, tb, ci);
    }
    __syncthreads();
    const T* sb = L == kRowMajor
                      ? tb
                      : reinterpret_cast<const T*>(st + kRowsBytes);
    if (on && geo.frow >= 0) {
      float c[kTiles][4];
      mma_chunk<V, T>(c, sg, sb, geo, ids);
#pragma unroll
      for (int tl = 0; tl < kTiles; ++tl)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[tl][i] += (double)c[tl][i];
    }
    if (++s == kStages) s = 0;
  }
  cp_wait<0>();
}

// ---------------------------------------------------------------------------
// Launch geometry (host).
// ---------------------------------------------------------------------------

// CTAs of kern, with smem bytes of dynamic shared memory, that the card
// holds at once.
template <typename K>
static inline int resident_ctas(K kern, int smem, int device,
                                int threads = kThreads) {
  int per_sm = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                smem);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
}

// log2 of a power of two (the lanes of a feature at u8); at u16 the
// kernels divide and do not read it
static inline int ilog2(int x) {
  int l = 0;
  while ((2 << l) <= x) ++l;
  return l;
}

// Split `units` units of rows over grid.x so that the whole grid (grid.y =
// nlb lane blocks) is resident at once: no second, partly empty wave.
// Returns the units per CTA; *gx the grid's x.
static inline long long split_units(long long units, int nlb, int resident,
                                    int* gx) {
  long long splits = resident / (nlb > 0 ? nlb : 1);
  if (splits < 1) splits = 1;
  if (splits > units) splits = units;
  const long long per = (units + splits - 1) / splits;
  *gx = (int)((units + per - 1) / per);
  return per;
}

// Set a kernel's dynamic shared memory limit when it needs more than the
// default 48 KB.
template <typename K>
static inline cudaError_t allow_smem(K kern, int smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(
                   kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
             : cudaSuccess;
}

// The bytes of one row-major chunk staged as it lies (rows of ld bins of
// esz bytes), or 0 when the bins are read straight from global memory:
// rows wider than kMaxRawLd bytes, a matrix that is not 16-byte aligned,
// or feature-major bins (staged by feature).
static inline int raw_bytes(int layout, long long ld, bool aligned,
                            int esz) {
  return (layout == kRowMajor && ld * esz <= kMaxRawLd && aligned)
             ? (int)(kChunk * ld * esz)
             : 0;
}

// Registers, spills and resident CTAs an SM of kern launched with smem
// bytes of dynamic shared memory (its limit raised as a launch raises it):
// out[0] registers a thread, out[1] static shared bytes, out[2] smem,
// out[3] local (spill) bytes a thread, out[4] CTAs an SM.
template <typename K>
static inline cudaError_t kernel_attrs(K kern, int smem, int* out,
                                       int threads = kThreads) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kern);
  if (e != cudaSuccess) return e;
  e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = smem;
  out[3] = (int)a.localSizeBytes;
  out[4] = per_sm;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The int8 body (lightgbm_tpu/ops/onehot_variants.py::_contrib_int8).
//
// The nine int8 rows q (3 levels x 3 channels, quantized per block of rows
// by onehot_quant.cu) times the one-hot: mma.sync.m16n8k32, u8 A (the
// one-hot), s8 B (q), int32 sums, each exact.  Lanes on M (16 a tile, 8
// tiles a warp), rows on K (32 a step), channels on N in two n8 tiles:
// eight channels, and the ninth beside seven zero columns (only threads
// g = 0 load it; the others multiply zeros).  Channels on M and lanes on N
// would take as many instructions (9 of 16 M rows used, as 9 of 16 N
// columns are here), so the lanes stay on M, as in the bf16 bodies.
//
// * Rows inside a step may go in any order, so thread (g, t) takes rows
//   8t..8t+7 of the step: A's k = 4t..4t+3 are rows 8t..8t+3 and k =
//   16+4t..16+4t+3 rows 8t+4..8t+7, and B's two registers are the same
//   rows of q row g.  One 64-bit load gives the step's two bin words (u16:
//   one 128-bit load, mapped to two byte words by rel_bytes), one 64-bit
//   load its q fragment.  A warp's 128 lanes lie in one feature (an int8
//   feature's Bp is a multiple of 128), so the words serve all 8 tiles, and
//   the lane bin ids follow from the tile index: tile tl, thread g takes
//   bins jb + 16 tl and jb + 16 tl + 8 (jb = the warp's first bin + g).
// * The one-hot as `staged` builds it (bin = 16 hi + lo): the lo-digit
//   masks of lanes g and g + 8 once a step; tile tl takes the rows whose hi
//   digit, XOR the warp's first, is >= tl and not >= tl + 1, a carry-free
//   add each (the >= mask is shared with the next tile); each A register
//   is then one three-input AND.  A matching byte is 0x80, read as u8, so
//   the sums are 128 times the one-hot's, which the fold scales back by
//   2^-7 (exact); |sum| <= 128 * 127 * the rows of a block < 2^31.
// * Staging: kStages cp.async buffers of [q: 9 rows of kQStride bytes |
//   bins], the bins as the bf16 shells stage them (feature-major as
//   [feature][row]; row-major as the rows lie, or not at all when too wide
//   or unaligned).  q is [9, ldq], ldq = n rounded up to kChunk and zero
//   past n (onehot_quant.cu), so each chunk of q is 72 whole 16-byte
//   pieces, at most one a thread.  A warp reads one feature, so in the
//   row-major shells each warp transposes its own feature's row of the
//   chunk (a word a thread, from the staged rows or from global memory)
//   into a [kChunk] buffer of its own, behind a __syncwarp: one barrier a
//   chunk in every shell.  The staged q rows are padded to kQStride bytes,
//   so that the eight rows g of a fragment load fall in distinct banks.
// * The int32 sums stay in registers across the CTA's rows of one
//   quantization block (chunk / cpb; a block is cpb whole chunks) and fold
//   into float64 once a block, and where the CTA's chunk range ends inside
//   one: acc += sum * s[block][channel] / 128, zero sums too, so a NaN or
//   infinite scale reaches every lane, as acc * s does in the Pallas
//   kernel.  Each sum times its scale is exact in float64.  The sums leave
//   the CTA as the [6, lanes] output's hi = level 1 (channels 0-2 -> rows
//   0-2) and lo = levels 2 + 3 (channels 3-5 and 6-8 -> rows 3-5), so
//   finish_hist is the bf16 bodies'.  q's rows are staged in the order
//   q_channel, so that thread t's two N columns are the level-2 and level-3
//   channels of output row 3 + t (t < 3) or channels 0 and 1 (t = 3), and
//   the ninth column is channel 2: each thread folds both of its columns
//   into the output rows' float64 sums, [6][kFaccStride] in shared memory,
//   each entry owned by one thread (no races), padded so that a warp's
//   four t fall in two bank halves; a flush adds six rows, not nine.
// ---------------------------------------------------------------------------

constexpr int kQStride = kChunk + 32;               // a staged q row, bytes
constexpr int kQStageBytes = 9 * kQStride;          // staged q of a chunk
constexpr int kFaccStride = kBlockLanes + 8;        // float64 sums, a row
constexpr int kFaccBytes = 6 * kFaccStride * 8;
constexpr uint32_t kTop = 0x80808080u;              // each byte's top bit
// registers: onehot_full's int8 kernels at most 168 a thread (3 CTAs an
// SM), onehot_leaves' at most 128 (4; it spills a few bytes there and is
// still faster): what the card's sweep of 2, 3 and 4 found fastest for
// each (scripts/torch_onehot_ablation.py --sweep, PERF.md)
constexpr int kInt8MinBlocks = 3;
constexpr int kInt8LeavesMinBlocks = 4;

// The channel of q held by staged row r (N column r; row 8 is the second
// n8 tile's column 0): 3, 6, 4, 7, 5, 8, 0, 1, 2
__host__ __device__ __forceinline__ int q_channel(int r) {
  return r < 6 ? 3 + (r >> 1) + 3 * (r & 1) : r - 6;
}

__host__ __device__ __forceinline__ int stage_bytes_int8(int layout,
                                                         int nf_max,
                                                         int raw, int esz) {
  return kQStageBytes + (layout == kFeatMajor ? nf_max * kChunk * esz : raw);
}

// Dynamic shared bytes of a launch of a variant's kernel with nf_max
// features a CTA (row-major rows of ld bins of esz bytes, 16-byte aligned
// or not).  int8: the float64 sums, the stage buffers, then (row-major)
// each warp's transposed bins.
static inline int launch_smem(int variant, int layout, int nf_max,
                              long long ld, bool aligned, int esz) {
  const int raw = raw_bytes(layout, ld, aligned, esz);
  if (variant == kInt8)
    return kFaccBytes +
           kStages * stage_bytes_int8(layout, nf_max, raw, esz) +
           (layout == kRowMajor ? kWarps * kChunk * esz : 0);
  return smem_bytes(layout, nf_max, raw, esz);
}

// d += A(16 x 32, u8, row) * B(32 x 8, s8, col), s32 sums
__device__ __forceinline__ void mma16832(int (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint2 ld64(const uint8_t* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// A step's bins of rows 8t..8t+7: two u8 words, or four of u16
__device__ __forceinline__ uint2 load8(const uint8_t* p) { return ld64(p); }
__device__ __forceinline__ uint4 load8(const uint16_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// a & b & ~c in one instruction (lop3's table: 0xF0 & 0xCC & ~0xAA).  Left
// to itself nvcc computed ~c by a second, negated add and the AND of b and
// ~c apart, which cost five instructions a tile and word where this
// costs three (scripts/torch_onehot_sass.py).
__device__ __forceinline__ uint32_t and_andnot(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x40;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// per-thread constants of the int8 body, from jb
struct Int8Ids {
  uint32_t lo_g, lo_g8;   // g and g + 8 in each byte
  uint32_t hb;            // u8: the warp's first hi digit (0 or 8), each byte
  uint32_t base;          // u16: the warp's first bin, each halfword
};

__device__ __forceinline__ Int8Ids make_int8_ids(int jb) {
  const int g = (threadIdx.x & 31) >> 2;
  Int8Ids d;
  d.lo_g = (uint32_t)g * kRep;
  d.lo_g8 = (uint32_t)(g + 8) * kRep;
  d.hb = (uint32_t)((jb - g) >> 4) * kRep;
  d.base = (uint32_t)(jb - g) * 0x00010001u;
  return d;
}

// What a step derives from its two bin words (word 0: rows 8t..8t+3, word
// 1: rows 8t+4..8t+7; byte i is the word's i-th row): lg, lh the rows
// whose lo digit is g, g + 8 (as each byte's top bit); hi the rows' hi
// digits XOR the warp's first.
struct Int8Step {
  uint32_t lg[2], lh[2], hi[2];
  __device__ __forceinline__ Int8Step(uint2 w, const Int8Ids& d) {
    init(w.x, w.y, d, d.hb);
  }
  // u16: the rows' places in the warp's lanes, as bytes
  __device__ __forceinline__ Int8Step(uint4 w, const Int8Ids& d) {
    init(rel_bytes(make_uint2(w.x, w.y), d.base),
         rel_bytes(make_uint2(w.z, w.w), d.base), d, 0u);
  }
  __device__ __forceinline__ void init(uint32_t w0, uint32_t w1,
                                       const Int8Ids& d, uint32_t hb) {
    const uint32_t v[2] = {w0, w1};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t lo = v[i] & 0x0F0F0F0Fu;
      lg[i] = ~nonzero_bytes(lo ^ d.lo_g) & kTop;
      lh[i] = ~nonzero_bytes(lo ^ d.lo_g8) & kTop;
      hi[i] = ((v[i] >> 4) & 0x0F0F0F0Fu) ^ hb;
    }
  }
  // the rows of word i whose hi digit is >= tl, as each byte's top bit:
  // hi + (0x80 - tl) carries into no other byte (bytes <= 15)
  __device__ __forceinline__ uint32_t ge(int i, int tl) const {
    return hi[i] + (uint32_t)(0x80 - tl) * kRep;
  }
  // tile tl's A: a[0] lane g and a[1] lane g + 8 over word 0's rows, a[2]
  // and a[3] over word 1's (a hi digit >= 8 is a bin no tile of the warp
  // takes: tile 7 excludes it)
  __device__ __forceinline__ void tile(int tl, uint32_t (&a)[4]) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t gp = tl == 0 ? ~0u : ge(i, tl), gn = ge(i, tl + 1);
      a[2 * i] = and_andnot(lg[i], gp, gn);
      a[2 * i + 1] = and_andnot(lh[i], gp, gn);
    }
  }
};

// Add the staged chunk's products to c[tile][n-tile][fragment]: sq the
// chunk's q ([9][kQStride] bytes), fb the warp's feature row of its bins
// ([kChunk] of T).
template <typename T>
__device__ __forceinline__ void mma_chunk_int8(int (&c)[kTiles][2][4],
                                               const uint8_t* sq,
                                               const T* fb,
                                               const Int8Ids& ids) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const uint8_t* qp = sq + g * kQStride + 8 * t;
  const uint8_t* q8 = sq + 8 * kQStride + 8 * t;
  const T* bp = fb + 8 * t;
#pragma unroll
  for (int ks = 0; ks < kChunk; ks += 32) {
    const uint2 b = ld64(qp + ks);
    uint2 b8 = make_uint2(0u, 0u);           // column 8 and seven zeros
    if (g == 0) b8 = ld64(q8 + ks);
    const Int8Step o(load8(bp + ks), ids);
#pragma unroll
    for (int tl = 0; tl < kTiles; ++tl) {
      uint32_t a[4];
      o.tile(tl, a);
      mma16832(c[tl][0], a[0], a[1], a[2], a[3], b.x, b.y);
      mma16832(c[tl][1], a[0], a[1], a[2], a[3], b8.x, b8.y);
    }
  }
}

__device__ __forceinline__ void zero_sums(int (&c)[kTiles][2][4]) {
#pragma unroll
  for (int tl = 0; tl < kTiles; ++tl)
#pragma unroll
    for (int i = 0; i < 8; ++i) c[tl][i >> 2][i & 3] = 0;
}

// The output rows of thread t's two N columns (the same row for t < 3).
__device__ __forceinline__ int row_a(int t) { return t < 3 ? 3 + t : 0; }
__device__ __forceinline__ int row_b(int t) { return t < 3 ? 3 + t : 1; }

// The float64 sums this thread owns: output rows row_a(t), row_b(t) (one
// row for t = 1, 2) and, for t == 0, row 2, of its lanes g and g + 8 in
// each tile.  fn(row, local lane).
template <typename Fn>
__device__ __forceinline__ void for_owned(Fn fn) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  for (int h = 0; h < (t == 1 || t == 2 ? 1 : 2); ++h) {
    const int row = h == 0 ? row_a(t) : (t == 3 ? 1 : 2);
#pragma unroll
    for (int tl = 0; tl < kTiles; ++tl) {
      fn(row, warp * kWarpLanes + tl * 16 + g);
      fn(row, warp * kWarpLanes + tl * 16 + g + 8);
    }
  }
}

__device__ __forceinline__ void zero_facc(double* facc) {
  for_owned([&](int row, int ll) { facc[row * kFaccStride + ll] = 0.0; });
}

// Fold a block's int32 sums into facc by the block's scales sc[9]: each
// sum is 128 times the one-hot's, and sum * (s / 128) is exact.  Columns
// 2t and 2t+1 go to rows row_a(t) and row_b(t), column 8 (t == 0) to row 2.
__device__ __forceinline__ void fold_int8(double* facc,
                                          const int (&c)[kTiles][2][4],
                                          const float* __restrict__ sc) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  constexpr double kInv = 1.0 / 128;
  const double sa = (double)sc[q_channel(2 * t)] * kInv;
  const double sb = (double)sc[q_channel(2 * t + 1)] * kInv;
  double* fa = facc + row_a(t) * kFaccStride + warp * kWarpLanes + g;
  double* fb = facc + row_b(t) * kFaccStride + warp * kWarpLanes + g;
#pragma unroll
  for (int tl = 0; tl < kTiles; ++tl) {
    fa[tl * 16] += (double)c[tl][0][0] * sa;
    fb[tl * 16] += (double)c[tl][0][1] * sb;
    fa[tl * 16 + 8] += (double)c[tl][0][2] * sa;
    fb[tl * 16 + 8] += (double)c[tl][0][3] * sb;
  }
  if (t == 0) {
    const double s2 = (double)sc[q_channel(8)] * kInv;
    double* f2 = facc + 2 * kFaccStride + warp * kWarpLanes + g;
#pragma unroll
    for (int tl = 0; tl < kTiles; ++tl) {
      f2[tl * 16] += (double)c[tl][1][0] * s2;
      f2[tl * 16 + 8] += (double)c[tl][1][2] * s2;
    }
  }
}

// Add this thread's float64 sums to out, the [6, lanes] float64
// accumulator of one slot (hi = level 1, lo = levels 2 and 3), and zero
// them.  Zeros are skipped (a NaN is not zero, so it is added).
__device__ __forceinline__ void flush_int8(double* __restrict__ out,
                                           double* facc, int lb0,
                                           int lanes) {
  for_owned([&](int row, int ll) {
    double& v = facc[row * kFaccStride + ll];
    const int lane = lb0 + ll;
    if (lane < lanes && v != 0.0) atomicAdd(out + row * lanes + lane, v);
    v = 0.0;
  });
}

// A thread's copies of q (staged row r's 16-byte piece p, from q row
// q_channel(r): threads 9 * 8) and of the feature-major bins.
template <typename T>
__device__ __forceinline__ Copies make_copies_int8(const Src& S, int L,
                                                   const int8_t* q,
                                                   int64_t ldq) {
  const int i = threadIdx.x;
  Copies K{nullptr, 0, 0, nullptr, 0};
  if (i < 9 * (kChunk / 16)) {
    const int r = i >> 3, p = i & 7;
    K.rsrc = q + q_channel(r) * ldq + 16 * p;
    K.rdst = r * kQStride + 16 * p;
  }
  bin_copies<T>(S, L, K);
  return K;
}

template <int L, typename T>
__device__ __forceinline__ void issue_int8(const Src& S, const Copies& K,
                                           uint8_t* st, int64_t ci) {
  if (K.rsrc != nullptr)
    cp16(st + K.rdst, reinterpret_cast<const int8_t*>(K.rsrc) + ci * kChunk);
  issue_bins<L, T>(S, K, st + kQStageBytes, ci);
}

// Multiply the CTA's chunks [c0, c1) in int32, kStages - 1 chunks' copies
// in flight while one multiplies, and fold the sums into facc by the scales
// of block chunk / cpb at the end of each block and of the range.
// use(blk), called in order at the first chunk of each block the range
// touches, says whether block blk counts (the same answer in every thread);
// it may flush facc first.  Every thread of the CTA must call it.
template <int L, typename T, typename Use>
__device__ __forceinline__ void run_chunks_int8(
    const Src& S, const int8_t* q, const float* __restrict__ scales, int cpb,
    uint8_t* smem, int sbytes, int64_t c0, int64_t c1, const Geo& geo,
    const Int8Ids& ids, double* facc, Use use) {
  // row-major: the warps' bins
  T* tb = reinterpret_cast<T*>(smem + kStages * sbytes);
  const int64_t ldq = (S.n + kChunk - 1) / kChunk * kChunk;
  const Copies K = make_copies_int8<T>(S, L, q, ldq);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (c0 + s < c1) issue_int8<L, T>(S, K, smem + s * sbytes, c0 + s);
    cp_commit();
  }
  int c[kTiles][2][4];
  zero_sums(c);
  int64_t blk = c0 / cpb;
  int sub = (int)(c0 - blk * cpb);          // chunk ci's place in its block
  bool on = false;
  int s = 0;
  for (int64_t ci = c0; ci < c1; ++ci) {
    cp_wait<kStages - 2>();                 // chunk ci has landed
    __syncthreads();                        // ... for all; chunk ci-1 done
    int sn = s + kStages - 1;
    if (sn >= kStages) sn -= kStages;
    if (ci + kStages - 1 < c1)
      issue_int8<L, T>(S, K, smem + sn * sbytes, ci + kStages - 1);
    cp_commit();
    const uint8_t* st = smem + s * sbytes;
    const T* fb =
        reinterpret_cast<const T*>(st + kQStageBytes) + geo.frow * kChunk;
    if (ci == c0 || sub == 0) on = use(blk);
    const bool last = ++sub == cpb || ci + 1 == c1;
    if (on && geo.frow >= 0) {
      if (L == kRowMajor) {
        const int lane = threadIdx.x & 31;
        T* wb = tb + (threadIdx.x >> 5) * kChunk;
        *reinterpret_cast<typename Word4<T>::type*>(wb + 4 * lane) =
            transpose_word<T>(S, st + kQStageBytes, ci, geo.frow, 4 * lane);
        __syncwarp();
        fb = wb;
      }
      mma_chunk_int8(c, st, fb, ids);
      if (last) {
        fold_int8(facc, c, scales + blk * 9);
        zero_sums(c);
      }
    }
    if (sub == cpb) {
      sub = 0;
      ++blk;
    }
    if (++s == kStages) s = 0;
  }
  cp_wait<0>();
}

}  // namespace lgbt_oh

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
