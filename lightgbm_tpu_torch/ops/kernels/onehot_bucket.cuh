// The bucketed design of the one-hot kernels at u16 widths (B > 256):
// onehot_full.cu (K1 and K3, both layouts, and K4's entry) and
// onehot_leaves.cu (K2) take it for the four u16 bodies (base, i16cmp,
// staged, int8); every u8 shape keeps the dense design of
// onehot_common.cuh (histogram.onehot_plan picks; onehot_design() forces
// one for timing).
//
// Why: at u16 a feature has Bp = nb * 128 lanes, and a warp's 128 lanes (a
// "bucket": bins [128 b, 128 b + 128), eight 16-lane tiles) are hit only by
// the rows whose bin lies in them.  The dense design runs every row
// through every bucket's one-hot build and 8 mma tiles, so at B = 1,024
// 7/8 of its work multiplies zeros, and at the EFB bundle width (nb = 21)
// 20/21.  Here a (row, feature) costs one 128-lane step-row, whatever Bp,
// and a step builds and multiplies only the tiles its rows fall in.
//
// A CTA of 8 warps owns buckets [b0, b0 + nbc) of one feature (nbc <= 8;
// a feature of more buckets takes ceil(nb / 8) CTAs along y) and a range
// of rows, which it walks in segments of at most 512 rows (4 chunks; a
// segment never crosses a leaves block, nor an int8 quantization block of
// 512 rows or more; int8 over smaller blocks: below):
//
// 1. Each thread holds two adjacent rows of the segment, loaded a segment
//    ahead of their use: their bins of the CTA's feature (read from the
//    matrix as stored, in both layouts), and grad, hess and mask (int8:
//    the nine q bytes), split into the bf16 pair in registers.
// 2. A stable counting sort by bin / 16 (bucket, then 16-lane tile):
//    seven ballots a row rank it among its warp's rows of its key; warp b
//    then turns bucket b's counts into places in the bucket's own region
//    of a compacted copy (no prefix runs across buckets), ordered by tile,
//    and each row lands there with its bin and its six bf16 values or
//    nine q bytes.  A bucket's rows are padded to whole steps (16 rows;
//    int8 32) with rows of zero gh on its last lane.  Rows outside the
//    CTA's buckets (bins >= Bp too) drop.
// 3. Warp b multiplies bucket b's rows (its "home" steps) with the body's
//    Step<V> / Int8Step build (rel_bytes maps a bin to its place in the
//    128 lanes), only on the tiles between a step's first and last row's,
//    keeping f32 tile sums across segments until 128 rows and then folding
//    them into float64 (registers; int8, whose int32 sums take the
//    registers, in shared memory, once a segment), as the dense design
//    does a chunk.  Skew
//    (Zipf bins, an EFB bundle's default bin): a home warp takes at most
//    one step over the mean share ceil(T / 8) of the segment's T steps;
//    a bucket's other steps go as runs of at most 128 rows, each to the
//    least-loaded warp (every warp works out the same dealing from the
//    buckets' counts), which writes the run's sums to a slot in shared
//    memory; after a barrier the home warp folds its bucket's slots in run
//    order.  Every sum is taken in one fixed order, so two calls give the
//    same bits.
// 4. A non-finite gh value must reach every lane of its channel (0 * NaN
//    is NaN in the tensor cores), which sorting it into one bucket would
//    lose: a segment that holds one (a barrier's OR) is not sorted but
//    multiplied densely, every bucket over all its rows and every tile, as
//    the dense design does.  int8 keeps the NaN in the block's scale, and
//    every home warp folds every segment, zero sums too, so it reaches
//    every lane.
//
// int8 over quantization blocks under 512 rows (bucket_cta_int8, the body
// kInt8Span, its own kernel instantiation: blocks of 512 rows or more,
// the leaves' included, keep bucket_cta above, whose segments hold one
// block).  Its int32 sums must be folded by their own block's scales, and
// the JAX package's blocks are small where the layout or the width asks
// for it (pallas_block_rows: 128 rows row-major at every u16 width,
// 128-384 feature-major above 1,024 bins).  A segment sorted one block at
// a time would pay the sort, the dealing and four barriers for 128 rows;
// so its segments keep the 512 rows of the others' and span up to four
// blocks:
// * the sort key carries the row's block in the segment, (block, bucket,
//   tile), eight bits, so that each bucket's region holds its rows
//   grouped by block in block order, each block's run sorted by tile and
//   padded to whole 32-row steps on its own (the padding rows of zero q
//   sit on the run's last tile, so a step's tiles stay its rows'): an
//   mma step never mixes two blocks;
// * a warp folds its int32 sums into its float64 sums in shared memory
//   (a thread t < 3 holds channel t of its 16 lanes, as the bf16 bodies'
//   registers do) at the end of each block's run of its home steps, and
//   once a block from the slots of its bucket's helper runs, which the
//   dealing cuts at block edges (a slot names its run's block);
// * only runs that hold rows are folded; a block whose scale is not
//   finite reaches every lane of its channel all the same (the dense
//   design's rule: acc += 0 * s is NaN), folded once a segment by each
//   home warp that holds none of its rows;
// * a home run of at most kQScalarRows rows (16; above 1,024 bins most
//   runs hold fewer) is added row by row in float64 instead: a fold
//   converts and adds 128 lanes x 9 sums whatever the rows, a row 3
//   products on the thread that owns its lane;
// * the float64 sums stay in shared memory, as the one-block body's: in
//   registers beside the int32 sums they spilled at the 128-register
//   bound (2 CTAs an SM) and ran slower; at 1 CTA an SM slower still;
// * a segment's blocks' scales are staged in shared memory once, by the
//   last warp (the least-loaded under skew), for the folds to read.
// The float64 sums flush to out once a CTA range (and slot).
//
// Barriers: four a segment (after the ranks, the places, the placement
// and the multiply).  On an H100 the kernel is bound by the latency of
// these short phases at 16 warps an SM, not by one of them: taking the
// sort, the one-hot build or the mma out alone saves 0.2-0.3 of it
// (scripts/torch_onehot_ablation.py, PERF.md).
//
// The staged bf16 rows are ordered hi0, lo0, hi1, lo1, hi2, lo2, so a
// thread's two mma columns (2t, 2t + 1) are one channel's pair, added in
// float64 at each fold; int8's second n8 tile carries level 1 in columns
// 0, 2, 4, so a thread's columns are one channel's three levels.  The sums
// leave the CTA as three float64 rows (g*m, h*m, m) through float64
// atomics into the zeroed [3, lanes] (leaves: [k, 3, lanes]) output.
//
// Bound: the function's (onehot_full.cu, onehot_leaves.cu) is unchanged;
// the tensor cores now do at most 2 * 8 * 128 flops a (row, feature) (its
// bucket's 8 tiles; fewer where a step's rows share tiles), 0.058 ms at
// 1M x 28 at 989 TFLOP/s, against the bytes' 0.0204 ms; the phases above
// keep the kernel far from either.  int8 over 128-row blocks pays each
// (bucket, block) run's own step and fold (16 rows a run at B = 1,024:
// about twice the rows' tensor-core work with the padding, and a fold of
// 128 lanes for them), and above 1,024 bins every CTA of a feature reads
// every row of it (64 CTAs a feature at 65,536).
#pragma once

#include <type_traits>

#include "onehot_common.cuh"

namespace lgbt_oh {

constexpr int kBWarps = 8;                       // a home bucket a warp
constexpr int kBThreads = kBWarps * 32;
constexpr int kSegChunks = 4;
constexpr int kSegRows = kSegChunks * kChunk;    // two rows a thread
constexpr int kMaxBuckets = kBWarps;
constexpr int kKeys = kMaxBuckets * kTiles;      // (bucket, tile) a CTA

constexpr int kSlotThreads = 24;                 // threads t < 3 of a warp
// registers: at most 128 a thread, so that two CTAs share an SM
constexpr int kBMinBlocks = 2;

// Per body: rows a step, steps a run (128 rows: an f32 sum's limit), a
// thread's sums a slot, the slots (helper runs a segment), a bucket's
// region of the compacted rows (a segment plus its padding; a bucket's
// rows start there, so no prefix runs across buckets), the compacted rows
// and a staged row's stride (u16 for bf16, bytes for int8: 2,120 and
// 1,096 words, 8 mod 32, so the eight rows g of a fragment load fall in
// distinct bank groups)
template <int V>
struct BucketBody {
  static constexpr int kStep = 16;
  static constexpr int kRunMax = 8;
  static constexpr int kVals = kTiles * 4;
  static constexpr int kNSlot = 16;
  static constexpr int kRegion = kSegRows + kStep;
  static constexpr int kCap = kMaxBuckets * kRegion;
  static constexpr int kStride = kCap + 16;
  static constexpr int kRowsBytes = 6 * kStride * 2;
};
template <>
struct BucketBody<kInt8> {
  static constexpr int kStep = 32;
  static constexpr int kRunMax = 4;
  static constexpr int kVals = kTiles * 6;
  static constexpr int kNSlot = 8;
  static constexpr int kRegion = kSegRows + kStep;
  static constexpr int kCap = kMaxBuckets * kRegion;
  static constexpr int kStride = kCap + 32;
  static constexpr int kRowsBytes = 9 * kStride;
};

// int8 over quantization blocks under 512 rows, whose segments span them
// (bucket_cta_int8): a body of the bucketed layer only, with int8's rows
// and a layout of its own.  A bucket's region holds its rows of each
// block a segment touches (at most kSegChunks), each block's run padded on
// its own, which leaves room for fewer slots.
constexpr int kInt8Span = kNumVariants;
template <>
struct BucketBody<kInt8Span> {
  static constexpr int kStep = 32;
  static constexpr int kRunMax = 4;
  static constexpr int kVals = kTiles * 6;
  static constexpr int kNSlot = 5;
  static constexpr int kRegion = kSegRows + kSegChunks * kStep;
  static constexpr int kCap = kMaxBuckets * kRegion;
  static constexpr int kStride = kCap + 32;
  static constexpr int kRowsBytes = 9 * kStride;
};

// the bodies whose rows are int8's nine q bytes
__host__ __device__ constexpr bool int8_rows(int V) {
  return V == kInt8 || V == kInt8Span;
}

// A segment's counts and places (shared memory)
struct BucketPlan {
  int off[kBWarps][kKeys];         // a warp's count a key, then a row's
                                   // place: off[warp][key] + rank
  int nrow[kMaxBuckets];           // a bucket's rows, before padding
};

// kInt8Span's: its keys (block in the segment, bucket, tile) are up to 8 bits,
// and each (bucket, block) run has its rows and its first step in the
// bucket's region (bstep[b][nblk]: the bucket's steps); rblk names each
// helper run's block; the segment's blocks' scales, staged once a segment
// in one of two buffers (a segment's folds read its own while the next
// segment stages the other), and which blocks have a scale that is not
// finite
constexpr int kQBlocks = kSegChunks;
constexpr int kQKeys = kQBlocks * kKeys;
struct QPlan {
  int off[kBWarps][kQKeys];
  int nrow[kMaxBuckets][kQBlocks];
  int bstep[kMaxBuckets][kQBlocks + 1];
  int rblk[8];                  // at least kNSlot
  float scl[2][kQBlocks * 9];
  uint32_t bad[4];              // [2] used; keeps the size 16-aligned
};
static_assert(BucketBody<kInt8Span>::kNSlot <= 8 &&
                  sizeof(QPlan) % 16 == 0,
              "the int8 plan holds a block for each slot and keeps what "
              "follows it 16-byte aligned");

template <int V>
struct PlanOf {
  using type = BucketPlan;
};
template <>
struct PlanOf<kInt8Span> {
  using type = QPlan;
};

template <int V>
__host__ __device__ constexpr int bucket_slot_bytes() {
  return BucketBody<V>::kVals * kSlotThreads * 4;
}

// int8's float64 sums (shared memory: its int32 tile sums leave no
// registers for them): 16 a thread
constexpr int kInt8AccBytes = kBWarps * 2 * kTiles * kSlotThreads * 8;

// Dynamic shared bytes of a bucketed kernel: [staged rows | bins | slots |
// plan | int8's float64 sums]
template <int V>
__host__ __device__ constexpr int bucket_smem() {
  return BucketBody<V>::kRowsBytes + BucketBody<V>::kCap * 2 +
         BucketBody<V>::kNSlot * bucket_slot_bytes<V>() +
         (int)sizeof(typename PlanOf<V>::type) +
         (int8_rows(V) ? kInt8AccBytes : 0);
}

// What a bucketed CTA reads.  bins: u16, [f, ld] (feature-major; rows of
// a multiple of 16 bytes reaching the last chunk's end) or [n, ld]
// (row-major); g, h, m: [n] float32 (the bf16 bodies); q: [9, ldq] int8
// (ldq = n rounded up to kChunk, zero past n) and scales [blocks, 9]
// float32 (int8).
struct BSrc {
  const uint16_t* bins;
  int64_t ld, n;
  const float* g;
  const float* h;
  const float* m;
  const int8_t* q;
  int64_t ldq;
  const float* scales;
};

// Two adjacent rows of a segment as a thread loads them: their bins (row
// r in the low half), and g, h, m or q (staged row s of the int8 layout,
// byte 0 row r, byte 1 row r + 1)
struct Raw {
  uint32_t bins;
  float g[2], h[2], m[2];
  uint32_t q[9];
};

template <int V, int L>
__device__ __forceinline__ void load_rows(const BSrc& S, int fa, int64_t r,
                                          Raw& w) {
  if (L == kFeatMajor) {
    // rows reach the last chunk's end: the word is there for any r < n
    w.bins = r < S.n ? *reinterpret_cast<const uint32_t*>(
                           S.bins + (int64_t)fa * S.ld + r)
                     : ~0u;
  } else {
    const uint32_t b0 = r < S.n ? S.bins[r * S.ld + fa] : 0xFFFFu;
    const uint32_t b1 = r + 1 < S.n ? S.bins[(r + 1) * S.ld + fa] : 0xFFFFu;
    w.bins = b0 | (b1 << 16);
  }
  if constexpr (int8_rows(V)) {
    // a segment's last threads may stand past q's padded rows (ldq, a
    // multiple of kChunk, so r + 1 < ldq whenever r < ldq)
#pragma unroll
    for (int s = 0; s < 9; ++s)
      w.q[s] = r < S.ldq ? *reinterpret_cast<const uint16_t*>(
                               S.q + q_channel(s) * S.ldq + r)
                         : 0u;
  } else if (r + 1 < S.n) {
    const float2 g = *reinterpret_cast<const float2*>(S.g + r);
    const float2 h = *reinterpret_cast<const float2*>(S.h + r);
    const float2 m = *reinterpret_cast<const float2*>(S.m + r);
    w.g[0] = g.x; w.g[1] = g.y;
    w.h[0] = h.x; w.h[1] = h.y;
    w.m[0] = m.x; w.m[1] = m.y;
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool in = r + i < S.n;
      w.g[i] = in ? S.g[r + i] : 0.f;
      w.h[i] = in ? S.h[r + i] : 0.f;
      w.m[i] = in ? S.m[r + i] : 0.f;
    }
  }
}

// A row's six staged bf16 values (hi0, lo0, hi1, lo1, hi2, lo2) as three
// words (the earlier value in the low half); true when one is not finite
__device__ __forceinline__ bool split_pair(float g, float h, float m,
                                           uint32_t (&p)[3]) {
  const float x[3] = {g * m, h * m, m};
  bool bad = false;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const __nv_bfloat16 hi = __float2bfloat16_rn(x[c]);
    const __nv_bfloat16 lo = __float2bfloat16_rn(x[c] - __bfloat162float(hi));
    const uint32_t a = __bfloat16_as_ushort(hi), b = __bfloat16_as_ushort(lo);
    bad |= (a & 0x7F80u) == 0x7F80u || (b & 0x7F80u) == 0x7F80u;
    p[c] = a | (b << 16);
  }
  return bad;
}

// The shared memory of a bucketed CTA
template <int V>
struct BShared {
  using Plan = typename PlanOf<V>::type;
  uint8_t* rows;       // [6][kStride] u16, or [9][kStride] bytes
  uint16_t* bins;      // [kCap]
  int* slots;          // [kNSlot][kVals][kSlotThreads] f32 or int32
  Plan* plan;
  double* acc;         // int8: [kBWarps][2 kTiles][kSlotThreads]
  __device__ __forceinline__ explicit BShared(uint8_t* smem)
      : rows(smem),
        bins(reinterpret_cast<uint16_t*>(smem + BucketBody<V>::kRowsBytes)),
        slots(reinterpret_cast<int*>(smem + BucketBody<V>::kRowsBytes +
                                     BucketBody<V>::kCap * 2)),
        plan(reinterpret_cast<Plan*>(
            smem + BucketBody<V>::kRowsBytes + BucketBody<V>::kCap * 2 +
            BucketBody<V>::kNSlot * bucket_slot_bytes<V>())),
        acc(reinterpret_cast<double*>(
            smem + BucketBody<V>::kRowsBytes + BucketBody<V>::kCap * 2 +
            BucketBody<V>::kNSlot * bucket_slot_bytes<V>() + sizeof(Plan))) {}
};

// Write one row (i: 0 or 1 of the thread's pair) at compacted place pos;
// a pad is a row that adds nothing (zero gh) at bin `bin`, put_pad's on
// lane 127 of bucket bk (its last tile, which keeps the bucket's tiles in
// order)
template <int V>
__device__ __forceinline__ void put_row(const BShared<V>& sh, int pos,
                                        uint32_t bin,
                                        const uint32_t (&p)[3],
                                        const Raw& w, int i) {
  constexpr int kS = BucketBody<V>::kStride;
  sh.bins[pos] = (uint16_t)bin;
  if constexpr (int8_rows(V)) {
#pragma unroll
    for (int s = 0; s < 9; ++s)
      sh.rows[s * kS + pos] = (uint8_t)(w.q[s] >> (8 * i));
  } else {
    uint16_t* r = reinterpret_cast<uint16_t*>(sh.rows);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      r[(2 * c) * kS + pos] = (uint16_t)p[c];
      r[(2 * c + 1) * kS + pos] = (uint16_t)(p[c] >> 16);
    }
  }
}

template <int V>
__device__ __forceinline__ void put_pad_at(const BShared<V>& sh, int pos,
                                           int bin) {
  constexpr int kS = BucketBody<V>::kStride;
  sh.bins[pos] = (uint16_t)bin;
  if constexpr (int8_rows(V)) {
#pragma unroll
    for (int s = 0; s < 9; ++s) sh.rows[s * kS + pos] = 0;
  } else {
    uint16_t* r = reinterpret_cast<uint16_t*>(sh.rows);
#pragma unroll
    for (int c = 0; c < 6; ++c) r[c * kS + pos] = 0;
  }
}

template <int V>
__device__ __forceinline__ void put_pad(const BShared<V>& sh, int pos,
                                        int bucket) {
  put_pad_at<V>(sh, pos, bucket * kWarpLanes + kWarpLanes - 1);
}

// The tiles [lo, hi] a step's rows fall in, from its first and last
// (sorted) rows' bins: every tile in a dense segment
__device__ __forceinline__ void tile_range(const uint16_t* bins, int pos,
                                           int rows, bool dense, int& lo,
                                           int& hi) {
  lo = dense ? 0 : (bins[pos] >> 4) & (kTiles - 1);
  hi = dense ? kTiles - 1 : (bins[pos + rows - 1] >> 4) & (kTiles - 1);
}

// One bf16 step on the tiles [lo, hi]: c += the step's product there
template <int V>
__device__ __forceinline__ void tile_step(float (&c)[kTiles][4],
                                          const uint16_t* gp,
                                          const uint16_t* bp,
                                          const Ids& ids, int lo, int hi) {
  const uint2 b = *reinterpret_cast<const uint2*>(gp);
  const Step<V> st(load4(bp), ids);
#pragma unroll
  for (int tl = 0; tl < kTiles; ++tl) {
    if (tl < lo || tl > hi) continue;
    uint32_t a[4];
    st.tile(tl, a);
    mma16816(c[tl], a[0], a[1], a[2], a[3], b.x, b.y);
  }
}

// c += len bf16 steps from compacted row pos
template <int V>
__device__ __forceinline__ void bucket_run(float (&c)[kTiles][4],
                                           const BShared<V>& sh, int pos,
                                           int len, const Ids& ids,
                                           bool dense) {
  constexpr int kS = BucketBody<V>::kStride;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  // columns 6 and 7 are padding: their threads read row 0 again
  const uint16_t* gp = reinterpret_cast<const uint16_t*>(sh.rows) +
                       (g < 6 ? g : 0) * kS + pos + 4 * t;
  const uint16_t* bp = sh.bins + pos + 4 * t;
  for (int s = 0; s < len; ++s) {
    int lo, hi;
    tile_range(sh.bins, pos + 16 * s, 16, dense, lo, hi);
    tile_step<V>(c, gp + 16 * s, bp + 16 * s, ids, lo, hi);
  }
}

// int8: c += len 32-row steps from compacted row pos.  The first n8
// tile's column j is staged row j (for t < 3: levels 2 and 3 of channel
// t); the second's columns 0, 2, 4 are staged rows 6, 7, 8 (level 1 of
// channels 0, 1, 2), the rest zero.
template <int V>
__device__ __forceinline__ void bucket_run_int8(int (&c)[kTiles][2][4],
                                                const BShared<V>& sh,
                                                int pos, int len,
                                                const Int8Ids& ids) {
  constexpr int kS = BucketBody<V>::kStride;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const uint8_t* qp = sh.rows + g * kS + pos + 8 * t;
  const bool lv1 = g < 6 && !(g & 1);
  const uint8_t* q1 = sh.rows + (6 + (g >> 1)) * kS + pos + 8 * t;
  const uint16_t* bp = sh.bins + pos + 8 * t;
  for (int s = 0; s < len; ++s) {
    int lo, hi;
    tile_range(sh.bins, pos + 32 * s, 32, false, lo, hi);
    const uint2 b = ld64(qp + 32 * s);
    uint2 b1 = make_uint2(0u, 0u);
    if (lv1) b1 = ld64(q1 + 32 * s);
    const Int8Step o(load8(bp + 32 * s), ids);
#pragma unroll
    for (int tl = 0; tl < kTiles; ++tl) {
      if (tl < lo || tl > hi) continue;
      uint32_t a[4];
      o.tile(tl, a);
      mma16832(c[tl][0], a[0], a[1], a[2], a[3], b.x, b.y);
      mma16832(c[tl][1], a[0], a[1], a[2], a[3], b1.x, b1.y);
    }
  }
}

// A consumer thread's float64 sums: lanes g (h = 0) and g + 8 (h = 1) of
// each tile, channel t (t < 3; threads t = 3 hold none), in registers
// (bf16) or in shared memory (int8, 16 a thread strided by kSlotThreads:
// its int32 sums take the registers)
struct RegAcc {
  double v[kTiles][2];
  __device__ __forceinline__ double& at(int tl, int h) { return v[tl][h]; }
};
struct SmemAcc {
  double* p;
  __device__ __forceinline__ double& at(int tl, int h) {
    return p[(2 * tl + h) * kSlotThreads];
  }
};

template <typename A>
__device__ __forceinline__ void zero_acc(A& acc) {
  if ((threadIdx.x & 3) == 3) return;
#pragma unroll
  for (int tl = 0; tl < kTiles; ++tl) acc.at(tl, 0) = acc.at(tl, 1) = 0.0;
}

// bf16: a channel's hi and lo sums are the thread's two columns
template <typename A>
__device__ __forceinline__ void fold_pair(A& acc,
                                          const float (&c)[kTiles][4]) {
  if ((threadIdx.x & 3) == 3) return;
#pragma unroll
  for (int tl = 0; tl < kTiles; ++tl) {
    acc.at(tl, 0) += (double)c[tl][0] + (double)c[tl][1];
    acc.at(tl, 1) += (double)c[tl][2] + (double)c[tl][3];
  }
}

// int8: level 1 + (level 2 + level 3), each sum times its block scale over
// 128 (exact in float64); a non-finite scale makes every lane NaN
template <typename A>
__device__ __forceinline__ void fold_levels(A& acc,
                                            const int (&c)[kTiles][2][4],
                                            const float* __restrict__ sc) {
  const int t = threadIdx.x & 3;
  if (t == 3) return;
  constexpr double kInv = 1.0 / 128;
  const double s1 = (double)sc[t] * kInv, s2 = (double)sc[3 + t] * kInv,
               s3 = (double)sc[6 + t] * kInv;
#pragma unroll
  for (int tl = 0; tl < kTiles; ++tl) {
    acc.at(tl, 0) += (double)c[tl][1][0] * s1 +
                     ((double)c[tl][0][0] * s2 + (double)c[tl][0][1] * s3);
    acc.at(tl, 1) += (double)c[tl][1][2] * s1 +
                     ((double)c[tl][0][2] * s2 + (double)c[tl][0][3] * s3);
  }
}

// int8: a home run of few rows (at most kQScalarRows, all of one block)
// added row by row in float64, with no step and no fold: lane l of the
// bucket (its first bin base) and channel t are thread (l % 8, t)'s, as
// in fold_levels, and a row adds its three levels times their scales.
// Each product is the one the fold takes of the row's share of an int32
// sum, so the float64 sums agree with the fold's in practice.  Every lane
// of the warp calls it.
constexpr int kQScalarRows = 16;
template <typename A>
__device__ __forceinline__ void add_rows(A& acc,
                                         const BShared<kInt8Span>& sh,
                                         int pos, int n, int base,
                                         const float* __restrict__ sc) {
  constexpr int kS = BucketBody<kInt8Span>::kStride;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  if (t == 3) return;
  const double s1 = sc[t], s2 = sc[3 + t], s3 = sc[6 + t];
  const int8_t* q = reinterpret_cast<const int8_t*>(sh.rows) + pos;
  for (int r = 0; r < n; ++r) {
    const int l = sh.bins[pos + r] - base;
    if ((l & 7) != g) continue;
    acc.at(l >> 4, (l >> 3) & 1) +=
        (double)q[(6 + t) * kS + r] * s1 +
        ((double)q[2 * t * kS + r] * s2 +
         (double)q[(2 * t + 1) * kS + r] * s3);
  }
}

// int8: what folding zero sums by a block's scales adds, where this
// thread's channel has a scale that is not finite: NaN on every lane (0 *
// NaN, 0 * inf), as the dense design's fold of a block gives it
template <typename A>
__device__ __forceinline__ void fold_nonfinite(A& acc,
                                               const float* __restrict__ sc) {
  const int t = threadIdx.x & 3;
  if (t == 3) return;
  const double z = 0.0 * (double)sc[t] +
                   (0.0 * (double)sc[3 + t] + 0.0 * (double)sc[6 + t]);
  if (z == 0.0) return;
#pragma unroll
  for (int tl = 0; tl < kTiles; ++tl) {
    acc.at(tl, 0) += z;
    acc.at(tl, 1) += z;
  }
}

// A slot holds value j of thread u = 3 g + t at [j][u]; threads t = 3
// hold the padding columns and neither write nor read slots
__device__ __forceinline__ int slot_thread() {
  return 3 * ((threadIdx.x & 31) >> 2) + (threadIdx.x & 3);
}

__device__ __forceinline__ void put_slot(int* s, const float (&c)[kTiles][4]) {
  if ((threadIdx.x & 3) == 3) return;
  const int u = slot_thread();
#pragma unroll
  for (int tl = 0; tl < kTiles; ++tl)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[(4 * tl + i) * kSlotThreads + u] = __float_as_int(c[tl][i]);
}

__device__ __forceinline__ void put_slot(int* s,
                                         const int (&c)[kTiles][2][4]) {
  if ((threadIdx.x & 3) == 3) return;
  const int u = slot_thread();
#pragma unroll
  for (int tl = 0; tl < kTiles; ++tl) {
    int* p = s + 6 * tl * kSlotThreads + u;
    p[0 * kSlotThreads] = c[tl][0][0];
    p[1 * kSlotThreads] = c[tl][0][1];
    p[2 * kSlotThreads] = c[tl][0][2];
    p[3 * kSlotThreads] = c[tl][0][3];
    p[4 * kSlotThreads] = c[tl][1][0];
    p[5 * kSlotThreads] = c[tl][1][2];
  }
}

template <typename A>
__device__ __forceinline__ void fold_slot(A& acc, const int* s) {
  if ((threadIdx.x & 3) == 3) return;
  const int u = slot_thread();
#pragma unroll
  for (int tl = 0; tl < kTiles; ++tl) {
    const int* p = s + 4 * tl * kSlotThreads + u;
    acc.at(tl, 0) += (double)__int_as_float(p[0]) +
                     (double)__int_as_float(p[kSlotThreads]);
    acc.at(tl, 1) += (double)__int_as_float(p[2 * kSlotThreads]) +
                     (double)__int_as_float(p[3 * kSlotThreads]);
  }
}

__device__ __forceinline__ void add_slot(int (&c)[kTiles][2][4],
                                         const int* s) {
  if ((threadIdx.x & 3) == 3) return;
  const int u = slot_thread();
#pragma unroll
  for (int tl = 0; tl < kTiles; ++tl) {
    const int* p = s + 6 * tl * kSlotThreads + u;
    c[tl][0][0] += p[0];
    c[tl][0][1] += p[kSlotThreads];
    c[tl][0][2] += p[2 * kSlotThreads];
    c[tl][0][3] += p[3 * kSlotThreads];
    c[tl][1][0] += p[4 * kSlotThreads];
    c[tl][1][2] += p[5 * kSlotThreads];
  }
}

// Add a home warp's sums to out + lane0 (its bucket's first lane in a
// [3, lanes] float64 output) and zero them.  Zeros are skipped (a NaN is
// not zero, so it is added).  The bucket's two home warps each add theirs:
// the output takes every CTA's sums through atomics anyway, and float64
// sums of these values are exact in practice, so the bits do not depend
// on the order.
template <typename A>
__device__ __forceinline__ void flush_bucket(double* __restrict__ out,
                                             A& acc, int64_t lane0,
                                             int lanes) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  if (t == 3) return;
#pragma unroll
  for (int tl = 0; tl < kTiles; ++tl)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const double v = acc.at(tl, h);
      if (v != 0.0)
        atomicAdd(out + (int64_t)t * lanes + lane0 + 16 * tl + g + 8 * h, v);
      acc.at(tl, h) = 0.0;
    }
}

__device__ __forceinline__ void zero_tiles(float (&c)[kTiles][4]) {
#pragma unroll
  for (int tl = 0; tl < kTiles; ++tl) c[tl][0] = c[tl][1] = c[tl][2] =
      c[tl][3] = 0.f;
}

// The warp's rows of key k among one row of each thread's pair (x: the
// ballots of those rows: x[0] the rows that count, x[1..kBits] their
// keys' bits)
template <int kBits>
__device__ __forceinline__ uint32_t peers(const uint32_t (&x)[kBits + 1],
                                          int k) {
  uint32_t m = x[0];
#pragma unroll
  for (int bit = 0; bit < kBits; ++bit)
    m &= ((k >> bit) & 1) ? x[bit + 1] : ~x[bit + 1];
  return m;
}

// Each row's rank among its warp's rows of its key (the earlier row
// first), and each warp's count a key in P.off: seven ballots a row of the
// pair (whether it counts, and its key's six bits), whatever the keys
__device__ __forceinline__ void rank_rows(BucketPlan& P, const int (&key)[2],
                                          int (&rank)[2], int nkeys) {
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const uint32_t lt = (1u << lane) - 1u;
  uint32_t x[2][7];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    x[i][0] = __ballot_sync(~0u, key[i] >= 0);
#pragma unroll
    for (int bit = 0; bit < 6; ++bit)
      x[i][bit + 1] = __ballot_sync(~0u, (key[i] >> bit) & 1);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (key[i] >= 0)
      rank[i] = __popc(peers<6>(x[0], key[i]) & lt) +
                __popc(peers<6>(x[1], key[i]) & lt) +
                (i == 1 && key[0] == key[1]);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int k = lane + 32 * q;
    if (k < nkeys)
      P.off[wp][k] = __popc(peers<6>(x[0], k)) + __popc(peers<6>(x[1], k));
  }
}

// The same for int8's keys, up to 256 (kBits bits): each row writes its
// own key's count into off (every row of a key writes the same), the
// others stay zero
template <int kBits>
__device__ __forceinline__ void rank_own_keys(int* off, const int (&key)[2],
                                              int (&rank)[2], int nkeys) {
  const int lane = threadIdx.x & 31;
  const uint32_t lt = (1u << lane) - 1u;
  for (int k = lane; k < nkeys; k += 32) off[k] = 0;
  uint32_t x[2][kBits + 1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    x[i][0] = __ballot_sync(~0u, key[i] >= 0);
#pragma unroll
    for (int bit = 0; bit < kBits; ++bit)
      x[i][bit + 1] = __ballot_sync(~0u, (key[i] >> bit) & 1);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (key[i] >= 0) {
      const uint32_t m0 = peers<kBits>(x[0], key[i]);
      const uint32_t m1 = peers<kBits>(x[1], key[i]);
      rank[i] =
          __popc(m0 & lt) + __popc(m1 & lt) + (i == 1 && key[0] == key[1]);
      off[key[i]] = __popc(m0) + __popc(m1);
    }
}

// int8's keys over a segment of nblk quantization blocks: (block, bucket,
// tile), as few bits as the blocks need
__device__ __forceinline__ void rank_blocks(int* off, const int (&key)[2],
                                            int (&rank)[2], int nblk) {
  if (nblk == 1)
    rank_own_keys<6>(off, key, rank, kKeys);
  else if (nblk == 2)
    rank_own_keys<7>(off, key, rank, 2 * kKeys);
  else
    rank_own_keys<8>(off, key, rank, nblk * kKeys);
}


// Warp b, after the counts: the places of bucket b's rows in its region
// (ordered by tile, then warp, then rank), and its rows.  Lane l takes
// tile l / 4 of warps 2 (l % 4) and 2 (l % 4) + 1.
template <int V>
__device__ __forceinline__ void bucket_offsets(BucketPlan& P, int b) {
  const int l = threadIdx.x & 31;
  const int k = kTiles * b + (l >> 2), w0 = 2 * (l & 3);
  const int c0 = P.off[w0][k], c1 = P.off[w0 + 1][k];
  int incl = c0 + c1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(~0u, incl, o);
    if (l >= o) incl += u;
  }
  const int at = b * BucketBody<V>::kRegion + incl - c0 - c1;
  P.off[w0][k] = at;
  P.off[w0 + 1][k] = at + c0;
  const int n = __shfl_sync(~0u, incl, 31);
  if (l == 0) P.nrow[b] = n;
}

// The pair's rows at their compacted places, and each bucket's padding
// (dense: the rows in order, at the start)
template <int V>
__device__ __forceinline__ void place_rows(const BShared<V>& sh,
                                           const BucketPlan& P,
                                           const int (&key)[2],
                                           const int (&rank)[2],
                                           const uint32_t (&p)[2][3],
                                           const Raw& w, int b0, int nbc,
                                           bool dense, bool mine) {
  constexpr int kStep = BucketBody<V>::kStep;
  const int tid = threadIdx.x, wp = tid >> 5;
  if (dense) {
    if (mine)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        put_row<V>(sh, 2 * tid + i, (w.bins >> (16 * i)) & 0xFFFFu, p[i], w,
                   i);
    return;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (key[i] >= 0)
      put_row<V>(sh, P.off[wp][key[i]] + rank[i],
                 (w.bins >> (16 * i)) & 0xFFFFu, p[i], w, i);
  if (tid < nbc * kStep) {
    const int b = tid / kStep, j = tid % kStep;
    const int n = P.nrow[b];
    if (j < (kStep - n % kStep) % kStep)
      put_pad<V>(sh, b * BucketBody<V>::kRegion + n + j, b0 + b);
  }
}

// Every warp, after the placement: the segment's dealing (the same in
// each).  Lane b is bucket b and warp b: its steps, its first compacted
// row, the steps its home warp takes (at most one over the mean share
// ceil(T / 8) of the segment's T steps: uniform bins then deal no runs,
// each of which costs a slot's write and fold), and its helper runs: the
// rest, in runs of at most kRunMax steps, numbered from rbase in bucket
// order; each goes to the least-loaded warp (the lowest on a tie).
struct Deal {
  int steps, pos, H, E, L, nr, rbase, NR;
};

template <int V>
__device__ __forceinline__ Deal make_deal(const BucketPlan& P, int nbc,
                                          bool dense, int seg_rows) {
  constexpr int kStep = BucketBody<V>::kStep, kRunMax = BucketBody<V>::kRunMax;
  constexpr int kNSlot = BucketBody<V>::kNSlot;
  const int l = threadIdx.x & 31;
  Deal d;
  const int n = l < nbc ? (dense ? seg_rows : P.nrow[l]) : 0;
  d.steps = (n + kStep - 1) / kStep;
  d.pos = dense ? 0 : l * BucketBody<V>::kRegion;
  const int tstar =
      ((int)__reduce_add_sync(~0u, (unsigned)d.steps) + kBWarps - 1) /
      kBWarps;
  d.L = min(max(tstar, 1), kRunMax);
  d.H = min(d.steps, tstar + 1);
  d.E = d.steps - d.H;
  d.nr = (d.E + d.L - 1) / d.L;
  d.NR = (int)__reduce_add_sync(~0u, (unsigned)d.nr);
  if (d.NR > kNSlot) {                       // longer runs, then none
    d.L = kRunMax;
    d.nr = (d.E + d.L - 1) / d.L;
    d.NR = (int)__reduce_add_sync(~0u, (unsigned)d.nr);
    if (d.NR > kNSlot) {
      d.H = d.steps;
      d.E = d.nr = d.NR = 0;
    }
  }
  d.rbase = 0;
#pragma unroll
  for (int j = 0; j < kMaxBuckets; ++j) {
    const int nj = __shfl_sync(~0u, d.nr, j);
    if (j < l) d.rbase += nj;
  }
  return d;
}

// Helper run r of the dealing: its bucket, first row and steps, and the
// warp it goes to (lane w holds warp w's load, which this adds to)
struct Run {
  int warp, bucket, pos, len;
};

template <int V>
__device__ __forceinline__ Run deal_run(const Deal& d, int r, int nbc,
                                        uint32_t& load) {
  const int l = threadIdx.x & 31;
  const uint32_t has = __ballot_sync(~0u, l < nbc && d.nr > 0 && d.rbase <= r);
  Run u;
  u.bucket = 31 - __clz(has);
  const int j = r - __shfl_sync(~0u, d.rbase, u.bucket);
  const int Hb = __shfl_sync(~0u, d.H, u.bucket);
  const int Eb = __shfl_sync(~0u, d.E, u.bucket);
  u.pos = __shfl_sync(~0u, d.pos, u.bucket) +
          (Hb + j * d.L) * BucketBody<V>::kStep;
  u.len = min(d.L, Eb - j * d.L);
  const uint32_t key = l < kBWarps ? (load << 3) | (uint32_t)l : ~0u;
  u.warp = (int)(__reduce_min_sync(~0u, key) & 7u);
  if (l == u.warp) load += (uint32_t)u.len;
  return u;
}

// The segments a CTA walks: whole chunks [sc, end), cut at 4 chunks and
// at each block of cpb chunks (a leaves block, or int8's quantization
// block of kSegChunks chunks or more; the other full passes pass a cpb no
// range reaches); with leaf (the leaves), a block whose slot is
// outside [0, k) is skipped
struct Segs {
  int64_t end;
  int cpb;
  const int32_t* leaf;
  int k;
  __device__ __forceinline__ int64_t first(int64_t sc) const {
    if (leaf != nullptr) {
      while (sc < end) {
        const int64_t blk = sc / cpb;
        const int slot = leaf[blk];
        if (slot >= 0 && slot < k) break;
        sc = (blk + 1) * cpb;
      }
    }
    return sc < end ? sc : end;
  }
  __device__ __forceinline__ int64_t stop(int64_t sc) const {
    int64_t e = sc + kSegChunks < end ? sc + kSegChunks : end;
    const int64_t be = (sc / cpb + 1) * cpb;
    return be < e ? be : e;
  }
  __device__ __forceinline__ int64_t next(int64_t sc) const {
    return first(stop(sc));
  }
};

// A bucketed CTA over the segments from chunk start (G): sort, multiply
// and fold each, and add the sums into out + slot * slot_stride (the
// leaves: slot block_leaf of the segment's block; the full pass: 0) when
// the slot changes and at the end.  lane0: the CTA's first lane in out.
template <int V, int L>
__device__ __forceinline__ void bucket_cta(uint8_t* smem, const BSrc& S,
                                           const Segs& G, int64_t start,
                                           int fa, int b0, int nbc,
                                           double* __restrict__ out,
                                           int64_t lane0, int lanes,
                                           int64_t slot_stride) {
  constexpr int kStep = BucketBody<V>::kStep, kRunMax = BucketBody<V>::kRunMax;
  const BShared<V> sh(smem);
  BucketPlan& P = *sh.plan;
  const int tid = threadIdx.x, wp = tid >> 5, g = (tid & 31) >> 2;
  const bool home = wp < nbc;
  const int64_t my_lane0 = lane0 + (int64_t)wp * kWarpLanes;
  using Acc = typename std::conditional<V == kInt8, SmemAcc, RegAcc>::type;
  Acc acc;
  if constexpr (V == kInt8)
    acc.p = sh.acc + wp * 2 * kTiles * kSlotThreads + slot_thread();
  zero_acc(acc);
  // bf16: the home bucket's f32 tile sums, kept across segments until they
  // hold kRunMax steps (128 rows)
  float c[kTiles][4];
  int csteps = 0;
  zero_tiles(c);
  const Ids hids = make_ids((b0 + wp) * kWarpLanes + g);
  auto fold_home = [&]() {
    if (csteps > 0) {
      fold_pair(acc, c);
      zero_tiles(c);
      csteps = 0;
    }
  };
  Raw w;
  int64_t sc = G.first(start);
  if (sc < G.end) load_rows<V, L>(S, fa, sc * kChunk + 2 * tid, w);
  int cur = -1;
  while (sc < G.end) {
    const int64_t blk = sc / G.cpb;
    const int slot = G.leaf != nullptr ? G.leaf[blk] : 0;
    if (slot != cur) {
      if (cur >= 0 && home) {
        if constexpr (V != kInt8) fold_home();
        flush_bucket(out + cur * slot_stride, acc, my_lane0, lanes);
      }
      cur = slot;
    }
    const int64_t se = G.stop(sc);
    const int seg_rows = (int)(se - sc) * kChunk;
    const int64_t nsc = G.first(se);
    // 1. the pair's keys (bin / 16 - 8 b0, or -1: dropped) and bf16 values
    const int64_t r = sc * kChunk + 2 * tid;
    const bool mine = 2 * tid < seg_rows;
    int key[2], rank[2] = {0, 0};
    uint32_t p[2][3] = {{0u, 0u, 0u}, {0u, 0u, 0u}};
    bool bad = false;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k =
          (int)((w.bins >> (16 * i)) & 0xFFFFu) / 16 - kTiles * b0;
      key[i] = (mine && r + i < S.n && k >= 0 && k < kTiles * nbc) ? k : -1;
      if constexpr (V != kInt8) {
        if (mine) bad |= split_pair(w.g[i], w.h[i], w.m[i], p[i]);
      }
    }
    // 2. ranks and counts; a non-finite value anywhere makes the segment
    // dense (the counts then go unread)
    rank_rows(P, key, rank, kTiles * nbc);
    const bool dense = V != kInt8 ? __syncthreads_or(bad) != 0
                                  : (__syncthreads(), false);
    // 3. each bucket's places, then the rows and padding there
    if (!dense && home) bucket_offsets<V>(P, wp);
    __syncthreads();
    place_rows<V>(sh, P, key, rank, p, w, b0, nbc, dense, mine);
    __syncthreads();
    if (nsc < G.end) load_rows<V, L>(S, fa, nsc * kChunk + 2 * tid, w);
    // 4. the home steps, then the helper runs dealt to this warp, into
    // their slots
    const Deal d = make_deal<V>(P, nbc, dense, seg_rows);
    const int hpos = __shfl_sync(~0u, d.pos, wp),
              hlen = __shfl_sync(~0u, d.H, wp);
    const int slo = __shfl_sync(~0u, d.rbase, wp),
              shi = slo + __shfl_sync(~0u, d.nr, wp);
    uint32_t load = (tid & 31) < nbc ? (uint32_t)d.H : 0u;
    if constexpr (V == kInt8) {
      const float* sc9 = S.scales + blk * 9;
      int ci[kTiles][2][4];
      zero_sums(ci);
      if (home) {
        bucket_run_int8(ci, sh, hpos, hlen,
                        make_int8_ids((b0 + wp) * kWarpLanes + g));
        fold_levels(acc, ci, sc9);
      }
      for (int r = 0; r < d.NR; ++r) {
        const Run u = deal_run<V>(d, r, nbc, load);
        if (u.warp != wp) continue;
        zero_sums(ci);
        bucket_run_int8(ci, sh, u.pos, u.len,
                        make_int8_ids((b0 + u.bucket) * kWarpLanes + g));
        put_slot(sh.slots + r * (bucket_slot_bytes<V>() / 4), ci);
      }
      __syncthreads();
      if (home && shi > slo) {
        zero_sums(ci);
        for (int q = slo; q < shi; ++q)
          add_slot(ci, sh.slots + q * (bucket_slot_bytes<V>() / 4));
        fold_levels(acc, ci, sc9);
      }
    } else {
      if (home) {
        int pos = hpos;
        for (int left = hlen; left > 0;) {
          if (csteps == kRunMax) fold_home();
          const int len = min(left, kRunMax - csteps);
          bucket_run<V>(c, sh, pos, len, hids, dense);
          csteps += len;
          pos += len * kStep;
          left -= len;
        }
      }
      for (int r = 0; r < d.NR; ++r) {
        const Run u = deal_run<V>(d, r, nbc, load);
        if (u.warp != wp) continue;
        fold_home();
        bucket_run<V>(c, sh, u.pos, u.len,
                      make_ids((b0 + u.bucket) * kWarpLanes + g), dense);
        put_slot(sh.slots + r * (bucket_slot_bytes<V>() / 4), c);
        zero_tiles(c);
      }
      __syncthreads();
      if (home)
        for (int q = slo; q < shi; ++q)
          fold_slot(acc, sh.slots + q * (bucket_slot_bytes<V>() / 4));
    }
    sc = nsc;
  }
  if (cur >= 0 && home) {
    if constexpr (V != kInt8) fold_home();
    flush_bucket(out + cur * slot_stride, acc, my_lane0, lanes);
  }
}

// --- int8 over quantization blocks (see the top) ---------------------------

// Warp b, after the counts: the places of bucket b's rows in its region,
// block by block (each block's run ordered by tile, then warp, then rank),
// each run's rows and first step, and its padding to a whole step: rows
// of zero q on the run's last tile (bucket b is the CTA's b0 + b).  Lane l
// takes tile l / 4 of warps 2 (l % 4) and 2 (l % 4) + 1.
__device__ __forceinline__ void qrun_offsets(const BShared<kInt8Span>& sh,
                                             QPlan& P, int b, int b0,
                                             int nblk) {
  constexpr int kStep = BucketBody<kInt8Span>::kStep;
  const int l = threadIdx.x & 31, w0 = 2 * (l & 3);
  int at0 = b * BucketBody<kInt8Span>::kRegion, steps = 0;
  if (l == 0) P.bstep[b][0] = 0;
  for (int j = 0; j < nblk; ++j) {
    const int k = (j << 6) | (b << 3) | (l >> 2);
    const int c0 = P.off[w0][k], c1 = P.off[w0 + 1][k];
    int incl = c0 + c1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(~0u, incl, o);
      if (l >= o) incl += u;
    }
    const int at = at0 + incl - c0 - c1;
    P.off[w0][k] = at;
    P.off[w0 + 1][k] = at + c0;
    const int n = __shfl_sync(~0u, incl, 31);
    const uint32_t held = __ballot_sync(~0u, c0 + c1 > 0);
    const int ns = (n + kStep - 1) / kStep;
    if (l == 0) {
      P.nrow[b][j] = n;
      P.bstep[b][j + 1] = steps + ns;
    }
    if (l < ns * kStep - n)
      put_pad_at<kInt8Span>(sh, at0 + n + l,
                        (b0 + b) * kWarpLanes +
                            16 * (held ? (31 - __clz(held)) >> 2 : 0));
    steps += ns;
    at0 += ns * kStep;
  }
}

// The dealing of an int8 segment (make_deal's, with the bucket's steps
// taken from its runs and the helper runs cut at block edges); lane b is
// bucket b.
struct QDeal {
  int steps, H, L, nr, rbase, NR;
};

// Helper runs of bucket b: its steps from H on, in runs of at most L steps
// that end at each block's end
__device__ __forceinline__ int qruns(const QPlan& P, int b, int nblk, int H,
                                     int L) {
  int n = 0;
  for (int j = 0; j < nblk; ++j) {
    const int e = P.bstep[b][j + 1] - max(H, P.bstep[b][j]);
    if (e > 0) n += (e + L - 1) / L;
  }
  return n;
}

__device__ __forceinline__ QDeal make_qdeal(const QPlan& P, int nbc,
                                            int nblk) {
  constexpr int kRunMax = BucketBody<kInt8Span>::kRunMax;
  constexpr int kNSlot = BucketBody<kInt8Span>::kNSlot;
  const int l = threadIdx.x & 31;
  const bool on = l < nbc;
  QDeal d;
  d.steps = on ? P.bstep[l][nblk] : 0;
  const int tstar =
      ((int)__reduce_add_sync(~0u, (unsigned)d.steps) + kBWarps - 1) /
      kBWarps;
  d.L = min(max(tstar, 1), kRunMax);
  d.H = min(d.steps, tstar + 1);
  d.nr = on ? qruns(P, l, nblk, d.H, d.L) : 0;
  d.NR = (int)__reduce_add_sync(~0u, (unsigned)d.nr);
  if (d.NR > kNSlot) {                       // longer runs, then none
    d.L = kRunMax;
    d.nr = on ? qruns(P, l, nblk, d.H, d.L) : 0;
    d.NR = (int)__reduce_add_sync(~0u, (unsigned)d.nr);
    if (d.NR > kNSlot) {
      d.H = d.steps;
      d.nr = d.NR = 0;
    }
  }
  d.rbase = 0;
#pragma unroll
  for (int j = 0; j < kMaxBuckets; ++j) {
    const int nj = __shfl_sync(~0u, d.nr, j);
    if (j < l) d.rbase += nj;
  }
  return d;
}

// Helper run r of an int8 segment: its bucket, block, first row and steps,
// and the warp it goes to (lane w holds warp w's load, which this adds to)
struct QRun {
  int warp, bucket, blk, pos, len;
};

__device__ __forceinline__ QRun qdeal_run(const QPlan& P, const QDeal& d,
                                          int r, int nbc, int nblk,
                                          uint32_t& load) {
  const int l = threadIdx.x & 31;
  const uint32_t has =
      __ballot_sync(~0u, l < nbc && d.nr > 0 && d.rbase <= r);
  QRun u;
  u.bucket = 31 - __clz(has);
  int jr = r - __shfl_sync(~0u, d.rbase, u.bucket);
  const int H = __shfl_sync(~0u, d.H, u.bucket);
  int s = 0;
  u.blk = 0;
  u.len = 0;
  for (int j = 0; j < nblk; ++j) {
    const int a = max(H, P.bstep[u.bucket][j]);
    const int e = P.bstep[u.bucket][j + 1] - a;
    const int n = e > 0 ? (e + d.L - 1) / d.L : 0;
    if (jr < n) {
      s = a + jr * d.L;
      u.len = min(d.L, e - jr * d.L);
      u.blk = j;
      break;
    }
    jr -= n;
  }
  u.pos = u.bucket * BucketBody<kInt8Span>::kRegion +
          BucketBody<kInt8Span>::kStep * s;
  const uint32_t key = l < kBWarps ? (load << 3) | (uint32_t)l : ~0u;
  u.warp = (int)(__reduce_min_sync(~0u, key) & 7u);
  if (l == u.warp) load += (uint32_t)u.len;
  return u;
}

// An int8 bucketed CTA over the segments from chunk start (G), its rows
// quantized in blocks of qcpb chunks (fewer than kSegChunks): as
// bucket_cta, with the segment's rows sorted by (block, bucket, tile) and
// each warp's int32 sums folded into its float64 sums by their own
// block's scales.
template <int L>
__device__ __forceinline__ void bucket_cta_int8(uint8_t* smem, const BSrc& S,
                                                const Segs& G, int qcpb,
                                                int64_t start, int fa, int b0,
                                                int nbc,
                                                double* __restrict__ out,
                                                int64_t lane0, int lanes,
                                                int64_t slot_stride) {
  constexpr int kStep = BucketBody<kInt8Span>::kStep;
  constexpr int kRegion = BucketBody<kInt8Span>::kRegion;
  constexpr int kSlotWords = bucket_slot_bytes<kInt8Span>() / 4;
  const BShared<kInt8Span> sh(smem);
  QPlan& P = *sh.plan;
  const int tid = threadIdx.x, wp = tid >> 5, lane = tid & 31, g = lane >> 2;
  const bool home = wp < nbc;
  const int64_t my_lane0 = lane0 + (int64_t)wp * kWarpLanes;
  SmemAcc acc{sh.acc + wp * 2 * kTiles * kSlotThreads + slot_thread()};
  zero_acc(acc);
  const Int8Ids hids = make_int8_ids((b0 + wp) * kWarpLanes + g);
  const uint32_t none[3] = {0u, 0u, 0u};
  Raw w;
  int64_t sc = G.first(start);
  if (sc < G.end) load_rows<kInt8Span, L>(S, fa, sc * kChunk + 2 * tid, w);
  int cur = -1, parity = 0;
  while (sc < G.end) {
    const int64_t blk = sc / G.cpb;
    const int slot = G.leaf != nullptr ? G.leaf[blk] : 0;
    if (slot != cur) {
      if (cur >= 0 && home)
        flush_bucket(out + cur * slot_stride, acc, my_lane0, lanes);
      cur = slot;
    }
    const int64_t se = G.stop(sc);
    const int seg_rows = (int)(se - sc) * kChunk;
    const int64_t nsc = G.first(se);
    // the segment's quantization blocks: qb0 and the nblk after it, their
    // scales staged by the last warp (the home of the least-hit bucket
    // under skew; read after the next barrier)
    const int64_t qb0 = sc / qcpb;
    const int nblk = (int)((se - 1) / qcpb - qb0) + 1;
    float* sc9 = P.scl[parity];
    if (wp == kBWarps - 1) {
      uint32_t bad = 0;
      for (int i = lane; i < 9 * nblk; i += 32) {
        const float x = S.scales[qb0 * 9 + i];
        sc9[i] = x;
        if (!isfinite(x)) bad |= 1u << (i / 9);
      }
      bad = __reduce_or_sync(~0u, bad);
      if (lane == 0) P.bad[parity] = bad;
    }
    // 1. the pair's keys: block in the segment, bucket and tile (bin / 16
    // - 8 b0), or -1: dropped
    const int64_t r = sc * kChunk + 2 * tid;
    const bool mine = 2 * tid < seg_rows;
    const int bib = mine ? (int)(r / kChunk / qcpb - qb0) : 0;
    int key[2], rank[2] = {0, 0};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k =
          (int)((w.bins >> (16 * i)) & 0xFFFFu) / 16 - kTiles * b0;
      key[i] = (mine && r + i < S.n && k >= 0 && k < kTiles * nbc)
                   ? (bib << 6) | k
                   : -1;
    }
    // 2. ranks and counts
    rank_blocks(P.off[wp], key, rank, nblk);
    __syncthreads();
    // 3. each (bucket, block) run's places, then the rows there and each
    // run's padding on its last tile
    if (home) qrun_offsets(sh, P, wp, b0, nblk);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (key[i] >= 0)
        put_row<kInt8Span>(sh, P.off[wp][key[i]] + rank[i],
                       (w.bins >> (16 * i)) & 0xFFFFu, none, w, i);
    __syncthreads();
    // 4. the home steps block by block, each block's sums folded by its
    // scales; the helper runs dealt to this warp into their slots
    const QDeal d = make_qdeal(P, nbc, nblk);
    const int hlen = __shfl_sync(~0u, d.H, wp);
    const int slo = __shfl_sync(~0u, d.rbase, wp),
              shi = slo + __shfl_sync(~0u, d.nr, wp);
    uint32_t load = lane < nbc ? (uint32_t)d.H : 0u;
    uint32_t folded = 0;
    int ci[kTiles][2][4];
    if (home)
      for (int j = 0; j < nblk; ++j) {
        const int s0 = P.bstep[wp][j], s1 = min(P.bstep[wp][j + 1], hlen);
        if (s1 <= s0) continue;
        const int n = P.nrow[wp][j];
        if (n <= kQScalarRows && s1 == P.bstep[wp][j + 1]) {
          // a block whose scale is not finite still takes fold_nonfinite
          add_rows(acc, sh, wp * kRegion + kStep * s0, n,
                   (b0 + wp) * kWarpLanes, sc9 + 9 * j);
          continue;
        }
        zero_sums(ci);
        bucket_run_int8(ci, sh, wp * kRegion + kStep * s0, s1 - s0, hids);
        fold_levels(acc, ci, sc9 + 9 * j);
        folded |= 1u << j;
      }
    for (int q = 0; q < d.NR; ++q) {
      const QRun u = qdeal_run(P, d, q, nbc, nblk, load);
      if (u.warp != wp) continue;
      zero_sums(ci);
      bucket_run_int8(ci, sh, u.pos, u.len,
                      make_int8_ids((b0 + u.bucket) * kWarpLanes + g));
      put_slot(sh.slots + q * kSlotWords, ci);
      if (lane == 0) P.rblk[q] = u.blk;
    }
    // the next segment's rows, loaded only now: held through the multiply
    // they cost the int32 sums registers
    if (nsc < G.end) load_rows<kInt8Span, L>(S, fa, nsc * kChunk + 2 * tid, w);
    __syncthreads();
    if (home) {
      zero_sums(ci);
      for (int q = slo; q < shi; ++q) {
        add_slot(ci, sh.slots + q * kSlotWords);
        const int j = P.rblk[q];
        if (q + 1 == shi || P.rblk[q + 1] != j) {
          fold_levels(acc, ci, sc9 + 9 * j);
          folded |= 1u << j;
          zero_sums(ci);
        }
      }
      // a block whose scale is not finite reaches every lane: the folds
      // of its runs did, and those of none here add it
      const uint32_t bad = P.bad[parity] & ~folded;
      for (int j = 0; j < nblk; ++j)
        if ((bad >> j) & 1u) fold_nonfinite(acc, sc9 + 9 * j);
    }
    parity ^= 1;
    sc = nsc;
  }
  if (cur >= 0 && home)
    flush_bucket(out + cur * slot_stride, acc, my_lane0, lanes);
}

// Launch helpers (host)

// buckets a feature, the CTAs a feature takes along y, and the buckets
// each owns (the last may own fewer)
struct BucketGeo {
  int nb, gpf, bpg;
};

static inline BucketGeo bucket_geo(int lpf) {
  BucketGeo b;
  b.nb = lpf / kWarpLanes;
  b.gpf = (b.nb + kMaxBuckets - 1) / kMaxBuckets;
  b.bpg = (b.nb + b.gpf - 1) / b.gpf;
  return b;
}

}  // namespace lgbt_oh
