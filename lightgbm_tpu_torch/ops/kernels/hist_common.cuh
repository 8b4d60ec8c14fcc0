// Shared pieces of the two atomic-method histogram kernels (hist_full.cu,
// hist_leaves.cu): staging, the per-warp update, the partial write, the
// reduce pass and the launch plan.
//
// A histogram here is, per feature f and bin b, the three sums
// (sum g*m, sum h*m, sum m) over rows whose bin for f is b, each the
// float64 sum of the float32 products and rounded to float32 once.  Bins
// >= B match nothing and are dropped; a row whose three values are all
// exactly zero adds nothing and is skipped (a NaN is not zero).
//
// Bins are u8 or u16 (the template parameter T of the kernels, esz =
// sizeof(T) bytes a bin): a row of the matrix is `stride` bins, and the
// staging below counts bytes, so a u16 row of stride bins is 2 * stride
// bytes and may start at any even offset in its 16-byte piece.  B may be
// up to the widest EFB bundle (4,096 bins): the plan narrows the feature
// group until the group's histogram fits (1 feature a CTA at B = 4,096).
//
// The design (each point answers what bounded the earlier kernel, which
// added every (row, feature) into shared memory with three float64
// atomicAdds -- compare-and-swap loops on this card -- re-read every row
// once per feature group and flushed 3 * F * B float64 global atomics per
// CTA and slot change):
//
// * Warps own features.  Warp w of a CTA owns features w, w + nw, ... of
//   the CTA's group and is the only writer of their [B, 3] entries of the
//   CTA's float64 histogram in shared memory ([fg][B][3]), so nothing
//   there needs a float64 atomic.  In each 32-row step, lane l takes row l
//   of the step for each of its warp's features; the lanes that share a
//   bin find each other through a word of lane bits per bin and warp
//   (group_peers: one native 32-bit atomicOr each, the group's lowest
//   lane clears the word), and that lowest lane adds the group's sum --
//   its own row's, then its peers' in lane order, or, when the whole step
//   has a single bin, a butterfly of shuffles -- with one plain
//   read-add-write of three float64 values.  Leaders hold distinct bins,
//   so they do not race; __syncwarp() orders one step after the last.
//   (__match_any_sync finds the same groups; on the card it cost more
//   than the words, scripts/torch_atomic_ablation.py's history in
//   PERF.md.)
// * Rows are staged once per CTA: each tile of rows (its bins of the
//   group's columns, and g, h, m) is copied into shared memory by cp.async
//   in 16-byte pieces, the next tile while one is added, and every
//   feature's warp reads it there.  Narrow rows (a stride within the
//   bytes a row's pieces take) are copied as one contiguous span of the
//   [rows, stride] matrix; wider rows each copy only the pieces that hold
//   the group's columns, so a wide matrix is not read whole once per
//   group.  At F * B * 28 bytes (histogram and words) up to the 227 KB a
//   CTA may hold (F = 28 at B = 256), one CTA holds all features, so every
//   row is read once; wider problems split features over gridDim.y.
// * No flush with atomics: each CTA writes its histogram (for the
//   leaves, one per slot its blocks name) once, with plain 16-byte
//   stores, into a float64
//   partial of a scratch buffer, and a second kernel (hist_reduce_kernel)
//   sums each output entry's partials in a fixed order and writes the
//   float32 result.  The sum's order no longer depends on timing, so two
//   calls give the same bits, and the wrapper needs no zeroed accumulator
//   and no cast.
//
// What bounds it now (PERF.md, the ablation): the per-step work of each
// warp -- loading and widening its rows' values, reading its bin, the
// grouping and the update -- is repeated by every feature's warp, and one
// CTA of 28 warps an SM hides little of its latency; the kernel runs
// several times above both its byte bound and its shared-memory floor.
//
// Float64 throughout: a float32 sum of ~4,000 gradients per bin drifts by
// ~1e-4 with the order when gradients cancel; in float64 the drift is
// ~1e-13, so the rounded result is the correctly rounded sum in practice --
// the plain version's bits, which keeps trees grown through the kernels
// identical to the plain path's.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lgbt {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoBin = 0xffffffffu;  // a lane with nothing to add
constexpr int kMaxTile = 512;             // rows a tile, at most
constexpr int kMinTile = 128;  // the plan narrows the group before this
constexpr int kSmemMax = 227 * 1024;      // dynamic shared bytes a CTA may use
constexpr int kReduceThreads = 256;

// ---------------------------------------------------------------------------
// Shared-memory layout, the same on host and device: the histogram
// [fg][B][3] float64, B words of lane bits per warp (group_peers), then
// two staging buffers, each a tile's bins (one span, or `pitch` bytes a
// row) and its g, h, m spans (each with 32 bytes for the 16-byte
// alignment of the copy).
// ---------------------------------------------------------------------------

__host__ __device__ inline long long round16(long long x) {
  return (x + 15) & ~15LL;
}
__host__ __device__ inline long long hist_bytes(int fg, int B) {
  return round16(24LL * fg * B);
}
__host__ __device__ inline long long mask_bytes(int warps, int B) {
  return round16(4LL * warps * B);
}
// The bytes of the 16-byte pieces that hold fgb bytes starting anywhere.
__host__ __device__ inline int row_pitch(int fgb) {
  return 16 * ((fgb + 30) / 16);
}
// How a tile's bins are staged: as one span of the [rows, stride_b]
// matrix (0) where a row is no wider than its own pieces, else row by row
// at this pitch.  stride_b and fgb are bytes: a row's, and the group's
// columns'.
__host__ __device__ inline int stage_pitch(long long stride_b, int fgb) {
  return stride_b > row_pitch(fgb) ? row_pitch(fgb) : 0;
}
__host__ __device__ inline int val_span(int tile) {
  return (int)round16(4LL * tile) + 32;
}
__host__ __device__ inline long long bin_region(int tile, long long stride_b,
                                                int fgb) {
  const int pitch = stage_pitch(stride_b, fgb);
  return pitch ? (long long)tile * pitch
               : round16((long long)(tile - 1) * stride_b + fgb) + 32;
}
// warps of a CTA over fg features: one a feature, up to 32
__host__ __device__ inline int warps_for(int fg) {
  const int per_warp = (fg + 31) / 32;
  return (fg + per_warp - 1) / per_warp;
}
// Over fg features of B bins, tiles of `tile` rows of `stride` bins of
// esz bytes.
__host__ __device__ inline long long smem_bytes(int fg, int B, int tile,
                                                long long stride, int esz) {
  return hist_bytes(fg, B) + mask_bytes(warps_for(fg), B) +
         2LL * (bin_region(tile, stride * esz, fg * esz) + 3 * val_span(tile));
}

// ---------------------------------------------------------------------------
// Staging.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying the bytes [src, src + nbytes) into dst (16-byte aligned):
// the 16-byte pieces of device memory that hold them, so the bytes land
// at dst + src's offset in its piece.  A piece never crosses out of the
// 16-byte-aligned granule it shares with the range, so it stays inside
// the allocation.
__device__ __forceinline__ void stage_span(uint8_t* dst, const void* src,
                                          long long nbytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a0 = a & ~(uintptr_t)15;
  const long long pieces = (long long)((a + nbytes - a0 + 15) >> 4);
  for (long long i = threadIdx.x; i < pieces; i += blockDim.x)
    cp_async16(dst + 16 * i, reinterpret_cast<const void*>(a0 + 16 * i));
}

// The same, row by row: the fgb bytes from each of nrows rows `stride`
// bytes apart, row r's pieces at dst + r * pitch.
__device__ __forceinline__ void stage_rows(uint8_t* dst, const uint8_t* src,
                                          long long stride, int nrows,
                                          int fgb, int pitch) {
  const int per = pitch >> 4;
  for (int i = threadIdx.x; i < nrows * per; i += blockDim.x) {
    const int r = i / per, j = i - r * per;
    const uintptr_t a = reinterpret_cast<uintptr_t>(src + r * stride);
    const uintptr_t p = (a & ~(uintptr_t)15) + 16 * j;
    if (p < a + fgb)
      cp_async16(dst + r * pitch + 16 * j, reinterpret_cast<const void*>(p));
  }
}

// The rows of device memory a CTA reads: the bin matrix (rows of `stride`
// bytes, bins of esz bytes) and g, h, m.
struct Rows {
  const uint8_t* bins;
  long long stride;
  int esz;
  const float* g;
  const float* h;
  const float* m;
};

// Where a tile sits in a staging buffer: its bins' region, then three
// value spans; pitch as stage_pitch.
struct Stage {
  int tile, pitch, bin_region, val_region;
};

__host__ __device__ inline Stage stage_of(int tile, long long stride_b,
                                          int fgb) {
  return Stage{tile, stage_pitch(stride_b, fgb),
               (int)bin_region(tile, stride_b, fgb), val_span(tile)};
}

// A staged tile: row r's bins of the group's columns start at byte
// bins[at(r)] (an address aligned for the bin type), its values at g[r],
// h[r], m[r].
struct Tile {
  const uint8_t* bins;
  uint32_t lo;      // row 0's offset in its first piece
  uint32_t stride;  // of the matrix, in bytes
  uint32_t pitch;   // of the staged rows, 0 for one span
  const float* g;
  const float* h;
  const float* m;
  __device__ __forceinline__ uint32_t at(int r) const {
    const uint32_t o = lo + (uint32_t)r * stride;
    return pitch ? (uint32_t)r * pitch + (o & 15u) : o;
  }
};

__device__ __forceinline__ uint8_t* value_at(uint8_t* dst, const void* src) {
  return dst + (reinterpret_cast<uintptr_t>(src) & 15);
}

// Start copying rows [r0, r0 + nrows) of src, columns [f0, f0 + fg), into
// buf.
__device__ __forceinline__ void stage_tile(uint8_t* buf, const Stage& st,
                                           const Rows& src, long long r0,
                                           int nrows, int f0, int fg) {
  const uint8_t* b = src.bins + r0 * src.stride + (long long)f0 * src.esz;
  const int fgb = fg * src.esz;
  if (st.pitch)
    stage_rows(buf, b, src.stride, nrows, fgb, st.pitch);
  else
    stage_span(buf, b, (long long)(nrows - 1) * src.stride + fgb);
  uint8_t* vb = buf + st.bin_region;
  stage_span(vb, src.g + r0, 4LL * nrows);
  stage_span(vb + st.val_region, src.h + r0, 4LL * nrows);
  stage_span(vb + 2 * st.val_region, src.m + r0, 4LL * nrows);
}

// Where stage_tile puts the tile from row r0: each span at its device
// address's offset in its 16-byte piece.
__device__ __forceinline__ Tile tile_at(uint8_t* buf, const Stage& st,
                                        const Rows& src, long long r0,
                                        int f0) {
  const uintptr_t b = reinterpret_cast<uintptr_t>(
      src.bins + r0 * src.stride + (long long)f0 * src.esz);
  uint8_t* vb = buf + st.bin_region;
  return Tile{buf, (uint32_t)(b & 15), (uint32_t)src.stride,
              (uint32_t)st.pitch,
              reinterpret_cast<const float*>(value_at(vb, src.g + r0)),
              reinterpret_cast<const float*>(
                  value_at(vb + st.val_region, src.h + r0)),
              reinterpret_cast<const float*>(
                  value_at(vb + 2 * st.val_region, src.m + r0))};
}

// ---------------------------------------------------------------------------
// The update.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void add_entry(double* e, double v0, double v1,
                                          double v2) {
  e[0] += v0;
  e[1] += v1;
  e[2] += v2;
}

// The lanes of the warp whose key is this lane's (0 for kNoBin): each
// lane ORs its bit into the warp's word wm[key], reads the word back, and
// the group's lowest lane clears it again, so every word is zero between
// steps.  A native 32-bit shared atomic; it replaces __match_any_sync,
// which the card ran slower.
__device__ __forceinline__ uint32_t group_peers(uint32_t* wm, uint32_t key,
                                                unsigned below) {
  if (key != kNoBin) atomicOr(wm + key, below + 1u);
  __syncwarp();
  const uint32_t peers = key != kNoBin ? wm[key] : 0u;
  __syncwarp();
  if (key != kNoBin && (peers & below) == 0) wm[key] = 0u;
  return peers;
}

// Add rows base + j of the tile, for the set bits j of `rest` in order,
// to (v0, v1, v2).
__device__ __forceinline__ void add_peers(const Tile& t, int base,
                                          uint32_t rest, double& v0,
                                          double& v1, double& v2) {
  for (; rest != 0; rest &= rest - 1) {
    const int j = base + __ffs(rest) - 1;
    const float wj = t.m[j];
    v0 += (double)(t.g[j] * wj);
    v1 += (double)(t.h[j] * wj);
    v2 += (double)wj;
  }
}

// One row of a step: its float32 products and where its bins are staged,
// read one step ahead of their use.
struct StepRow {
  float w, gw, hw;
  uint32_t at;
};

// Row r of the tile; false past nrows or when its three values are zero.
__device__ __forceinline__ bool load_row(const Tile& t, int r, int nrows,
                                         StepRow& v) {
  v.w = v.gw = v.hw = 0.f;
  v.at = 0;
  if (r < nrows) {
    v.w = t.m[r];
    v.gw = t.g[r] * v.w;
    v.hw = t.h[r] * v.w;
    v.at = t.at(r);
  }
  return r < nrows && !(v.w == 0.f && v.gw == 0.f && v.hw == 0.f);
}

// Rows [0, nrows) of a staged tile of T bins into the CTA's histogram
// hist [fg][B][3]: warp `warp` of nw adds features warp, warp + nw, ...
// (see the top), the row's float64 values widened once for all of them;
// wm is the warp's B words for group_peers.  A bin >= B (a u16 bin may
// reach 65,535) takes no word and adds nothing.
template <typename T>
__device__ __forceinline__ void accumulate_tile(double* hist, uint32_t* wm,
                                                const Tile& t, int nrows,
                                                int fg, int B, int lane,
                                                int warp, int nw) {
  const unsigned below = (1u << lane) - 1u;
  StepRow next;
  bool next_live = load_row(t, lane, nrows, next);
  for (int base = 0; base < nrows; base += 32) {
    const StepRow cur = next;
    const bool live = next_live;
    if (base + 32 < nrows)
      next_live = load_row(t, base + 32 + lane, nrows, next);
    const double g64 = cur.gw, h64 = cur.hw, w64 = cur.w;
    for (int f = warp; f < fg; f += nw) {
      const uint32_t b =
          live ? (uint32_t)reinterpret_cast<const T*>(t.bins + cur.at)[f]
               : kNoBin;
      const uint32_t key = b < (uint32_t)B ? b : kNoBin;
      const uint32_t peers = group_peers(wm, key, below);
      const bool lead = key != kNoBin && (peers & below) == 0;
      const unsigned leaders = __ballot_sync(kFull, lead);
      double v0 = g64, v1 = h64, v2 = w64;
      if (leaders != 0 && (leaders & (leaders - 1)) == 0) {
        // one bin in this step: a butterfly over the warp, lanes of no
        // bin adding zeros
        if (key == kNoBin) v0 = v1 = v2 = 0.0;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
          v0 += __shfl_xor_sync(kFull, v0, d);
          v1 += __shfl_xor_sync(kFull, v1, d);
          v2 += __shfl_xor_sync(kFull, v2, d);
        }
      } else if (lead) {
        add_peers(t, base, peers & (peers - 1), v0, v1, v2);
      }
      if (lead) add_entry(hist + ((long long)f * B + key) * 3, v0, v1, v2);
      __syncwarp();
    }
  }
}

// Rows [r0, r1) of src, columns [f0, f0 + fg), into hist: tiles through
// two staging buffers, the next tile copied while one is added, one
// barrier a tile.  Every thread of the CTA calls it.
template <typename T>
__device__ __forceinline__ void accumulate_rows(double* hist, uint32_t* wm,
                                                uint8_t* stage,
                                                const Stage& st,
                                                const Rows& src, long long r0,
                                                long long r1, int f0, int fg,
                                                int B) {
  if (r0 >= r1) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int sb = st.bin_region + 3 * st.val_region;
  const int ntiles = (int)((r1 - r0 + st.tile - 1) / st.tile);
  auto rows_of = [&](int i) {
    return (int)min((long long)st.tile, r1 - r0 - (long long)i * st.tile);
  };
  __syncthreads();  // no warp still reads a buffer (an earlier run's tile)
  stage_tile(stage, st, src, r0, rows_of(0), f0, fg);
  cp_commit();
  for (int i = 0; i < ntiles; ++i) {
    cp_wait_all();
    __syncthreads();  // tile i is in; every warp is done with tile i - 1
    if (i + 1 < ntiles) {
      stage_tile(stage + ((i + 1) & 1) * sb, st, src,
                 r0 + (long long)(i + 1) * st.tile, rows_of(i + 1), f0, fg);
      cp_commit();
    }
    const long long ri = r0 + (long long)i * st.tile;
    accumulate_tile<T>(hist, wm, tile_at(stage + (i & 1) * sb, st, src, ri, f0),
                    rows_of(i), fg, B, lane, warp, nw);
  }
}

__device__ __forceinline__ void zero_hist(double* hist, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) hist[i] = 0.0;
}

// The CTA's regions of dynamic shared memory over fg features: the
// histogram, each warp's words (zeroed here) and the staging buffers.
struct Smem {
  double* hist;
  uint32_t* words;
  uint8_t* stage;
};

__device__ __forceinline__ Smem carve(uint8_t* smem, int fg, int B) {
  const int nw = blockDim.x >> 5;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + hist_bytes(fg, B));
  for (int i = threadIdx.x; i < nw * B; i += blockDim.x) words[i] = 0u;
  return Smem{reinterpret_cast<double*>(smem), words + (threadIdx.x >> 5) * B,
              smem + hist_bytes(fg, B) + mask_bytes(nw, B)};
}

// The CTA's histogram (n float64 values) into its partial, plain stores.
__device__ __forceinline__ void write_partial(double* __restrict__ dst,
                                              const double* src, int n) {
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n2 = n >> 1;
    const double2* src2 = reinterpret_cast<const double2*>(src);
    double2* dst2 = reinterpret_cast<double2*>(dst);
    for (int i = threadIdx.x; i < n2; i += blockDim.x) dst2[i] = src2[i];
    if ((n & 1) && threadIdx.x == 0) dst[n - 1] = src[n - 1];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

}  // namespace lgbt

// out[s][e] = float(sum of partial[p][e] over the partials p of slot s, in
// the order of p), e < E; pslot[p] names partial p's slot (-1: unused), or
// pslot == nullptr and every partial is slot 0's.  An entry no partial
// names is 0.  Grid (ceil(E / kReduceThreads), slots).
__global__ void __launch_bounds__(lgbt::kReduceThreads)
    hist_reduce_kernel(const double* __restrict__ partial,
                       const int32_t* __restrict__ pslot, int R, long long E,
                       float* __restrict__ out) {
  __shared__ int list[lgbt::kReduceThreads];
  __shared__ int wcount[lgbt::kReduceThreads / 32];
  const int s = blockIdx.y;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double acc = 0.0;
  for (int p0 = 0; p0 < R; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool mine = p < R && (pslot == nullptr ? s == 0 : pslot[p] == s);
    const unsigned bal = __ballot_sync(lgbt::kFull, mine);
    if (lane == 0) wcount[warp] = __popc(bal);
    __syncthreads();
    int at = 0, count = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      at += w < warp ? wcount[w] : 0;
      count += wcount[w];
    }
    if (mine) list[at + __popc(bal & ((1u << lane) - 1u))] = p;
    __syncthreads();
    if (e < E) {
      int i = 0;
      for (; i + 8 <= count; i += 8) {
        double v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[u] = partial[(long long)list[i + u] * E + e];
#pragma unroll
        for (int u = 0; u < 8; ++u) acc += v[u];
      }
      for (; i < count; ++i) acc += partial[(long long)list[i] * E + e];
    }
    __syncthreads();
  }
  if (e < E) out[(long long)s * E + e] = (float)acc;
}

namespace lgbt {

// ---------------------------------------------------------------------------
// Launch plan (host).
// ---------------------------------------------------------------------------

// The most rows (down to min_tile) a tile may take with g features
// of B bins in rows of `stride` bins of esz bytes, or 0 when none fits
// kSmemMax.
static inline int fit_tile(int g, int B, long long stride, int esz,
                           int min_tile) {
  for (int t = kMaxTile; t >= min_tile; t -= (t > 32 ? 32 : 1))
    if (smem_bytes(g, B, t, stride, esz) <= kSmemMax) return t;
  return 0;
}

// Feature group and tile rows of a launch over f features of B bins in
// rows of `stride` bins of esz bytes: the most features a CTA (warps_for)
// whose histogram, lane words and two staging buffers fit kSmemMax with
// tiles of at least kMinTile rows, each tile as large as then fits, so a
// wide matrix or a wide bin range takes narrower groups, not smaller
// tiles (at B = 4,096 one feature's histogram and words take 112 KB: one
// feature a CTA).  Returns false when not even one feature fits.
static inline bool plan_geometry(int f, int B, long long stride, int esz,
                                 int* fg, int* tile) {
  const int min_tiles[2] = {kMinTile, 1};
  for (int min_tile : min_tiles)
    for (int g = f; g >= 1; --g)
      if ((*tile = fit_tile(g, B, stride, esz, min_tile)) > 0) {
        *fg = g;
        return true;
      }
  return false;
}

// The share of `slots` CTA slots (CTAs an SM x SMs) that a grid of
// `groups` feature groups keeps busy over its waves, each group
// slots / groups CTAs wide (at least one), as the callers split rows.
static inline double wave_share(int groups, int slots) {
  const long long per = slots / groups > 0 ? slots / groups : 1;
  const long long ctas = per * groups;
  const long long waves = (ctas + slots - 1) / slots;
  return (double)ctas / (double)(waves * slots);
}

// Raise kern's dynamic shared-memory limit to smem on `device` where it
// is lower; the limit set is kept, so a repeated launch makes no call.
template <typename K>
static inline cudaError_t allow_smem(K kern, int device, int smem) {
  static int allowed[64] = {};
  const int d = device >= 0 && device < 64 ? device : 0;
  if (smem <= 48 * 1024 || smem <= allowed[d]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) allowed[d] = smem;
  return e;
}

// out[0..8]: fg, tile, threads, dynamic shared bytes, CTAs an SM, SMs,
// registers a thread, static shared bytes, spilled bytes a thread.  They
// depend on the shape only (not on the rows), so a caller asks once per
// shape and splits its rows over ctas_per_sm * SMs itself.  `stride` is
// in bins of esz bytes.
template <typename K>
static inline cudaError_t plan_launch(K kern, int device, long long stride,
                                      int f, int B, int esz, int* out) {
  int fg, tile;
  if (!plan_geometry(f, B, stride, esz, &fg, &tile))
    return cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  for (int pass = 0; pass < 2; ++pass) {
    const int smem = (int)smem_bytes(fg, B, tile, stride, esz);
    e = allow_smem(kern, device, smem);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, 32 * warps_for(fg), smem);
    if (e != cudaSuccess) return e;
    // Groups that leave over a quarter of the card idle in their last
    // wave (67 groups of 30 features on 132 SMs fill 51%): take the
    // widest group down to half as wide that leaves at most a tenth idle.
    const int slots = (per_sm > 0 ? per_sm : 1) * sms;
    if (pass > 0 || wave_share((f + fg - 1) / fg, slots) >= 0.75) break;
    int g = fg - 1;
    while (g >= (fg + 1) / 2 && wave_share((f + g - 1) / g, slots) < 0.9) --g;
    if (g < (fg + 1) / 2) break;
    fg = g;
    tile = fit_tile(fg, B, stride, esz, 1);
  }
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, kern);
  if (e != cudaSuccess) return e;
  out[0] = fg;
  out[1] = tile;
  out[2] = 32 * warps_for(fg);
  out[3] = (int)smem_bytes(fg, B, tile, stride, esz);
  out[4] = per_sm;
  out[5] = sms;
  out[6] = a.numRegs;
  out[7] = (int)a.sharedSizeBytes;
  out[8] = (int)a.localSizeBytes;
  return cudaSuccess;
}

static inline cudaError_t launch_reduce(const double* partial,
                                        const int32_t* pslot, int R,
                                        long long E, int slots, float* out,
                                        cudaStream_t stream) {
  const dim3 grid((unsigned)((E + kReduceThreads - 1) / kReduceThreads),
                  (unsigned)slots);
  hist_reduce_kernel<<<grid, kReduceThreads, 0, stream>>>(partial, pslot, R,
                                                          E, out);
  return cudaGetLastError();
}

}  // namespace lgbt

extern "C" const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
