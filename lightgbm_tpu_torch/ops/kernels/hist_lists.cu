// hist_lists: the pre-pass of the atomic kernels' listed design of bin
// tiles (hist_common.cuh): for each (feature, tile of tw bins, slot), the
// rows whose bin lies in the tile, as one contiguous list in row order.
//
// Replaces no TPU kernel: the Pallas kernels it serves
// (lightgbm_tpu/ops/histogram.py::_hist_pallas, _hist_leaves_pallas) add
// every row into a one-hot product of the whole width at once.  It exists
// because on this card one feature's [B, 3] float64 histogram does not
// fit a CTA above ~8,900 bins: the bins are split into tiles, and
// without lists every tile's CTA would walk every row.
//
// Rows come in chunks of cr rows (the full pass: kListRows; the leaves:
// the widest divisor of their block_rows up to kListRows, so a chunk lies
// in one block of one slot, block_leaf[row / br]; a block whose slot lies
// outside [0, k) is dropped).  A row whose bin is >= B, or whose three
// float32 products (g*m, h*m, m) are all zero, adds nothing and is listed
// nowhere; so is every row of a dropped block.  Five kernels, in order on
// the stream:
//
// 1. order: the chunks' order by slot, stable (one CTA; the full pass:
//    every chunk, in order), and where each slot's chunks start in it;
// 2. count: a CTA a (chunk, group of kListGroup features) stages the
//    chunk's rows (the group's columns and g, h, m) kListStage at a time,
//    the next tile while one is read, a warp a feature: it counts each
//    tile's rows of the chunk (a shared-memory atomicAdd a listed row)
//    and writes the feature's listed rows, compacted in row order (a
//    ballot's rank), into the chunk's region of `tmp` as row in chunk |
//    bin << 16 -- every store coalesced; the first group's CTAs also
//    write the rows' gh4;
// 3. scan: a warp a (feature, tile) turns the chunks' counts, in slot
//    order, into each chunk's offset in the list, the list's length and
//    where each slot's segment starts;
// 4. base: a CTA a feature places its lists one after another from j *
//    cap, and numbers the segments' units (lgbt::Lists); it also resets
//    the main kernel's flags and unit counter;
// 5. copy: a warp a (chunk, feature) reads its region of tmp in row order
//    and sorts it by tile in shared memory (each entry at its tile's
//    local offset plus its rank among the step's lanes of its tile,
//    lgbt::match_bits, so each list keeps row order), then writes it out
//    run by run: entry i of tile t at its list's place less its local one
//    plus i, consecutive lanes at consecutive places.  (Stores straight
//    into the lists, or into a chunk-sorted tmp region, went each to one
//    of many heads whose partly written sectors left L2 before they
//    filled: 2-3 ms and 0.8-1.4 ms at 1M x 28 on an H100; PERF.md.)
//
// Bound on an H100: it reads the rows' bins and (g, h, m) once, writes and
// reads 4 bytes an entry of tmp, writes 6 bytes an entry (ids int32, lbin
// u16) and 16 a row (gh4); the counts and offsets tables are (chunks x f
// x T) int32.  Its byte bound counts the rows once and the entries and
// gh4 once.
//
// Memory: one buffer a call (histogram.py::_list_layout), freed after it.
// A (row, feature) pair of the call takes ids 4 bytes, lbin 2, tmp 4 (read
// only by copy), cnt and offs 8 T / cr (0.5 at T = 256, cr = 4,096; 4 at
// the leaves' cr = 512); a row gh4's 16; a segment (f x T x k of them) 24
// bytes of tables and the main kernel's [2^tw_log2, 3] float64 sum.  At 1M
// x 28, B = 65,536: 311 MB of lists, 11.1 bytes a pair against the u16
// bins' 2, and 44 MB of sums.  The wrapper bounds it: a call whose buffer
// the card cannot allocate beside its output runs its features in passes
// of half as many until they fit, each its own launch of these kernels on
// the columns of the pass, and keeps them for later calls of the shape
// (histogram.py::halve_passes; at least one feature a pass, ~11 bytes a
// row), and only a feature that no budget holds raises.
//
// tmp stays.  Without it the copy kernel would re-stage its chunk's rows
// from the bins: a warp a (chunk, feature) reads 2 bytes of each row of a
// row-major matrix (a 32-byte sector a row at 1M x 28: 16 times the bytes
// it keeps), so the chunk's rows would be read once for each of the 28
// features, against tmp's 4 bytes an entry written and read once,
// coalesced; and it would redo the count's ballots to find each row's
// place.  By bytes that is about 0.9 GB of reads for 1M x 28 against
// tmp's 0.22 GB, more than the pre-pass takes now (a reckoning from the
// shapes, not a timing).
#include "hist_common.cuh"

namespace lgbt {

// Exclusive sum over the CTA's threads (blockDim.x a multiple of 32, at
// most 1024) of v, and the CTA's total; every thread calls it.
__device__ __forceinline__ long long block_exclusive(long long v,
                                                     long long* tmp,
                                                     long long& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  __syncthreads();  // an earlier call's readers are done with tmp
  if (lane == 31) tmp[warp] = incl;
  __syncthreads();
  long long before = 0;
  total = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const long long x = tmp[w];
    if (w < warp) before += x;
    total += x;
  }
  return before + incl - v;
}

// The arguments of the count and copy passes.
struct PassArgs {
  const uint8_t* bins;
  long long n, stride;  // rows; a row's bins
  const float* g;
  const float* h;
  const float* m;
  const int32_t* block_leaf;  // nullptr: the full pass (slot 0)
  int cr, br, k;              // rows a chunk; rows a block; slots
  int f, B, T, tw_log2, fg;   // features, width, tiles, tile bins, group
  long long cap;              // entries a feature's region holds
  int32_t* cnt;               // [chunks][f][T]: counts (count writes)
  const int32_t* offs;        // [chunks][f][T]: offsets in the list
  const int32_t* list_base;   // [f][T]: a list's start in its region
  uint32_t* tmp;              // [chunks][f][cr]: row in chunk | bin << 16
  int32_t* ids;
  uint16_t* lbin;
  float4* gh4;                // [n]: written by count's first group
};

// The shared bytes of a count CTA: its features' counts [fg][T] and
// listed rows so far [fg], and two staged tiles of kListStage rows.
__host__ __device__ inline long long count_smem_bytes(int fg, int T,
                                                     long long stride_b,
                                                     int fgb) {
  return round16(4LL * fg * (T + 1)) +
         2 * (bin_region(kListStage, stride_b, fgb) +
              3 * val_span(kListStage));
}
// Warps of a copy CTA, and a warp's shared bytes: local offsets and
// list places [2][T], and the chunk's entries in tile order [cr].  (Their
// u16 indices into tmp in place of the entries, for 20 warps an SM in
// place of 12, made the write-out gather from tmp: slower on the card.)
constexpr int kCopyWarps = 4;
__host__ __device__ inline int copy_warp_bytes(int T, int cr) {
  return (int)round16(8LL * T + 4LL * cr);
}

// The chunk's slot is valid (every chunk of the full pass).
__device__ __forceinline__ bool chunk_listed(const PassArgs& a, int c) {
  if (a.block_leaf == nullptr) return true;
  const int s = a.block_leaf[(int)((long long)c * a.cr / a.br)];
  return s >= 0 && s < a.k;
}

// The lanes of the warp whose key equals this lane's, keys of nbits bits
// (at most 9): one ballot a bit, each lane keeping the lanes that agree
// with it -- a fixed cost, where same-word atomics serialise a hot key
// and __match_any_sync costs more the more distinct keys a step holds.
__device__ __forceinline__ unsigned match_bits(uint32_t key, int nbits) {
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b < 9; ++b) {
    if (b < nbits) {
      const bool bit = (key >> b) & 1u;
      const unsigned on = __ballot_sync(kFull, bit);
      peers &= bit ? on : ~on;
    }
  }
  return peers;
}

// An exclusive sum of v[0 .. nt) by one warp, in place; returns the total.
__device__ __forceinline__ int warp_exclusive(int32_t* v, int nt, int lane) {
  int carry = 0;
  for (int t0 = 0; t0 < nt; t0 += 32) {
    const int t = t0 + lane;
    const int x = t < nt ? v[t] : 0;
    int incl = x;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (t < nt) v[t] = carry + incl - x;
    carry += __shfl_sync(kFull, incl, 31);
  }
  return carry;
}

}  // namespace lgbt

// 1. One CTA: order[0 .. nvalid) the chunks of valid slot, stably by slot;
// slot_start[s] where slot s's start, slot_start[k] = nvalid.
__global__ void __launch_bounds__(1024)
    hist_lists_order_kernel(const int32_t* __restrict__ block_leaf, int nc,
                            int cr, int br, int k,
                            int32_t* __restrict__ order,
                            int32_t* __restrict__ slot_start) {
  extern __shared__ int32_t counts[];  // [k + 1], then run[k]
  int32_t* run = counts + k + 1;
  if (block_leaf == nullptr) {
    for (int p = threadIdx.x; p < nc; p += blockDim.x) order[p] = p;
    if (threadIdx.x == 0) {
      slot_start[0] = 0;
      slot_start[1] = nc;
    }
    return;
  }
  auto slot_of = [&](int c) {
    return block_leaf[(int)((long long)c * cr / br)];
  };
  for (int s = threadIdx.x; s <= k; s += blockDim.x) counts[s] = 0;
  __syncthreads();
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    const int s = slot_of(c);
    if (s >= 0 && s < k) atomicAdd(counts + s, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int s = 0; s < k; ++s) {
      run[s] = slot_start[s] = acc;
      acc += counts[s];
    }
    slot_start[k] = acc;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < nc; base += 32) {
    const int c = base + lane;
    const int s = c < nc ? slot_of(c) : -1;
    const bool ok = s >= 0 && s < k;
    const unsigned peers = __match_any_sync(lgbt::kFull, ok ? s : -1);
    if (ok) order[run[s] + __popc(peers & below)] = c;
    __syncwarp();
    if (ok && (peers & below) == 0) run[s] += __popc(peers);
    __syncwarp();
  }
}

// 2. A CTA a (chunk, feature group), blockIdx.x = chunk * groups + group:
// the groups of one chunk run side by side and read its rows from L2.
// kListWarps warps.
template <typename T>
__global__ void __launch_bounds__(32 * lgbt::kListWarps)
    hist_lists_count_kernel(const lgbt::PassArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int groups = (a.f + a.fg - 1) / a.fg;
  const int c = blockIdx.x / groups;
  if (!lgbt::chunk_listed(a, c)) return;
  const int f0 = (blockIdx.x - c * groups) * a.fg;
  const int fgl = min(a.fg, a.f - f0);
  const int nt = a.T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int32_t* cnt = reinterpret_cast<int32_t*>(smem);  // [fg][T]
  int32_t* listed_so_far = cnt + a.fg * nt;         // [fg]
  uint8_t* stage = smem + lgbt::round16(4LL * a.fg * (nt + 1));
  for (int i = threadIdx.x; i < fgl * nt; i += blockDim.x) cnt[i] = 0;
  for (int i = threadIdx.x; i < fgl; i += blockDim.x) listed_so_far[i] = 0;
  const int esz = (int)sizeof(T);
  const lgbt::Stage st =
      lgbt::stage_of(lgbt::kListStage, a.stride * esz, a.fg * esz);
  const int sb = st.bin_region + 3 * st.val_region;
  const lgbt::Rows src{a.bins, a.stride * esz, esz, a.g, a.h, a.m};
  const long long c0 = (long long)c * a.cr;
  const long long c1 = min(a.n, c0 + a.cr);
  const int ntiles = (int)((c1 - c0 + lgbt::kListStage - 1) /
                           lgbt::kListStage);
  auto rows_of = [&](int i) {
    return (int)min((long long)lgbt::kListStage,
                    c1 - c0 - (long long)i * lgbt::kListStage);
  };
  lgbt::stage_tile(stage, st, src, c0, rows_of(0), f0, fgl);
  lgbt::cp_commit();
  for (int i = 0; i < ntiles; ++i) {
    lgbt::cp_wait_all();
    __syncthreads();  // tile i is in; every warp is done with tile i - 1
    if (i + 1 < ntiles) {
      lgbt::stage_tile(stage + ((i + 1) & 1) * sb, st, src,
                       c0 + (long long)(i + 1) * lgbt::kListStage,
                       rows_of(i + 1), f0, fgl);
      lgbt::cp_commit();
    }
    const long long r0 = c0 + (long long)i * lgbt::kListStage;
    const int nrows = rows_of(i);
    const lgbt::Tile t = lgbt::tile_at(stage + (i & 1) * sb, st, src, r0, f0);
    if (f0 == 0)
      for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
        const float w = t.m[r];
        a.gh4[r0 + r] = make_float4(t.g[r] * w, t.h[r] * w, w, 0.f);
      }
    for (int fl = warp; fl < fgl; fl += lgbt::kListWarps) {
      int32_t* fc = cnt + fl * nt;
      uint32_t* out = a.tmp + ((long long)c * a.f + f0 + fl) * a.cr;
      int so_far = listed_so_far[fl];
      for (int base = 0; base < nrows; base += 32) {
        lgbt::StepRow v;
        const bool live = lgbt::load_row(t, base + lane, nrows, v);
        const uint32_t bin =
            live ? (uint32_t)reinterpret_cast<const T*>(t.bins + v.at)[fl]
                 : lgbt::kNoBin;
        const bool listed = bin < (uint32_t)a.B;
        const unsigned on = __ballot_sync(lgbt::kFull, listed);
        if (listed) {
          atomicAdd(fc + (bin >> a.tw_log2), 1);
          out[so_far + __popc(on & below)] =
              (uint32_t)(r0 - c0 + base + lane) | bin << 16;
        }
        so_far += __popc(on);
      }
      __syncwarp();
      if (lane == 0) listed_so_far[fl] = so_far;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < fgl * nt; i += blockDim.x)
    a.cnt[((long long)c * a.f + f0) * nt + i] = cnt[i];
}

// 5. A warp a (chunk c, feature j), wid = c * f + j; kCopyWarps warps a
// CTA, each with copy_warp_bytes of shared memory.
__global__ void __launch_bounds__(32 * lgbt::kCopyWarps)
    hist_lists_copy_kernel(const lgbt::PassArgs a, int nc) {
  extern __shared__ __align__(16) uint8_t csm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long wid = (long long)blockIdx.x * lgbt::kCopyWarps + warp;
  if (wid >= (long long)nc * a.f) return;
  const int c = (int)(wid / a.f), j = (int)(wid - (long long)c * a.f);
  if (!lgbt::chunk_listed(a, c)) return;
  const int nt = a.T;
  const unsigned below = (1u << lane) - 1u;
  int32_t* loff = reinterpret_cast<int32_t*>(
      csm + (long long)warp * lgbt::copy_warp_bytes(nt, a.cr));
  int32_t* d = loff + nt;
  uint32_t* buf = reinterpret_cast<uint32_t*>(d + nt);
  const long long row = wid * nt;
  for (int t = lane; t < nt; t += 32) loff[t] = a.cnt[row + t];
  __syncwarp();
  const int total = lgbt::warp_exclusive(loff, nt, lane);
  __syncwarp();
  for (int t = lane; t < nt; t += 32)
    d[t] = a.list_base[j * nt + t] + a.offs[row + t] - loff[t];
  // the chunk's entries sorted by tile, stably
  const uint32_t* in = a.tmp + wid * a.cr;
  const int kbits = 32 - __clz(nt);  // bits of the keys 0 .. nt
  for (int i0 = 0; i0 < total; i0 += 256) {
    uint32_t e[8];  // eight steps' entries in flight, then the eight steps
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + 32 * u + lane;
      e[u] = i < total ? in[i] : 0u;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + 32 * u + lane;
      const uint32_t key =
          i < total ? (e[u] >> 16) >> a.tw_log2 : (uint32_t)nt;
      const unsigned peers = lgbt::match_bits(key, kbits);
      __syncwarp();  // loff is current (the last step's tails)
      if (i < total) buf[loff[key] + __popc(peers & below)] = e[u];
      __syncwarp();
      if (i < total && (peers >> lane) == 1u) loff[key] += __popc(peers);
    }
  }
  __syncwarp();
  // out run by run, four entries a lane in flight
  const uint32_t tmask = (1u << a.tw_log2) - 1u;
  const long long fbase = (long long)j * a.cap;
  for (int i0 = 0; i0 < total; i0 += 128) {
    uint32_t e[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + 32 * u + lane;
      e[u] = i < total ? buf[i] : 0u;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + 32 * u + lane;
      if (i >= total) continue;
      const uint32_t bin = e[u] >> 16;
      const long long at = fbase + d[bin >> a.tw_log2] + i;
      a.ids[at] = (int32_t)((long long)c * a.cr + (e[u] & 0xffffu));
      a.lbin[at] = (uint16_t)(bin & tmask);
    }
  }
}

// 3. A warp a (feature j, tile t), wid = j * T + t: offs from cnt.
__global__ void __launch_bounds__(256)
    hist_lists_scan_kernel(const int32_t* __restrict__ order,
                           const int32_t* __restrict__ slot_start,
                           const int32_t* __restrict__ cnt,
                           int32_t* __restrict__ offs,
                           int32_t* __restrict__ tot,
                           int32_t* __restrict__ seg_rel, int f, int T,
                           int k) {
  const int lane = threadIdx.x & 31;
  const long long wid =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (wid >= (long long)f * T) return;
  const int j = (int)(wid / T), t = (int)(wid - (long long)j * T);
  const int nvalid = slot_start[k];
  auto at = [&](int p) { return ((long long)order[p] * f + j) * T + t; };
  int carry = 0;
  for (int p0 = 0; p0 < nvalid; p0 += 128) {
    long long w[4];  // four steps' loads in flight, then their sums
    int c[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = p0 + 32 * u + lane;
      w[u] = p < nvalid ? at(p) : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) c[u] = w[u] >= 0 ? cnt[w[u]] : 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      int incl = c[u];
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(lgbt::kFull, incl, d);
        if (lane >= d) incl += y;
      }
      if (w[u] >= 0) offs[w[u]] = carry + incl - c[u];
      carry += __shfl_sync(lgbt::kFull, incl, 31);
    }
  }
  if (lane == 0) tot[wid] = carry;
  __syncwarp();
  for (int s = lane; s < k; s += 32) {
    const int ps = slot_start[s];
    seg_rel[wid * k + s] = ps < nvalid ? offs[at(ps)] : carry;
  }
}

// 4. A CTA a feature j, a thread a tile (blockDim.x: T rounded up to 32).
__global__ void __launch_bounds__(1024)
    hist_lists_base_kernel(const int32_t* __restrict__ tot,
                           const int32_t* __restrict__ seg_rel,
                           int32_t* __restrict__ list_base,
                           long long* __restrict__ seg_off,
                           int32_t* __restrict__ seg_len,
                           int32_t* __restrict__ seg_ubase,
                           int32_t* __restrict__ unit_seg,
                           int32_t* __restrict__ flags,
                           int32_t* __restrict__ counter, int T, int k,
                           long long cap, int unit, int per_feature) {
  __shared__ long long tmp[32];
  const int j = blockIdx.x, t = threadIdx.x;
  const bool mine = t < T;
  const long long lt = (long long)j * T + t;
  const int total = mine ? tot[lt] : 0;
  long long all;
  const long long base = lgbt::block_exclusive(total, tmp, all);
  auto len_of = [&](int s) {
    const int end = s + 1 < k ? seg_rel[lt * k + s + 1] : total;
    return end - seg_rel[lt * k + s];
  };
  auto units_of = [&](int len) {
    return len > unit ? (len + unit - 1) / unit : 1;
  };
  int nunits = 0;
  if (mine) {
    list_base[lt] = (int32_t)base;
    for (int s = 0; s < k; ++s) nunits += units_of(len_of(s));
  }
  long long uall;
  int ub = (int)lgbt::block_exclusive(nunits, tmp, uall);
  int32_t* us = unit_seg + (long long)j * per_feature;
  if (mine) {
    for (int s = 0; s < k; ++s) {
      const long long seg = lt * k + s;
      const int len = len_of(s), nu = units_of(len);
      seg_off[seg] = (long long)j * cap + base + seg_rel[seg];
      seg_len[seg] = len;
      seg_ubase[seg] = j * per_feature + ub;
      flags[seg] = 0;
      for (int c = 0; c < nu; ++c) us[ub + c] = (int32_t)seg;
      ub += nu;
    }
  }
  for (long long i = uall + t; i < per_feature; i += blockDim.x) us[i] = -1;
  if (j == 0 && t == 0) *counter = 0;
}

namespace {

// The lists' buffers, in the order of the launch's ptrs array: the nine
// of lgbt::launch_listed, then the pre-pass's own tables.
struct Buffers {
  int32_t* ids;
  uint16_t* lbin;
  long long* seg_off;
  int32_t *seg_len, *seg_ubase, *unit_seg, *flags, *counter;
  float4* gh4;
  int32_t *order, *slot_start, *cnt, *offs, *tot, *seg_rel, *list_base;
  uint32_t* tmp;
};

Buffers buffers_of(const long long* p) {
  auto i32 = [&](int i) { return reinterpret_cast<int32_t*>(p[i]); };
  return Buffers{i32(0),  reinterpret_cast<uint16_t*>(p[1]),
                 reinterpret_cast<long long*>(p[2]),
                 i32(3),  i32(4),  i32(5),  i32(6),  i32(7),
                 reinterpret_cast<float4*>(p[8]),
                 i32(9),  i32(10), i32(11), i32(12), i32(13), i32(14),
                 i32(15), reinterpret_cast<uint32_t*>(p[16])};
}

template <typename T>
cudaError_t launch_passes(int device, const lgbt::PassArgs& a, int nc,
                          const Buffers& q, int unit, int per_feature,
                          cudaStream_t s) {
  const int esz = (int)sizeof(T);
  const int psmem = (int)lgbt::count_smem_bytes(a.fg, a.T, a.stride * esz,
                                                a.fg * esz);
  const int csmem = lgbt::kCopyWarps * lgbt::copy_warp_bytes(a.T, a.cr);
  const int ordsmem = (2 * a.k + 1) * 4;
  cudaError_t e =
      lgbt::allow_smem(hist_lists_count_kernel<T>, device, psmem);
  if (e == cudaSuccess)
    e = lgbt::allow_smem(hist_lists_copy_kernel, device, csmem);
  if (e == cudaSuccess)
    e = lgbt::allow_smem(hist_lists_order_kernel, device, ordsmem);
  if (e != cudaSuccess) return e;
  hist_lists_order_kernel<<<1, 1024, ordsmem, s>>>(a.block_leaf, nc, a.cr,
                                                   a.br, a.k, q.order,
                                                   q.slot_start);
  hist_lists_count_kernel<T>
      <<<(unsigned)((a.f + a.fg - 1) / a.fg * nc), 32 * lgbt::kListWarps,
         psmem, s>>>(a);
  const long long warps = (long long)a.f * a.T;
  hist_lists_scan_kernel<<<(unsigned)((warps + 7) / 8), 256, 0, s>>>(
      q.order, q.slot_start, q.cnt, q.offs, q.tot, q.seg_rel, a.f, a.T, a.k);
  hist_lists_base_kernel<<<a.f, (a.T + 31) / 32 * 32, 0, s>>>(
      q.tot, q.seg_rel, q.list_base, q.seg_off, q.seg_len, q.seg_ubase,
      q.unit_seg, q.flags, q.counter, a.T, a.k, a.cap, unit, per_feature);
  const long long copies = (long long)nc * a.f;
  hist_lists_copy_kernel<<<(unsigned)((copies + lgbt::kCopyWarps - 1) /
                                      lgbt::kCopyWarps),
                           32 * lgbt::kCopyWarps, csmem, s>>>(a, nc);
  return cudaGetLastError();
}

}  // namespace

// The lists of one call.  bins: n rows of `stride` bins of esz bytes (1:
// u8, 2: u16), features [0, f) of B bins; g, h, m per row; the rows in
// nc = ceil(n / cr) chunks of cr rows (at most 65,536; cr divides br
// where block_leaf is given); block_leaf (nullptr: the full pass, one
// slot) maps each block of br rows to a slot in [0, k); tiles of
// 2^tw_log2 bins (T = ceil(B / 2^tw_log2) <= 256); units of `unit`
// entries, per_feature units a feature (T * k + ceil(n / unit)); cap = n
// entries a feature.  ptrs: the seventeen buffers of Buffers: ids [f *
// cap] int32, lbin [f * cap] u16, seg_off [f * T * k] int64, seg_len,
// seg_ubase [f * T * k] int32, unit_seg [f * per_feature] int32, flags
// [f * T * k], counter [1], gh4 [n] float4, then order [nc], slot_start
// [k + 1], cnt and offs [nc * f * T], tot [f * T], seg_rel [f * T * k],
// list_base [f * T], all int32, and tmp [nc * f * cr] u32.
extern "C" int hist_lists_launch(int device, const void* bins, long long n,
                                 long long stride, int f, int B, int esz,
                                 const void* g, const void* h, const void* m,
                                 const void* block_leaf, int cr, int br,
                                 int k, int tw_log2, int unit,
                                 int per_feature, const long long* ptrs,
                                 void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int T = (B + (1 << tw_log2) - 1) >> tw_log2;
  if (n < 1 || f < 1 || cr < 1 || cr > 65536 || br < 1 || k < 1 ||
      unit < 1 || tw_log2 < 0 || tw_log2 > lgbt::kListTileLog2 || T > 256 ||
      (block_leaf == nullptr ? k != 1 : br % cr != 0))
    return (int)cudaErrorInvalidValue;
  const int nc = (int)((n + cr - 1) / cr);
  const Buffers q = buffers_of(ptrs);
  const lgbt::PassArgs a{reinterpret_cast<const uint8_t*>(bins), n, stride,
                         (const float*)g, (const float*)h, (const float*)m,
                         (const int32_t*)block_leaf, cr, br, k, f, B, T,
                         tw_log2,
                         f < lgbt::kListGroup ? f : lgbt::kListGroup, n,
                         q.cnt, q.offs, q.list_base, q.tmp, q.ids, q.lbin,
                         q.gh4};
  const cudaStream_t s = (cudaStream_t)stream;
  if (esz == 1)
    return (int)launch_passes<uint8_t>(device, a, nc, q, unit, per_feature,
                                       s);
  if (esz == 2)
    return (int)launch_passes<uint16_t>(device, a, nc, q, unit, per_feature,
                                        s);
  return (int)cudaErrorInvalidValue;
}
