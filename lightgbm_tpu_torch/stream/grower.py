"""Streaming tree growth: the serial grower's semantics over host blocks.

Port of the JAX package's ``stream/grower.py``.  One tree is grown with
the structural semantics of the port's sequential grower
(``ops/grower.grow_tree_serial``): best-first expansion of the max-gain
leaf (lowest leaf id on a tie), the smaller child's histogram and the
sibling by subtraction, the left child keeps the parent's leaf id, the
per-node feature sampling and extra-trees thresholds keyed by the split
step, basic monotone pinching.  What changes is WHERE the data lives:

- the bins stay in host RAM (``HostBinMatrix``); each histogram pass
  streams row blocks through the ``RowBlockPipeline`` (the copy of block
  k+1 on the copy stream behind the pass on block k), and each block's
  histogram is the K1 kernel (``hist_full``, or ``onehot_full``
  featmajor under ``force_row_wise``) by ``accumulate_histogram`` into a
  float32 ``[F, B, 3]`` accumulator, so the split search
  (``ops/split.find_best_split``) is the shared one;
- the root pass accumulates the root histogram and totals; a split pass
  routes each block's rows of the splitting leaf and accumulates the
  smaller child's histogram; the larger child is the parent less it, on
  the device ``[L, F, B, 3]`` store;
- leaf membership is a host ``int32`` vector per shard (pinned on the
  card, so each block's routed leaf ids come back by an asynchronous
  copy), and a per-(block, leaf) row-count table lets later passes SKIP
  blocks that hold no rows of the splitting leaf;
- the split loop runs on the host (the stream is host-paced anyway); each
  split costs one device sync, which reads the two children's candidate
  splits and the pass's per-block counts together.

Several shards (row partitions) sum their histograms in one process;
``cross_reduce`` (optional) joins the partials of other processes, taking
and returning a numpy array, so every rank applies the identical split.

Float caveat (as in every sharded learner): block-wise float32
accumulation differs from the single-pass kernels in the last bits, so
split gains match to ~1e-6 relative and a genuinely near-tied split could
flip; features, thresholds and counts are asserted exact on tie-free data.
"""
from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..obs import metrics as obs_metrics
from ..ops.grower import (GrowerConfig, TreeArrays, _fetch_splits, _f32,
                          _HostBest, _out, kernel_width, monotone_gain_mult,
                          node_feature_mask_for, rand_thresholds_for)
from ..ops.histogram import accumulate_histogram, widen_bins
from ..ops.split import (NEG_INF, POS_INF, bitset_contains, cat_words,
                         find_best_split)
from ..utils.log import LightGBMError, check
from .host_matrix import HostBinMatrix
from .pipeline import PipelineStats, RowBlockPipeline


class StreamShard(NamedTuple):
    """One host-resident row partition."""
    matrix: HostBinMatrix
    pipeline: RowBlockPipeline


def make_shards(matrices: Sequence[HostBinMatrix], prefetch: int,
                stats: Optional[PipelineStats] = None,
                device=None) -> List[StreamShard]:
    stats = stats if stats is not None else PipelineStats()
    return [StreamShard(m, RowBlockPipeline(m, prefetch, stats, device))
            for m in matrices]


class StreamTreeGrower:
    """Grows trees from host-resident bin shards.

    Args:
      shards: local row partitions (one for single-host training).
      meta: numpy per-feature metadata — num_bins, default_bins, nan_bins,
        is_categorical, monotone (the ``Dataset.device_meta()`` fields).
      cfg: the booster's ``GrowerConfig`` (the serial grower's semantics;
        the frontier's fields are ignored).
      cross_reduce: optional host-level reduction joining other processes'
        histogram and total partials (numpy in, numpy out).
      feature_contri: optional ``[F]`` gain multipliers on the device.
      device: where the blocks go (None: the CUDA card).
    """

    def __init__(self, shards: Sequence[StreamShard], meta: dict,
                 cfg: GrowerConfig,
                 cross_reduce: Optional[Callable] = None,
                 feature_contri: Optional[torch.Tensor] = None,
                 device=None) -> None:
        check(len(shards) >= 1, "StreamTreeGrower needs >= 1 shard")
        widths = {s.matrix.num_cols for s in shards}
        check(len(widths) == 1, "stream shards must share the column width")
        if cfg.bundle_bins:
            raise LightGBMError(
                "streaming training does not support EFB bundle columns; "
                "the Dataset disables bundling when a stream budget is "
                "configured")
        self.device = resolve_device(device)
        self.shards = list(shards)
        self.cfg = cfg
        self.cross_reduce = cross_reduce
        self._contri = feature_contri
        self._f = int(widths.pop())
        self._B = kernel_width(cfg)
        self._cw = cat_words(cfg.max_bin)
        self._L = cfg.num_leaves
        dev = self.device
        self._meta = {k: np.asarray(v) for k, v in meta.items()}
        self._meta_dev = {k: torch.as_tensor(v).to(dev)
                          for k, v in self._meta.items()}
        is_cat = self._meta["is_categorical"].astype(bool)
        # the grower takes the flags only when a feature is categorical
        self._is_cat_dev = (self._meta_dev["is_categorical"]
                            if is_cat.any() else None)
        self._sorted_cat = (torch.as_tensor(cfg.sorted_cat,
                                            dtype=torch.int64).to(dev)
                            if cfg.sorted_cat else None)
        # per-(shard, block, leaf) row counts: blocks with zero rows of the
        # splitting leaf are skipped entirely (never transferred)
        self._counts = [np.zeros((s.matrix.num_blocks, self._L), np.int64)
                        for s in self.shards]
        # per-shard leaf membership on the host, updated after each split;
        # pinned on the card so the routed ids come back asynchronously
        cuda = dev.type == "cuda"
        self._leaf_t = [torch.zeros(s.matrix.num_data, dtype=torch.int32,
                                    pin_memory=cuda) for s in self.shards]
        self._leaf_np = [t.numpy() for t in self._leaf_t]
        # phase histograms: the streamed loop is host-paced, so these
        # wall-clock spans are its per-phase cost (the split one holds the
        # split's device sync)
        self._m_hist = obs_metrics.histogram("stream.hist_seconds")
        self._m_partition = obs_metrics.histogram("stream.partition_seconds")
        self._m_split = obs_metrics.histogram("stream.split_seconds")

    # ------------------------------------------------------------------
    def _hist_block(self, acc, bins, g, h, m):
        cfg = self.cfg
        return accumulate_histogram(acc, bins, g, h, m, self._B,
                                    method=cfg.hist_method,
                                    variant=cfg.hist_variant)

    def _reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Join other processes' partials (``cross_reduce``), if any."""
        if self.cross_reduce is None:
            return t
        out = np.asarray(self.cross_reduce(t.cpu().numpy()), np.float32)
        return torch.as_tensor(out).to(t.device)

    def _shard_extras(self, g, h, rw):
        out = []
        for si, sh in enumerate(self.shards):
            lo = int(self._offsets[si])
            hi = lo + sh.matrix.num_data
            out.append({"g": g[lo:hi], "h": h[lo:hi], "rw": rw[lo:hi]})
        return out

    def _accumulate_root(self, extras):
        """Root histogram and totals ``[3]`` over every shard's blocks."""
        dev = self.device
        hist = torch.zeros(self._f, self._B, 3, dtype=torch.float32,
                           device=dev)
        tot = torch.zeros(3, dtype=torch.float32, device=dev)
        for si, sh in enumerate(self.shards):
            for blk in sh.pipeline.blocks(extras[si]):
                g, h, w = (blk.extras[k] for k in ("g", "h", "rw"))
                tot = tot + torch.stack([torch.sum(g * w), torch.sum(h * w),
                                         torch.sum(w)])
                hist = self._hist_block(hist, blk.bins, g, h, w)
            counts = self._counts[si]
            counts[:] = 0
            for b in range(sh.matrix.num_blocks):
                counts[b, 0] = sh.matrix.block_rows_actual(b)
        return self._reduce(hist), self._reduce(tot)

    def _accumulate_split(self, extras, leaf, new_id, feat, thr, dleft,
                          f_is_cat, cbits, left_smaller):
        """One streamed pass applying the chosen split: each block's rows
        of ``leaf`` are routed (the right side takes ``new_id``; the ids
        come back into the host leaf vector asynchronously) and the smaller
        child's histogram accumulates.  Returns ``(histogram, pending)``,
        ``pending`` the per-shard ``(blocks, [blocks, 2] device counts of
        (left rows, leaf rows))`` that the split's one sync reads."""
        dev = self.device
        hist = torch.zeros(self._f, self._B, 3, dtype=torch.float32,
                           device=dev)
        nan_b = int(self._meta["nan_bins"][feat])
        cbits_dev = torch.as_tensor(cbits).to(dev) if f_is_cat else None
        pending = []
        for si, sh in enumerate(self.shards):
            touched = np.nonzero(self._counts[si][:, leaf] > 0)[0]
            ext = dict(extras[si], leafv=self._leaf_np[si])
            nl_nin = torch.zeros(len(touched), 2, dtype=torch.int64,
                                 device=dev)
            br = sh.matrix.block_rows
            for bi, blk in enumerate(sh.pipeline.blocks(ext, only=touched)):
                col = widen_bins(blk.bins[:, feat])
                if f_is_cat:
                    gl = bitset_contains(cbits_dev, col)
                else:
                    gl = col <= thr
                    if nan_b >= 0:
                        gl = torch.where(col == nan_b, dleft, gl)
                leafv = blk.extras["leafv"]
                in_leaf = leafv == leaf
                if blk.rows < br:           # pad rows hold leaf 0
                    in_leaf &= torch.arange(br, device=dev) < blk.rows
                left = in_leaf & gl
                right = in_leaf ^ left
                new_vec = torch.where(right, new_id, leafv)
                small = torch.where(left if left_smaller else right,
                                    blk.extras["rw"], 0.0)
                hist = self._hist_block(hist, blk.bins, blk.extras["g"],
                                        blk.extras["h"], small)
                nl_nin[bi, 0] = left.sum()
                nl_nin[bi, 1] = in_leaf.sum()
                self._leaf_t[si][blk.start:blk.start + blk.rows].copy_(
                    new_vec[:blk.rows], non_blocking=True)
            pending.append((touched, nl_nin))
        return hist, pending

    # ------------------------------------------------------------------
    def grow(self, g: np.ndarray, h: np.ndarray, rw: np.ndarray,
             feature_mask, key=None):
        """Grow one tree from host gradients; returns
        ``(TreeArrays of numpy, node_assign[num_data] int32)``.

        ``g``/``h``/``rw`` are host float32 vectors over the concatenated
        shard rows (shard 0's rows first); ``feature_mask`` is ``[F]``
        float32; ``key`` seeds the per-node draws (``feature_fraction_
        bynode``, ``extra_trees``).
        """
        cfg = self.cfg
        dev = self.device
        L, cw, f = self._L, self._cw, self._f
        p = cfg.split
        md = self._meta_dev
        self._offsets = np.concatenate(
            [[0], np.cumsum([s.matrix.num_data for s in self.shards])]
        ).astype(np.int64)
        g = np.ascontiguousarray(np.asarray(g, np.float32))
        h = np.ascontiguousarray(np.asarray(h, np.float32))
        rw = np.ascontiguousarray(np.asarray(rw, np.float32))
        for vec in self._leaf_np:
            vec[:] = 0

        leaf_depth = np.zeros(L, np.int64)
        leaf_value = np.zeros(L, np.float32)
        leaf_count = np.zeros(L, np.float32)
        leaf_weight = np.zeros(L, np.float32)
        leaf_sum_g = np.zeros(L, np.float32)
        leaf_lo = np.full(L, NEG_INF, np.float32)
        leaf_hi = np.full(L, POS_INF, np.float32)
        leaf_parent = np.full(L, -1, np.int64)
        leaf_is_left = np.zeros(L, bool)
        node_feature = np.full(L - 1, -1, np.int32)
        node_threshold = np.zeros(L - 1, np.int32)
        node_default_left = np.zeros(L - 1, bool)
        node_is_cat = np.zeros(L - 1, bool)
        node_cat_bits = np.zeros((L - 1, cw), np.int32)
        node_gain = np.zeros(L - 1, np.float32)
        node_parent = np.full(L - 1, -1, np.int64)
        node_is_left = np.zeros(L - 1, bool)
        node_value = np.zeros(L - 1, np.float32)
        node_count = np.zeros(L - 1, np.float32)

        def assemble(num_leaves: int):
            # child pointers: leaves claim their creating node's side, then
            # internal nodes overwrite the side they were grown from
            left_child = np.full(L - 1, -1, np.int32)
            right_child = np.full(L - 1, -1, np.int32)
            for lf in range(L):
                if leaf_parent[lf] >= 0:
                    side = left_child if leaf_is_left[lf] else right_child
                    side[leaf_parent[lf]] = ~lf
            for j in range(L - 1):
                if node_parent[j] >= 0 and node_feature[j] >= 0:
                    side = left_child if node_is_left[j] else right_child
                    side[node_parent[j]] = j
            return TreeArrays(
                split_feature=node_feature, threshold=node_threshold,
                default_left=node_default_left, is_cat_split=node_is_cat,
                cat_bits=node_cat_bits, split_gain=node_gain,
                left_child=left_child, right_child=right_child,
                leaf_value=leaf_value, leaf_count=leaf_count,
                leaf_weight=leaf_weight, internal_value=node_value,
                internal_count=node_count,
                num_leaves=np.array(num_leaves, np.int32))

        if f == 0:
            # no usable features: a single-leaf tree over every row
            tot = self._reduce(torch.as_tensor(np.asarray(
                [np.sum(g * rw), np.sum(h * rw), np.sum(rw)], np.float32)))
            leaf_count[0], leaf_weight[0] = float(tot[2]), float(tot[1])
            return assemble(1), np.concatenate(self._leaf_np)

        fmask_all = torch.as_tensor(np.asarray(feature_mask, np.float32)
                                    ).to(dev)
        # the per-node draws of every step a tree can name, drawn once a
        # tree and gathered by step (as the sequential grower does)
        steps = torch.arange(L + 1)
        node_masks = (node_feature_mask_for(key, steps, fmask_all,
                                            cfg.feature_fraction_bynode)
                      if cfg.feature_fraction_bynode < 1.0 else None)
        node_thr = (rand_thresholds_for(key, steps, cfg.extra_seed,
                                        md["num_bins"], md["nan_bins"])
                    if cfg.extra_trees else None)
        use_mono = cfg.has_monotone
        use_pen = use_mono and cfg.monotone_penalty > 0.0

        def fmask_of(step):
            return node_masks[step] if node_masks is not None else fmask_all

        def find(hist_b, sums, fmask, lo, hi, steps_, depths):
            st = torch.as_tensor(np.asarray(steps_, np.int64))
            rand = node_thr[st] if node_thr is not None else None
            mult = (monotone_gain_mult(
                torch.as_tensor(np.asarray(depths)).to(dev), md["monotone"],
                cfg.monotone_penalty) if use_pen else None)
            sums_d = sums.to(dev)
            return find_best_split(
                hist_b, md["num_bins"], md["nan_bins"], sums_d[0],
                sums_d[1], sums_d[2], p, fmask, output_lo=_f32(lo).to(dev),
                output_hi=_f32(hi).to(dev),
                monotone=md["monotone"] if use_mono else None,
                rand_threshold=rand, gain_mult=mult,
                is_categorical=self._is_cat_dev,
                sorted_cat=self._sorted_cat, contri=self._contri)

        extras = self._shard_extras(g, h, rw)

        # ---- root --------------------------------------------------------
        t0 = time.perf_counter()
        root_hist, tot = self._accumulate_root(extras)
        self._m_hist.observe(time.perf_counter() - t0)
        fields, bits, (tot_h,) = _fetch_splits(find(
            root_hist[None], tot[:, None], fmask_of(0)[None], [NEG_INF],
            [POS_INF], [0], [0]), tot)
        tot_h = tot_h.astype(np.float32)
        leaf_sum_g[0], leaf_weight[0], leaf_count[0] = tot_h
        best = _HostBest(L, cw)
        best.set(0, fields[:, 0], bits[0])
        store = torch.zeros(L, f, self._B, 3, dtype=torch.float32,
                            device=dev)
        store[0] = root_hist
        is_cat_np = self._meta["is_categorical"].astype(bool)
        mono_np = self._meta["monotone"].astype(np.int32)
        lid = np.arange(L)

        # ---- best-first growth (the sequential grower's loop) ------------
        num_leaves = 1
        while num_leaves < L:
            active = np.where(lid < num_leaves, best.gain,
                              np.float32(NEG_INF))
            leaf = int(np.argmax(active))
            gain = active[leaf]
            if not gain > 0.0:
                break
            j = num_leaves - 1                     # node slot of this split
            new_id = num_leaves
            feat = int(best.feature[leaf])
            thr = int(best.threshold[leaf])
            dleft = bool(best.default_left[leaf])
            cbits = best.cat_bits[leaf].copy()
            lg, lh, lc, rg, rh, rc, lout, rout = best.sums[leaf]
            f_is_cat = bool(is_cat_np[feat])
            left_smaller = bool(lc <= rc)

            node_feature[j] = feat
            node_threshold[j] = thr
            node_default_left[j] = dleft
            node_is_cat[j] = f_is_cat
            node_cat_bits[j] = cbits
            node_gain[j] = gain
            node_parent[j] = leaf_parent[leaf]
            node_is_left[j] = leaf_is_left[leaf]
            node_value[j] = _out(leaf_sum_g[leaf], leaf_weight[leaf],
                                 leaf_count[leaf], p)
            node_count[j] = leaf_count[leaf]

            # ---- streamed partition + smaller-child histogram -----------
            t0 = time.perf_counter()
            small, pending = self._accumulate_split(
                extras, leaf, new_id, feat, thr, dleft, f_is_cat, cbits,
                left_smaller)
            small = self._reduce(small)
            self._m_partition.observe(time.perf_counter() - t0)

            # ---- child bookkeeping --------------------------------------
            depth = leaf_depth[leaf] + 1
            leaf_depth[leaf] = leaf_depth[new_id] = depth
            leaf_value[leaf], leaf_value[new_id] = lout, rout
            leaf_count[leaf], leaf_count[new_id] = lc, rc
            leaf_weight[leaf], leaf_weight[new_id] = lh, rh
            leaf_sum_g[leaf], leaf_sum_g[new_id] = lg, rg
            leaf_parent[leaf] = leaf_parent[new_id] = j
            leaf_is_left[leaf], leaf_is_left[new_id] = True, False
            # basic monotone: pinch both children at their outputs' midpoint
            mono = mono_np[feat]
            lo, hi = leaf_lo[leaf], leaf_hi[leaf]
            mid = (lout + rout) * np.float32(0.5)
            leaf_lo[leaf] = max(lo, mid) if mono < 0 else lo
            leaf_hi[leaf] = min(hi, mid) if mono > 0 else hi
            leaf_lo[new_id] = max(lo, mid) if mono > 0 else lo
            leaf_hi[new_id] = min(hi, mid) if mono < 0 else hi

            # ---- the sibling by subtraction, both children's searches ---
            t0 = time.perf_counter()
            parent = store[leaf]
            lhist = small if left_smaller else parent - small
            rhist = parent - lhist
            store[leaf] = lhist
            store[new_id] = rhist
            s2 = find(torch.stack([lhist, rhist]),
                      _f32([[lg, rg], [lh, rh], [lc, rc]]),
                      fmask_of(j + 1)[None].expand(2, f),
                      [leaf_lo[leaf], leaf_lo[new_id]],
                      [leaf_hi[leaf], leaf_hi[new_id]],
                      [j + 1, j + 1], [depth, depth])
            # the split's one sync: both searches, every block's counts
            # (and, ordered before it, the routed leaf ids' copies)
            fields, bits, counts = _fetch_splits(
                s2, *[c for _, c in pending])
            self._m_split.observe(time.perf_counter() - t0)
            for si, (touched, _) in enumerate(pending):
                nl_nin = counts[si].reshape(-1, 2).astype(np.int64)
                self._counts[si][touched, leaf] = nl_nin[:, 0]
                self._counts[si][touched, new_id] = nl_nin[:, 1] - nl_nin[:, 0]
            if not (cfg.max_depth <= 0 or depth < cfg.max_depth):
                fields[0] = NEG_INF
            best.set(leaf, fields[:, 0], bits[0])
            best.set(new_id, fields[:, 1], bits[1])
            num_leaves += 1

        return assemble(num_leaves), np.concatenate(self._leaf_np)
