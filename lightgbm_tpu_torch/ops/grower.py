"""Leaf-wise (best-first) tree growth: configuration, tree layout, routing
and the sequential grower.

Port of the JAX package's ``ops/grower.py``:
``GrowerConfig``, ``TreeArrays``, ``_BestSplits``, the per-node draws and
penalty (``node_feature_mask_for``, ``rand_thresholds_for``,
``monotone_gain_mult``, batched over split steps), the
``_frontier_eligible`` gate, and ``grow_tree``, which routes a tree to the
round-batched frontier grower (``ops/frontier.py``) or to the sequential
one-split-at-a-time grower (``grow_tree_serial``) that serves what depends
on the split order: interaction constraints, forced splits, CEGB and the
intermediate and advanced monotone modes.  Both take every histogram
width the bin types allow, on the CPU and on the card; nothing falls
back.  Both also grow a tree as one rank of a parallel learner
(``GrowerConfig.parallel_mode``, over ``parallel.mesh``): the data
learner sums the ranks' histograms (the sequential grower reduce-scatters
them to a block of features a rank, ``dp_scatter``), the feature learner
searches its block of columns and shares the split column's sides, the
voting learner sums only the elected features' histograms; the ranks'
best splits are joined by ``_reduce_split_global``.  Every host read that
steers the growth comes from a replicated value, so every rank issues the
same collectives in the same order.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..obs.tracer import DeviceRange, device_ranged
from ..utils.log import Log
from ..utils.random_gen import fold_in, uniform
from .histogram import (_OH_CHUNK, build_histogram, movable_bins,
                        widen_bins)
from .split import (NEG_INF, POS_INF, SplitParams, SplitResult,
                    bitset_contains, cat_words, find_best_split, leaf_gain,
                    leaf_output, pack_bin_bitset, voting_elect)


class GrowerConfig(NamedTuple):
    """Static grower parameters."""
    num_leaves: int
    max_depth: int            # <=0: unlimited
    max_bin: int              # histogram width B of a feature
    split: SplitParams
    # EFB: the widest bundle column's bins (the kernels' width Bb), or 0
    # when the bins are per-feature columns (Bb = max_bin)
    bundle_bins: int = 0
    # the categorical features (inner ids) wider than max_cat_to_onehot,
    # which take the sorted many-category scan (the JAX package's static
    # sorted_cat flag, as the list it is true for)
    sorted_cat: tuple = ()
    feature_fraction_bynode: float = 1.0
    extra_trees: bool = False
    extra_seed: int = 6
    has_monotone: bool = False
    monotone_mode: str = "basic"
    monotone_penalty: float = 0.0
    cegb_split_penalty: float = 0.0
    # 'auto' takes the frontier grower whenever the features allow (see
    # _frontier_eligible), 'serial' asks for the one-split loop, 'frontier'
    # asks for batching
    grower_mode: str = "auto"
    frontier_k: int = 16          # leaves expanded per round
    frontier_block_rows: int = 512  # rows per kernel block
    # histogram kernels: 'atomic' (default, force_col_wise) or 'onehot'
    # (force_row_wise) with a resolved one-hot body (ops/onehot_variants.py)
    hist_method: str = "atomic"
    hist_variant: str = "base"
    # obs_trace_device: label the phases (lgbm/hist, lgbm/split_search,
    # lgbm/partition, lgbm/apply_split, lgbm/frontier_round) as profiler
    # ranges; off, the growers call nothing more
    trace_device: bool = False
    # the parallel learners (reference {data,feature,voting}_parallel_
    # tree_learner.cpp), each rank of ``mesh`` (a parallel.mesh.ProcessMesh)
    # growing the same tree:
    #   'data'    -- rows sharded; histograms summed over the ranks
    #   'feature' -- features sharded, rows replicated; the split search
    #                sharded, the winning SplitInfo reduced
    #   'voting'  -- rows sharded; a local top-k vote elects 2k features
    #                and only their histograms are summed
    # None: the serial learner (mesh unused)
    parallel_mode: Optional[str] = None
    top_k: int = 20               # voting: local proposals per leaf
    num_shards: int = 1           # ranks (the gates' scale in voting)
    mesh: object = None


class TreeArrays(NamedTuple):
    """Flat-array tree (device layout of the reference ``Tree``, ``tree.h:25``).

    Internal node ``j`` is created at split step ``j``; child pointers encode
    leaves as ``~leaf_id`` (the reference's negative-leaf convention).  The
    same fields as the JAX package's ``TreeArrays``.
    """
    split_feature: torch.Tensor   # [L-1] i32, -1 = unused node
    threshold: torch.Tensor       # [L-1] i32 bin threshold
    default_left: torch.Tensor    # [L-1] bool
    is_cat_split: torch.Tensor    # [L-1] bool
    cat_bits: torch.Tensor        # [L-1, CW] i32 bin-bitset for cat splits
    split_gain: torch.Tensor      # [L-1] f32
    left_child: torch.Tensor      # [L-1] i32
    right_child: torch.Tensor     # [L-1] i32
    leaf_value: torch.Tensor      # [L] f32
    leaf_count: torch.Tensor      # [L] f32 (weighted)
    leaf_weight: torch.Tensor     # [L] f32 (sum of hessians)
    internal_value: torch.Tensor  # [L-1] f32 (node output, for model IO)
    internal_count: torch.Tensor  # [L-1] f32
    num_leaves: torch.Tensor      # scalar i32 (actual leaves grown)


class _BestSplits(NamedTuple):
    """Per-leaf pending best split (SoA of SplitResult over leaves)."""
    gain: torch.Tensor; feature: torch.Tensor; threshold: torch.Tensor
    default_left: torch.Tensor
    lg: torch.Tensor; lh: torch.Tensor; lc: torch.Tensor
    rg: torch.Tensor; rh: torch.Tensor; rc: torch.Tensor
    lout: torch.Tensor; rout: torch.Tensor
    cat_bits: torch.Tensor       # [n, CW] i32

    @classmethod
    def empty(cls, n: int, cw: int, device) -> "_BestSplits":
        def z():
            return torch.zeros(n, dtype=torch.float32, device=device)
        return cls(gain=torch.full((n,), NEG_INF, dtype=torch.float32,
                                   device=device),
                   feature=torch.zeros(n, dtype=torch.int32, device=device),
                   threshold=torch.zeros(n, dtype=torch.int32, device=device),
                   default_left=torch.zeros(n, dtype=torch.bool, device=device),
                   lg=z(), lh=z(), lc=z(), rg=z(), rh=z(), rc=z(),
                   lout=z(), rout=z(),
                   cat_bits=torch.zeros(n, cw, dtype=torch.int32,
                                        device=device))

    def set_rows(self, idx: torch.Tensor, s: SplitResult) -> "_BestSplits":
        """Write the ``[m]``-batched ``s`` into slots ``idx`` (in place)."""
        pairs = ((self.gain, s.gain), (self.feature, s.feature),
                 (self.threshold, s.threshold),
                 (self.default_left, s.default_left),
                 (self.lg, s.left_sum_g), (self.lh, s.left_sum_h),
                 (self.lc, s.left_count), (self.rg, s.right_sum_g),
                 (self.rh, s.right_sum_h), (self.rc, s.right_count),
                 (self.lout, s.left_output), (self.rout, s.right_output),
                 (self.cat_bits, s.cat_bits))
        for arr, val in pairs:
            arr[idx] = val
        return self


def node_feature_mask_for(key: torch.Tensor, steps: torch.Tensor,
                          feature_mask: torch.Tensor,
                          frac: float) -> torch.Tensor:
    """Per-node feature subsets ``[S, F]`` for split steps ``steps [S]``
    (the JAX package's ``node_feature_mask_for``, reference
    ``col_sampler.hpp:91`` GetByNode): keep ``max(1, round(frac *
    n_allowed))`` of the features the per-tree mask still allows, the ones
    with the largest draws of ``uniform(fold_in(key, step), F)``.  The
    draws run on the key's device and the mask is made on
    ``feature_mask``'s."""
    f_full = feature_mask.shape[0]
    u = uniform(fold_in(key, steps), f_full).to(feature_mask.device)  # [S, F]
    allowed = feature_mask > 0
    n_allowed = allowed.sum().to(torch.float32)
    frac32 = torch.tensor(frac, dtype=torch.float32, device=u.device)
    n_take = torch.clamp(torch.floor(frac32 * n_allowed + 0.5).long(),
                         1, f_full)
    u = torch.where(allowed[None, :], u, torch.full_like(u, float("-inf")))
    # lax.top_k(u, F)[0][n_take - 1]: the n_take-th largest draw
    thresh = torch.sort(u, dim=1, descending=True).values[:, n_take - 1]
    return torch.where(u >= thresh[:, None], feature_mask[None, :],
                       torch.zeros_like(u))


def rand_thresholds_for(key: torch.Tensor, steps: torch.Tensor,
                        extra_seed: int, num_bins: torch.Tensor,
                        nan_bins: torch.Tensor) -> torch.Tensor:
    """extra_trees: one random valid numeric threshold per feature and
    step, ``[S, F]`` int32 (the JAX package's ``rand_thresholds_for``); a
    trailing missing bin removes the last real threshold, as in the split
    search's ``valid_t``."""
    k = fold_in(fold_in(fold_in(key, 7919), steps), extra_seed)
    nb = num_bins.long()
    hi = torch.clamp(nb - 2 - (nan_bins.long() == nb - 1).long(), min=0)
    u = uniform(k, nb.shape[0]).to(nb.device)                      # [S, F]
    return torch.floor(u * (hi + 1).to(torch.float32)[None, :]).to(
        torch.int32)


def monotone_gain_mult(depth: torch.Tensor, monotone: torch.Tensor,
                       pen: float) -> torch.Tensor:
    """``[S, F]`` monotone split penalty factors at leaves of ``depth
    [S]`` (the JAX package's ``monotone_gain_mult``, reference
    ``ComputeMonotoneSplitGainPenalty``, monotone_constraints.hpp:355)."""
    d = depth.to(torch.float32)[:, None]
    inner = (1.0 - pen / torch.exp2(d) if pen <= 1.0
             else 1.0 - torch.exp2(pen - 1.0 - d))
    factor = torch.where(pen >= d + 1.0, torch.full_like(d, 1e-15),
                         inner + 1e-15)
    return torch.where(monotone[None, :] != 0, factor,
                       torch.ones_like(factor))


def _reduce_split_global(s: SplitResult, mesh) -> SplitResult:
    """Every rank's best split of each leaf of a batch joined into the
    global one (the JAX package's ``_reduce_split_global``, reference
    ``SyncUpGlobalBestSplit``, parallel_tree_learner.h:191-214): one
    all-gather of each rank's packed record ``[S, 12 + CW]`` float64 (which
    holds every float32 and int32 field exactly, bitset words included);
    the largest gain wins, the lowest rank on a tie, and every rank reads
    the identical winner."""
    S = s.gain.shape[0]
    fields = [getattr(s, name).reshape(S) for name in _SPLIT_FIELDS]
    rec = torch.cat([torch.stack([x.double() for x in fields], 1),
                     s.cat_bits.reshape(S, -1).double()], 1)
    every = mesh.all_gather(rec)                          # [W, S, 12 + CW]
    winner = torch.argmax(every[:, :, 0], dim=0)          # first max
    pick = every[winner, torch.arange(S, device=rec.device)]
    out = {name: pick[:, i].to(x.dtype)
           for i, (name, x) in enumerate(zip(_SPLIT_FIELDS, fields))}
    out["cat_bits"] = pick[:, len(_SPLIT_FIELDS):].to(torch.int32)
    return SplitResult(**out)


def kernel_width(cfg: GrowerConfig) -> int:
    """The histogram kernels' bin width: the widest EFB bundle, else the
    widest feature."""
    return cfg.bundle_bins or cfg.max_bin


def _frontier_eligible(cfg: GrowerConfig, n_cols: int, interaction_sets=None,
                       cegb_coupled=None, cegb_lazy=None,
                       forced=(), efb=None) -> bool:
    """True when the round-batched frontier grower (ops/frontier.py) can
    serve this call (the JAX package's gate, with its arguments).
    Cross-leaf-coupled features (monotone intermediate and advanced
    bounds, CEGB refunds, interaction branch masks, forced-split prefixes)
    depend on the sequential split order and take the one-split loop; the
    per-node RNG features (feature_fraction_bynode, extra_trees) and
    monotone-basic are served by the frontier, as are the parallel
    learners (EFB bundles with the data learner only).  Its per-leaf one-hot
    kernel needs whole 128-row chunks in a block (``frontier_block_rows``
    a multiple of 128).  ``tree_grower=frontier`` with a feature the
    frontier cannot serve logs the JAX package's warning."""
    if cfg.grower_mode == "serial":
        return False
    mode = cfg.parallel_mode
    ok = ((not cfg.has_monotone or cfg.monotone_mode == "basic")
          and interaction_sets is None
          and cegb_coupled is None and cegb_lazy is None
          and not forced
          and cfg.cegb_split_penalty == 0.0
          and n_cols >= 0
          and mode in (None, "data", "feature", "voting")
          and (efb is None or mode in (None, "data"))
          and (cfg.hist_method != "onehot"
               or cfg.frontier_block_rows % _OH_CHUNK == 0))
    if not ok and cfg.grower_mode == "frontier":
        Log.warning("tree_grower=frontier is not compatible with the "
                    "requested features; using the serial grower")
    return ok


def grow_tree(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              row_weight: torch.Tensor, feature_mask: torch.Tensor,
              num_bins: torch.Tensor, nan_bins: torch.Tensor,
              cfg: GrowerConfig, key: Optional[torch.Tensor] = None,
              monotone: Optional[torch.Tensor] = None,
              is_categorical: Optional[torch.Tensor] = None,
              efb=None, interaction_sets: Optional[torch.Tensor] = None,
              cegb_coupled: Optional[torch.Tensor] = None,
              cegb_lazy: Optional[torch.Tensor] = None,
              cegb_used_data: Optional[torch.Tensor] = None,
              forced: Tuple[Tuple[int, int, int, int], ...] = (),
              feature_contri: Optional[torch.Tensor] = None,
              ) -> Tuple[TreeArrays, torch.Tensor, "object"]:
    """Grow one tree.  Returns ``(tree, node_assignment[num_data],
    host_tree)``, where ``host_tree`` is the same tree as numpy arrays
    (both growers finish each tree on the host, so the copy is free).
    ``key`` (``[2]``, ``random_gen.key_for_iteration``) seeds the per-node
    draws of ``feature_fraction_bynode`` and ``extra_trees``; ``monotone
    [F]`` gives the directions when ``cfg.has_monotone``;
    ``is_categorical [F]`` marks the categorical features (None: none);
    ``efb`` is the EFB layout when ``bins`` holds bundle columns.  The
    feature-gating state is the JAX package's (``grow_tree_serial``);
    ``feature_contri [F]`` scales each feature's gains in both growers."""
    if _frontier_eligible(cfg, bins.shape[1], interaction_sets,
                          cegb_coupled, cegb_lazy, forced, efb):
        from .frontier import grow_tree_frontier
        return grow_tree_frontier(bins, grad, hess, row_weight, feature_mask,
                                  num_bins, nan_bins, cfg, key=key,
                                  monotone=monotone,
                                  is_categorical=is_categorical, efb=efb,
                                  feature_contri=feature_contri)
    return grow_tree_serial(bins, grad, hess, row_weight, feature_mask,
                            num_bins, nan_bins, cfg, key=key,
                            monotone=monotone, is_categorical=is_categorical,
                            efb=efb, interaction_sets=interaction_sets,
                            cegb_coupled=cegb_coupled, cegb_lazy=cegb_lazy,
                            cegb_used_data=cegb_used_data, forced=forced,
                            feature_contri=feature_contri)


def _rect_comparability(rect_lo, rect_hi, c_lo_row, c_hi_row, mono_f):
    """Monotone comparability masks ``(upper, lower)`` ``[L, F]`` of every
    leaf rectangle against one child rectangle (the JAX package's
    ``_rect_comparability``, numpy int32): two leaves are comparable along
    monotone dim k when their rects overlap in every other dim and are
    strictly ordered along k; ``upper[m, k]``: leaf m sits on the child's
    greater side along k (so ``out_child <= out_m``), ``lower`` mirrored."""
    ovl_d = (rect_lo <= c_hi_row[None, :]) & (rect_hi >= c_lo_row[None, :])
    miss_cnt = np.sum(~ovl_d, axis=1)
    ovl_exc = ((miss_cnt == 0)[:, None]
               | ((miss_cnt == 1)[:, None] & ~ovl_d))
    m_right = rect_lo > c_hi_row[None, :]
    m_left = rect_hi < c_lo_row[None, :]
    upper = ovl_exc & (((mono_f > 0)[None, :] & m_right)
                       | ((mono_f < 0)[None, :] & m_left))
    lower = ovl_exc & (((mono_f > 0)[None, :] & m_left)
                       | ((mono_f < 0)[None, :] & m_right))
    return upper, lower


# the scalar fields of a SplitResult, in the order _fetch_splits packs them
_SPLIT_FIELDS = ("gain", "feature", "threshold", "default_left", "left_sum_g",
                 "left_sum_h", "left_count", "right_sum_g", "right_sum_h",
                 "right_count", "left_output", "right_output")


def _fetch_splits(s: SplitResult, *extra: torch.Tensor):
    """One device->host copy of an ``[S]``-batched ``SplitResult`` and of
    ``extra`` tensors: ``(fields [12, S] float64, cat_bits [S, CW] int32,
    [extra as float64 numpy])``.  float64 holds every float32 and int32
    value exactly."""
    S = s.gain.shape[0]
    cw = s.cat_bits.shape[-1]
    parts = ([getattr(s, name).reshape(S).double() for name in _SPLIT_FIELDS]
             + [s.cat_bits.reshape(-1).double()]
             + [e.reshape(-1).double() for e in extra])
    flat = torch.cat(parts).cpu().numpy()
    fields = flat[:12 * S].reshape(12, S)
    bits = flat[12 * S:12 * S + S * cw].reshape(S, cw).astype(np.int32)
    out, at = [], 12 * S + S * cw
    for e in extra:
        out.append(flat[at:at + e.numel()])
        at += e.numel()
    return fields, bits, out


class _HostBest:
    """Per-leaf pending best split on the host (numpy; the JAX package's
    ``_BestSplits`` SoA, float32 sums as the device computed them)."""

    def __init__(self, n: int, cw: int):
        self.gain = np.full(n, NEG_INF, np.float32)
        self.feature = np.zeros(n, np.int64)
        self.threshold = np.zeros(n, np.int64)
        self.default_left = np.zeros(n, bool)
        self.sums = np.zeros((n, 8), np.float32)  # lg lh lc rg rh rc lout rout
        self.cat_bits = np.zeros((n, cw), np.int32)

    def set(self, i: int, fields: np.ndarray, bits: np.ndarray) -> None:
        """Slot ``i`` from one column of ``_fetch_splits``' fields."""
        self.gain[i] = fields[0]
        self.feature[i] = int(fields[1])
        self.threshold[i] = int(fields[2])
        self.default_left[i] = bool(fields[3])
        self.sums[i] = fields[4:12]
        self.cat_bits[i] = bits


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


class _FeatureBlock(NamedTuple):
    """This rank's features ``[start, start + width)`` in a sharded split
    search (the feature learner's columns, the data learner's
    reduce-scattered block)."""
    start: int
    width: int

    def take(self, a, fill=0):
        """The block of ``a``'s last axis (None stays None), padded past
        its end with ``fill``."""
        if a is None:
            return None
        need = self.start + self.width - a.shape[-1]
        if need > 0:
            a = torch.cat([a, torch.full(a.shape[:-1] + (need,), fill,
                                         dtype=a.dtype, device=a.device)], -1)
        return a[..., self.start:self.start + self.width]


class _SearchMeta(NamedTuple):
    """The feature metadata a split search reads."""
    num_bins: torch.Tensor
    nan_bins: torch.Tensor
    is_categorical: Optional[torch.Tensor]
    monotone: Optional[torch.Tensor]
    contri: Optional[torch.Tensor]
    sorted_cat: Optional[torch.Tensor]


def _search_meta(block, num_bins, nan_bins, is_categorical, monotone,
                 contri, sorted_cat) -> _SearchMeta:
    """The metadata of a search over ``block`` (all features for None);
    pad features past the last have one bin, so no threshold."""
    if block is None:
        return _SearchMeta(num_bins, nan_bins, is_categorical, monotone,
                           contri, sorted_cat)
    sc = None
    if sorted_cat is not None:
        inside = ((sorted_cat >= block.start)
                  & (sorted_cat < block.start + block.width))
        sc = sorted_cat[inside] - block.start
        sc = sc if sc.numel() else None
    return _SearchMeta(block.take(num_bins, 1), block.take(nan_bins, -1),
                       block.take(is_categorical, False),
                       block.take(monotone, 0), block.take(contri, 1.0), sc)


def _pad_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    """``a`` with zero (False) rows appended to ``rows`` along the leading
    axis."""
    if a.shape[0] >= rows:
        return a
    return torch.cat([a, a.new_zeros((rows - a.shape[0],)
                                     + tuple(a.shape[1:]))])


def _find_mode(cfg: GrowerConfig, srch: _SearchMeta, block, hist, num_bins,
               nan_bins, sums, fmask, lo, hi, monotone, rand, mult,
               is_categorical, sorted_cat, contri, pen) -> SplitResult:
    """The learner's batched split search over ``hist [S, *, B, 3]`` with
    global totals ``sums [3, S]`` (the JAX package's mode-dispatched
    ``find``; the reference's per-learner FindBestSplitsFromHistograms):
    serial and data without a block search every feature; a sharded
    search (``block``) searches this rank's features and joins the
    ranks' winners (``_reduce_split_global``); voting elects the features
    whose global histograms it searches (``split.voting_elect``).  The
    masks ``fmask``, ``mult`` and ``pen`` and the metadata span every
    feature; ``rand`` is already the block's."""
    p = cfg.split
    if block is not None:
        s = find_best_split(
            hist, srch.num_bins, srch.nan_bins, sums[0], sums[1], sums[2], p,
            block.take(fmask), output_lo=lo, output_hi=hi,
            monotone=srch.monotone if monotone is not None else None,
            rand_threshold=rand, gain_mult=block.take(mult),
            is_categorical=srch.is_categorical, sorted_cat=srch.sorted_cat,
            contri=srch.contri, gain_penalty=block.take(pen))
        return _reduce_split_global(
            s._replace(feature=s.feature + block.start), cfg.mesh)
    if cfg.parallel_mode == "voting":
        hist, fmask = voting_elect(
            hist, num_bins, nan_bins, sums[0], sums[1], sums[2], p, fmask,
            cfg.mesh, cfg.top_k, cfg.num_shards, lo, hi, monotone=monotone,
            gain_mult=mult, is_categorical=is_categorical,
            sorted_cat=sorted_cat, contri=contri)
    return find_best_split(
        hist, num_bins, nan_bins, sums[0], sums[1], sums[2], p, fmask,
        output_lo=lo, output_hi=hi, monotone=monotone, rand_threshold=rand,
        gain_mult=mult, is_categorical=is_categorical, sorted_cat=sorted_cat,
        contri=contri, gain_penalty=pen)


def _forced_column(mode, mesh, block, h_leaf, feat: int) -> torch.Tensor:
    """Feature ``feat``'s ``[B, 3]`` histogram of a leaf for a forced
    split, from this rank's ``h_leaf [*, B, 3]``: summed over the ranks
    under voting (each stores its rows' histograms), the owner's under
    the feature learner (the others' zeros; the owner's split is
    broadcast)."""
    if mode == "feature":
        if feat // block.width == mesh.rank:
            return h_leaf[feat - block.start]
        return torch.zeros_like(h_leaf[0])
    if mode == "voting":
        return mesh.all_reduce(h_leaf[feat])
    return h_leaf[feat]


def grow_tree_serial(bins, grad, hess, row_weight, feature_mask, num_bins,
                     nan_bins, cfg: GrowerConfig, key=None, monotone=None,
                     is_categorical=None, efb=None, interaction_sets=None,
                     cegb_coupled=None, cegb_lazy=None, cegb_used_data=None,
                     forced=(), feature_contri=None):
    """Grow one tree one split at a time (the JAX package's sequential
    ``grow_tree``, reference ``SerialTreeLearner::Train``): best-first, the
    leaf of the largest pending gain splits next (lowest leaf id on a
    tie); the left child keeps the parent's leaf id and the right child of
    the j-th split is leaf j + 1.

    The rows live in a permutation ``perm`` in which each leaf owns a
    segment ``[begin, begin + rows)`` (the reference's ``DataPartition``).
    A split gathers its parent's segment once (bins and the packed
    grad/hess/weight bytes), decides each row's side, stable-partitions
    the segment, and histograms the smaller child by ``build_histogram``
    (the ``hist_full`` kernel, or ``onehot_full`` under ``force_row_wise``)
    over the gathered block with the side as mask; the larger child is
    the parent less it.  Both children's split searches run in one
    ``[2]``-batched ``find_best_split``.  The per-leaf bookkeeping is host
    numpy in float32 (the JAX package's ``lax`` state); each split reads
    the children's searches and the left row count back in one copy.

    Feature-gating state, as in the JAX package:
      interaction_sets: ``[C, F]`` 0/1, one row per interaction-constraint
        group; a leaf may only split on features of a group holding all of
        its branch features.
      cegb_coupled: ``[F]`` tradeoff x coupled penalty, zero for features
        earlier trees used; cegb_lazy: ``[F]`` tradeoff x lazy penalty;
        cegb_used_data: ``[N, F]`` bool, the rows x features earlier trees
        paid for (copied: this tree's payments stay local).
      forced: BFS-ordered forced splits ``(side, inner_feature,
        threshold_bin, parent_forced_idx)``; a forced split that fails its
        gain gate is skipped without shifting later ones, and one whose
        forced parent failed is dropped.
      feature_contri: ``[F]`` gain multipliers.
    Returns ``(TreeArrays on the bins' device, node_assignment [N] int64,
    TreeArrays of numpy arrays)``."""
    from .frontier import _efb_tables, _single_leaf
    dev = bins.device
    n, n_cols = bins.shape
    f = int(efb[0].shape[0]) if efb is not None else n_cols
    L = cfg.num_leaves
    B = cfg.max_bin
    Bb = kernel_width(cfg)
    cw = cat_words(B)
    p = cfg.split
    # the masks and the metadata span every feature (f_full); under the
    # feature learner the bins hold this rank's block of them
    f_full = feature_mask.shape[0]
    mode, mesh = cfg.parallel_mode, cfg.mesh
    if efb is not None and mode in ("feature", "voting"):
        raise NotImplementedError(
            "EFB is not supported with feature/voting parallel learners")
    tot = torch.stack([torch.sum(grad * row_weight),
                       torch.sum(hess * row_weight), torch.sum(row_weight)])
    if mode in ("data", "voting"):
        # the root's sums are global (reference Allreduce,
        # data_parallel_tree_learner.cpp:126-152); the feature learner
        # replicates rows
        tot = mesh.all_reduce(tot)
    if f == 0:
        return _single_leaf(tot, n, L, cw, dev)
    expand_hist, decode_col, _ = _efb_tables(efb, B, Bb, dev)
    sorted_cat = (torch.as_tensor(cfg.sorted_cat, dtype=torch.int64).to(dev)
                  if cfg.sorted_cat else None)
    nan_np = nan_bins.cpu().numpy().astype(np.int64)
    is_cat_np = (is_categorical.cpu().numpy().astype(bool)
                 if is_categorical is not None else np.zeros(f_full, bool))
    mono_np = (monotone.cpu().numpy().astype(np.int32)
               if monotone is not None else np.zeros(f_full, np.int32))
    col_np = (efb[0].astype(np.int64) if efb is not None
              else np.arange(f, dtype=np.int64))

    # the data learner's comm shape (the JAX package's dp_scatter, reference
    # ReduceScatter + SyncUpGlobalBestSplit, data_parallel_tree_learner.cpp:
    # 155-251): each histogram is reduce-scattered to this rank's block of
    # ceil(F / W) features, which it stores and searches.  EFB, forced
    # splits and CEGB-lazy need the full width and take a full all-reduce.
    dp_scatter = (mode == "data" and efb is None and not forced
                  and cegb_lazy is None and cfg.num_shards > 1)
    if dp_scatter:
        shard_w = -(-f // cfg.num_shards)
        block = _FeatureBlock(mesh.rank * shard_w, shard_w)
    elif mode == "feature":
        block = _FeatureBlock(mesh.rank * n_cols, n_cols)
    else:
        block = None
    srch = _search_meta(block, num_bins, nan_bins, is_categorical, monotone,
                        feature_contri, sorted_cat)

    def reduce_hist(h):
        """Join the ranks' ``[n_cols, Bb, 3]`` histograms: reduce-scatter to
        this rank's block (dp_scatter) or sum; only the data learner."""
        if mode != "data":
            return h
        if dp_scatter:
            return mesh.reduce_scatter(_pad_rows(h, block.width
                                                 * cfg.num_shards))
        return mesh.all_reduce(h)

    # combined row payload, as in the frontier: (grad, hess, row_weight)
    # as 12 trailing bytes in bin-typed columns, so one row gather moves a
    # segment's bins and gradients together
    bins_mv = movable_bins(bins)
    gh_packed = torch.stack([grad, hess, row_weight], 1).contiguous().view(
        bins_mv.dtype)
    comb = torch.cat([bins_mv, gh_packed], dim=1)

    use_mono = cfg.has_monotone
    use_pen = use_mono and cfg.monotone_penalty > 0.0
    mono_inter = use_mono and cfg.monotone_mode in ("intermediate",
                                                    "advanced")
    mono_adv = use_mono and cfg.monotone_mode == "advanced"
    use_cegb = (cegb_coupled is not None or cegb_lazy is not None
                or cfg.cegb_split_penalty > 0.0)
    coupled_np = (cegb_coupled.cpu().numpy().astype(np.float32)
                  if cegb_coupled is not None else None)
    rw_pos = row_weight > 0
    used_data = None
    if cegb_lazy is not None:
        used_data = (cegb_used_data.clone() if cegb_used_data is not None
                     else torch.zeros(n, f_full, dtype=torch.bool,
                                      device=dev))
    inter_np = (interaction_sets.cpu().numpy().astype(np.float32)
                if interaction_sets is not None else None)

    # the per-node draws of every step a tree can name, drawn once a tree
    # on the key's device and gathered by step (as the frontier does)
    all_steps = torch.arange(L + 1)
    node_masks = (node_feature_mask_for(key, all_steps, feature_mask,
                                        cfg.feature_fraction_bynode)
                  if cfg.feature_fraction_bynode < 1.0 else None)
    node_thr = (rand_thresholds_for(key, all_steps, cfg.extra_seed,
                                    srch.num_bins, srch.nan_bins)
                if cfg.extra_trees else None)

    def interaction_allowed(branch):
        """[F] 0/1: the union of the groups holding every branch feature
        (reference ``col_sampler.hpp:91`` GetByNode)."""
        ok_c = ~np.any((branch[None, :] > 0) & (inter_np <= 0), axis=1)
        return np.any((inter_np > 0) & ok_c[:, None], axis=0).astype(
            np.float32)

    def fmask_of(step, branch):
        m = node_masks[step] if node_masks is not None else feature_mask
        if inter_np is not None:
            m = m * _f32(interaction_allowed(branch)).to(dev)
        return m

    def penalty(counts, unused, feat_used):
        """``[S, F]`` CEGB gain penalties (reference ``DetlaGain``,
        cost_effective_gradient_boosting.hpp:67-85): the split penalty
        times the leaf's count, the coupled penalty of features this model
        has not used, the lazy penalty times the leaf's rows that never
        paid for the feature (``unused [S, F]`` on the device)."""
        if not use_cegb:
            return None
        c = np.asarray(counts, np.float32)[:, None]
        base = np.broadcast_to(np.float32(cfg.cegb_split_penalty) * c,
                               (len(counts), f_full)).astype(np.float32)
        if coupled_np is not None:
            base = base + np.where(feat_used, np.float32(0.0),
                                   coupled_np)[None, :]
        pen = _f32(base).to(dev)
        if cegb_lazy is not None:
            pen = pen + cegb_lazy[None, :] * unused
        return pen

    def unused_of(rows, sides=None):
        """``[S, F]`` float32 counts of weighted rows that never paid a
        feature: over ``rows``, split by ``sides`` (left, right) when
        given."""
        free = (~used_data[rows] & rw_pos[rows][:, None]).float()
        if sides is None:
            return rank_sum(free.sum(0)[None])
        left = sides[:, None].float()
        return rank_sum(torch.stack([(free * left).sum(0),
                                     (free * (1 - left)).sum(0)]))

    def rank_sum(x):
        """Counts over this rank's rows summed over the row-sharded
        learners' ranks."""
        return mesh.all_reduce(x) if mode in ("data", "voting") else x

    def find(hist_b, sums, fmask, lo, hi, pen, steps, depths):
        """The ``[S]``-batched search: ``sums [3, S]`` host float32 totals,
        ``lo``/``hi`` host bounds, ``steps`` the per-node draws' keys,
        ``depths`` the leaves' depths for the monotone penalty."""
        st = torch.as_tensor(np.asarray(steps, np.int64))
        rand = node_thr[st] if node_thr is not None else None
        mult = (monotone_gain_mult(torch.as_tensor(np.asarray(depths)).to(dev),
                                   monotone, cfg.monotone_penalty)
                if use_pen else None)
        sums_d = _f32(sums).to(dev)
        return _find_mode(cfg, srch, block, expand_hist(hist_b), num_bins,
                          nan_bins, sums_d, fmask, _f32(lo).to(dev),
                          _f32(hi).to(dev), monotone if use_mono else None,
                          rand, mult, is_categorical, sorted_cat,
                          feature_contri, pen)

    trace = cfg.trace_device
    nvtx = trace and dev.type == "cuda"
    hist_of = (device_ranged("lgbm/hist", build_histogram, nvtx) if trace
               else build_histogram)
    if trace:
        find = device_ranged("lgbm/split_search", find, nvtx)

    # ---- root -------------------------------------------------------------
    root_hist = reduce_hist(hist_of(bins, grad, hess, row_weight, Bb,
                                    method=cfg.hist_method,
                                    variant=cfg.hist_variant))
    tot_h = tot.cpu().numpy().astype(np.float32)
    zero_branch = np.zeros(f_full, np.float32)
    fmask0 = fmask_of(0, zero_branch)[None]
    unused0 = (rank_sum(((~used_data) & rw_pos[:, None]).sum(
        0, dtype=torch.float32)[None]) if used_data is not None else None)
    pen0 = penalty([tot_h[2]], unused0, np.zeros(f_full, bool))
    fields, bits, _ = _fetch_splits(find(
        root_hist[None], tot_h[:, None], fmask0, [NEG_INF], [POS_INF], pen0,
        [0], [0]))

    best = _HostBest(L, cw)
    best.set(0, fields[:, 0], bits[0])
    # under dp_scatter each rank stores its block only: memory / W
    hist = torch.zeros((L,) + tuple(root_hist.shape), dtype=torch.float32,
                       device=dev)
    hist[0] = root_hist
    perm = torch.arange(n, dtype=torch.int64, device=dev)
    leaf_begin = np.zeros(L, np.int64)
    leaf_nrows = np.zeros(L, np.int64)
    leaf_nrows[0] = n
    leaf_depth = np.zeros(L, np.int64)
    leaf_value = np.zeros(L, np.float32)
    leaf_count = np.zeros(L, np.float32)
    leaf_weight = np.zeros(L, np.float32)
    leaf_sum_g = np.zeros(L, np.float32)
    leaf_sum_g[0], leaf_weight[0], leaf_count[0] = tot_h
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
    num_leaves = 1
    if mono_inter:
        rect_lo = np.zeros((L, f_full), np.int32)
        rect_hi = np.full((L, f_full), B - 1, np.int32)
        # the step whose draws a leaf's cached split was searched under:
        # the re-search re-keys with the same step
        leaf_step = np.zeros(L, np.int64)
    if mono_adv:
        leaf_out = np.zeros(L, np.float32)
        leaf_out[0] = _out(leaf_sum_g[0], leaf_weight[0], leaf_count[0], p)
    leaf_branch = (np.zeros((L, f_full), np.float32) if inter_np is not None
                   else None)
    feat_used = np.zeros(f_full, bool) if coupled_np is not None else None
    lid = np.arange(L)

    def forced_split_info(leaf, feat, thr):
        """SplitInfo of a forced (feature, threshold-bin) split of a leaf
        from its stored histogram (reference ``GatherInfoForThreshold``):
        the bin ``thr`` alone goes left for a categorical feature; for a
        numerical one the bins above ``thr`` but the missing bin go right
        (missing rows go left), summed as the reference does, so an empty
        side sums to exactly zero and its split gains nothing.  Gated on
        ``min_gain_to_split`` only.  (The JAX package sums the left side
        and takes the right as the rest, whose rounding residue can pass
        an empty side's split at a residue gain.)"""
        h = _forced_column(mode, mesh, block, expand_hist(hist[leaf][None])[0],
                           feat).cpu()                              # [B, 3]
        total = torch.as_tensor(np.array([leaf_sum_g[leaf], leaf_weight[leaf],
                                          leaf_count[leaf]], np.float32))
        bin_ids = torch.arange(B)
        f_cat = bool(is_cat_np[feat])
        if f_cat:
            left = h[thr]
            right = total - left
        else:
            sel = (bin_ids > thr) & (bin_ids != int(nan_np[feat]))
            right = torch.where(sel[:, None], h, torch.zeros(())).sum(0)
            left = total - right
        lo = torch.tensor(leaf_lo[leaf])
        hi = torch.tensor(leaf_hi[leaf])
        lout = leaf_output(left[0], left[1], p, 0.0, left[2], lo, hi)
        rout = leaf_output(right[0], right[1], p, 0.0, right[2], lo, hi)
        gain = (leaf_gain(left[0], left[1], p, 0.0, left[2], lo, hi)
                + leaf_gain(right[0], right[1], p, 0.0, right[2], lo, hi)
                - leaf_gain(total[0], total[1], p, 0.0, total[2], lo, hi))
        ok = bool(gain > p.min_gain_to_split)
        fields = np.array([float(gain) if ok else NEG_INF, feat, thr,
                           not f_cat, *left.tolist(), *right.tolist(),
                           float(lout), float(rout)], np.float64)
        bits = (pack_bin_bitset(torch.arange(B) == thr).numpy() if f_cat
                else np.zeros(cw, np.int32))
        fields = fields.astype(np.float32).astype(np.float64)
        if mode == "feature":
            # only the rank holding the feature's histogram knows the
            # split: it broadcasts it (the JAX package reduces it)
            rec = mesh.broadcast(torch.as_tensor(np.concatenate(
                [fields, bits.astype(np.float64)])).to(dev),
                feat // n_cols).cpu().numpy()
            fields, bits = rec[:12], rec[12:].astype(np.int32)
        return fields, bits

    def apply_split(j, leaf, gain):
        """Apply the pending best split of ``leaf`` as node ``j``."""
        nonlocal num_leaves
        feat = int(best.feature[leaf])
        thr = int(best.threshold[leaf])
        dleft = bool(best.default_left[leaf])
        cbits = best.cat_bits[leaf].copy()
        lg, lh, lc, rg, rh, rc, lout, rout = best.sums[leaf]
        f_is_cat = bool(is_cat_np[feat])
        new_id = num_leaves

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

        # ---- partition the parent's segment; histogram the smaller child
        if trace:
            part = DeviceRange("lgbm/partition", nvtx).open()
        left_smaller = bool(lc <= rc)
        b0, r0 = int(leaf_begin[leaf]), int(leaf_nrows[leaf])
        seg = perm[b0:b0 + r0].clone()     # perm's segment is rewritten
        combb = comb[seg]                                # [r0, NC + gh]
        ghb = combb[:, n_cols:].contiguous().view(torch.float32)  # [r0, 3]
        def goes_left(colv):
            if f_is_cat:
                return bitset_contains(torch.as_tensor(cbits).to(dev), colv)
            gl = colv <= thr
            if nan_np[feat] >= 0:
                gl = torch.where(colv == int(nan_np[feat]),
                                 torch.full_like(gl, dleft), gl)
            return gl

        if mode == "feature":
            # the column lives on one rank: it decides and broadcasts (the
            # rows, so the segment, are the same on every rank)
            owner = feat // n_cols
            if mesh.rank == owner:
                gl = goes_left(widen_bins(combb[:, feat - block.start]))
            else:
                gl = torch.zeros(r0, dtype=torch.bool, device=dev)
            gl = mesh.broadcast(gl.to(torch.uint8), owner).bool()
        else:
            gl = goes_left(decode_col(widen_bins(combb[:, int(col_np[feat])]),
                                      feat))
        gl64 = gl.long()
        nleft = gl64.sum()
        pos = torch.where(gl, torch.cumsum(gl64, 0) - 1,
                          nleft + torch.cumsum(1 - gl64, 0) - 1)
        new_seg = torch.empty_like(seg)
        new_seg[pos] = seg
        perm[b0:b0 + r0] = new_seg
        if trace:
            part.close()
        m = torch.where(gl == left_smaller, ghb[:, 2], 0.0)
        small_hist = reduce_hist(hist_of(
            combb.view(bins.dtype), ghb[:, 0].contiguous(),
            ghb[:, 1].contiguous(), m, Bb, f_limit=n_cols,
            method=cfg.hist_method, variant=cfg.hist_variant))
        parent_hist = hist[leaf]
        lhist = small_hist if left_smaller else parent_hist - small_hist
        rhist = parent_hist - lhist
        hist[leaf] = lhist
        hist[new_id] = rhist

        # ---- child bookkeeping -------------------------------------------
        depth = leaf_depth[leaf] + 1
        leaf_depth[leaf] = leaf_depth[new_id] = depth
        leaf_value[leaf], leaf_value[new_id] = lout, rout
        leaf_count[leaf], leaf_count[new_id] = lc, rc
        leaf_weight[leaf], leaf_weight[new_id] = lh, rh
        leaf_sum_g[leaf], leaf_sum_g[new_id] = lg, rg
        leaf_parent[leaf] = leaf_parent[new_id] = j
        leaf_is_left[leaf], leaf_is_left[new_id] = True, False

        mono = mono_np[feat]
        lo, hi = leaf_lo[leaf], leaf_hi[leaf]
        is_num = not f_is_cat
        if mono_inter:
            # intermediate: children bounded by the ACTUAL sibling outputs
            # (UpdateConstraintsWithOutputs, monotone_constraints.hpp:543)
            l_lo = max(lo, rout) if is_num and mono < 0 else lo
            l_hi = min(hi, rout) if is_num and mono > 0 else hi
            r_lo = max(lo, lout) if is_num and mono > 0 else lo
            r_hi = min(hi, lout) if is_num and mono < 0 else hi
        else:
            # basic: pinch both children at the midpoint of their outputs
            mid = (lout + rout) * np.float32(0.5)
            l_lo = max(lo, mid) if mono < 0 else lo
            l_hi = min(hi, mid) if mono > 0 else hi
            r_lo = max(lo, mid) if mono > 0 else lo
            r_hi = min(hi, mid) if mono < 0 else hi
        leaf_lo[leaf], leaf_lo[new_id] = l_lo, r_lo
        leaf_hi[leaf], leaf_hi[new_id] = l_hi, r_hi

        if mono_inter:
            # children rectangles: a numeric split cuts dimension feat at
            # thr; categorical children keep the parent's rectangle
            prl, prh = rect_lo[leaf].copy(), rect_hi[leaf].copy()
            fsel = (np.arange(f_full) == feat) & is_num
            l_rh = np.where(fsel, thr, prh).astype(np.int32)
            r_rl = np.where(fsel, thr + 1, prl).astype(np.int32)
            rect_lo[leaf], rect_lo[new_id] = prl, r_rl
            rect_hi[leaf], rect_hi[new_id] = l_rh, prh
            act = lid <= num_leaves              # old leaves + the new slot
            if mono_adv:
                # advanced: re-derive each child's bounds from the current
                # comparability over all active leaves (reference
                # AdvancedLeafConstraints precision)
                leaf_out[leaf], leaf_out[new_id] = lout, rout

                def derive(c_lo_row, c_hi_row, self_id):
                    upper, lower = _rect_comparability(
                        rect_lo, rect_hi, c_lo_row, c_hi_row, mono_np)
                    elig = (act & (lid != self_id))[:, None]
                    outs = leaf_out[:, None]
                    hi_c = np.min(np.where(upper & elig, outs,
                                           np.float32(POS_INF)))
                    lo_c = np.max(np.where(lower & elig, outs,
                                           np.float32(NEG_INF)))
                    return lo_c, hi_c

                leaf_lo[leaf], leaf_hi[leaf] = derive(prl, l_rh, leaf)
                leaf_lo[new_id], leaf_hi[new_id] = derive(r_rl, prh, new_id)

            # propagate the children's outputs to every active leaf
            # comparable with a child along some monotone dim
            # (GoUpToFindLeavesToUpdate)
            for c_lo_row, c_hi_row, out_c in ((prl, l_rh, lout),
                                              (r_rl, prh, rout)):
                upper, lower = _rect_comparability(
                    rect_lo, rect_hi, c_lo_row, c_hi_row, mono_np)
                up = act & upper.any(1)
                low = act & lower.any(1)
                leaf_lo[up] = np.maximum(leaf_lo[up], out_c)
                leaf_hi[low] = np.minimum(leaf_hi[low], out_c)

        # ---- feature-gating state: interaction branches, CEGB -----------
        branch = None
        if leaf_branch is not None:
            branch = leaf_branch[leaf].copy()
            branch[feat] = 1.0
            leaf_branch[leaf] = leaf_branch[new_id] = branch
        fmask = fmask_of(j + 1, branch)
        if feat_used is not None:
            # the coupled penalty is paid once per feature per model: refund
            # it in other leaves' cached gains that proposed the feature
            # (the JAX package's approximation of UpdateLeafBestSplits)
            refund = np.float32(0.0) if feat_used[feat] else coupled_np[feat]
            hit = (best.feature == feat) & (best.gain > NEG_INF / 2)
            best.gain[hit] = best.gain[hit] + refund
            feat_used[feat] = True
        unused2 = None
        if used_data is not None:
            # the split leaf's rows have now paid feature feat's lazy cost
            ud = used_data[seg]
            ud[:, feat] |= rw_pos[seg]
            used_data[seg] = ud
            unused2 = unused_of(seg, gl)

        # ---- both children's searches, under the FINAL bounds ------------
        depth_ok = cfg.max_depth <= 0 or depth < cfg.max_depth
        pen2 = penalty([lc, rc], unused2, feat_used)
        s2 = find(torch.stack([lhist, rhist]),
                  np.array([[lg, rg], [lh, rh], [lc, rc]], np.float32),
                  fmask[None].expand(2, f_full),
                  [leaf_lo[leaf], leaf_lo[new_id]],
                  [leaf_hi[leaf], leaf_hi[new_id]], pen2,
                  [j + 1, j + 1], [depth, depth])
        fields, bits, (nl_h,) = _fetch_splits(s2, nleft)
        if not depth_ok:
            fields[0] = NEG_INF
        best.set(leaf, fields[:, 0], bits[0])
        best.set(new_id, fields[:, 1], bits[1])
        if mono_inter:
            leaf_step[leaf] = leaf_step[new_id] = j + 1
        nl = int(nl_h[0])
        leaf_nrows[leaf] = nl
        leaf_begin[new_id] = b0 + nl
        leaf_nrows[new_id] = r0 - nl
        num_leaves += 1

    if trace:
        apply_split = device_ranged("lgbm/apply_split", apply_split, nvtx)

    # ---- forced splits first (BFS prefix; leaf ids resolved as they land)
    forced_ok, forced_leaf, forced_right = [], [], []
    for fside, ffeat, fthr, fpar in forced[:L - 1]:
        if fpar < 0:
            fleaf = 0
        elif fside == 0:         # the left child keeps the parent's leaf id
            fleaf = forced_leaf[fpar]
        else:                    # the right child took the fresh id
            fleaf = forced_right[fpar]
        forced_leaf.append(fleaf)
        forced_right.append(num_leaves)
        fields, fbits = forced_split_info(fleaf, ffeat, fthr)
        if fpar >= 0 and not forced_ok[fpar]:
            # a forced split whose forced ancestor failed is dropped
            # (serial_tree_learner.cpp:543-553)
            fields[0] = NEG_INF
        ok = fields[0] > 0.0
        if ok:
            # a failed forced split leaves the leaf's natural best split
            # in place for the best-gain phase (forceSplitMap erase)
            best.set(fleaf, fields, fbits)
            apply_split(num_leaves - 1, fleaf, np.float32(fields[0]))
        forced_ok.append(bool(ok))

    # ---- best-gain growth --------------------------------------------------
    jj = num_leaves - 1
    while jj < L - 1:
        active = np.where(lid < num_leaves, best.gain, np.float32(NEG_INF))
        leaf = int(np.argmax(active))
        if not active[leaf] > 0.0:
            break
        if not mono_inter:
            apply_split(jj, leaf, active[leaf])
            jj += 1
            continue
        # intermediate/advanced: the cached split may violate bounds
        # tightened since it was found -- re-search the leaf under its
        # current bounds with the gates its cached search had
        # (RecomputeBestSplitForLeaf analog); a leaf whose re-search finds
        # nothing is retired without taking a node slot
        step0 = int(leaf_step[leaf])
        fmask_j = fmask_of(step0, leaf_branch[leaf]
                           if leaf_branch is not None else None)
        unused_j = None
        if used_data is not None:
            b0, r0 = int(leaf_begin[leaf]), int(leaf_nrows[leaf])
            unused_j = unused_of(perm[b0:b0 + r0])
        pen_j = penalty([leaf_count[leaf]], unused_j, feat_used)
        fields, bits, _ = _fetch_splits(find(
            hist[leaf][None],
            np.array([[leaf_sum_g[leaf]], [leaf_weight[leaf]],
                      [leaf_count[leaf]]], np.float32),
            fmask_j[None], [leaf_lo[leaf]], [leaf_hi[leaf]], pen_j,
            [step0], [leaf_depth[leaf]]))
        if not (cfg.max_depth <= 0 or leaf_depth[leaf] < cfg.max_depth):
            fields[0] = NEG_INF
        best.set(leaf, fields[:, 0], bits[0])
        if best.gain[leaf] > 0.0:
            apply_split(jj, leaf, best.gain[leaf])
            jj += 1

    # ---- child pointers: leaves claim their creating node's side, then
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
    tree_np = TreeArrays(
        split_feature=node_feature, threshold=node_threshold,
        default_left=node_default_left, is_cat_split=node_is_cat,
        cat_bits=node_cat_bits, split_gain=node_gain,
        left_child=left_child, right_child=right_child,
        leaf_value=leaf_value, leaf_count=leaf_count,
        leaf_weight=leaf_weight, internal_value=node_value,
        internal_count=node_count,
        num_leaves=np.array(num_leaves, np.int32))
    tree = TreeArrays(*[torch.as_tensor(a).to(dev) for a in tree_np])

    # ---- node assignment: leaf l owns perm[begin_l : begin_l + rows_l]
    order = np.argsort(leaf_begin[:num_leaves], kind="stable")
    leaf_of_pos = torch.repeat_interleave(
        torch.as_tensor(order), torch.as_tensor(leaf_nrows[order])).to(dev)
    node_assign = torch.empty(n, dtype=torch.int64, device=dev)
    node_assign[perm] = leaf_of_pos
    return tree, node_assign, tree_np


def _out(sum_g, sum_h, count, p: SplitParams) -> np.float32:
    """A leaf's unbounded output, float32 on the host."""
    return np.float32(leaf_output(_f32(sum_g), _f32(sum_h), p, 0.0,
                                  _f32(count)))
