"""Leaf-wise (best-first) tree growth: configuration, tree layout, routing.

Port of the parts of the JAX package's ``ops/grower.py`` that the frontier
grower needs: ``GrowerConfig``, ``TreeArrays``, ``_BestSplits``, the
per-node draws and penalty (``node_feature_mask_for``,
``rand_thresholds_for``, ``monotone_gain_mult``, batched over split steps)
and the ``_frontier_eligible`` gate.  ``grow_tree`` routes to the frontier
grower (``ops/frontier.py``); the sequential one-split-at-a-time grower is
not ported yet, so a configuration that would need it raises
``NotPortedError`` instead of falling back.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..device import NotPortedError
from ..utils.random_gen import fold_in, uniform
from .histogram import _OH_CHUNK, _SMEM_PER_BIN, SMEM_MAX_BYTES
from .split import NEG_INF, SplitParams, SplitResult


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


def kernel_width(cfg: GrowerConfig) -> int:
    """The histogram kernels' bin width: the widest EFB bundle, else the
    widest feature."""
    return cfg.bundle_bins or cfg.max_bin


def _frontier_eligible(cfg: GrowerConfig, n_cols: int) -> bool:
    """True when the round-batched frontier grower (ops/frontier.py) can
    serve this call.  Cross-leaf-coupled features (monotone intermediate
    and advanced bounds, CEGB) need the sequential grower, which is not
    ported; the per-node RNG features (feature_fraction_bynode,
    extra_trees) and monotone-basic are served by the frontier, as in the
    JAX package.

    The card's budget at the kernel width (``kernel_width``), by histogram
    method:

    - atomic: the kernels keep a privatised ``[features, B, 3]`` float64
      histogram of one feature group in shared memory and split wider
      feature sets over ``gridDim.y``, so any feature count fits as long as
      ONE feature does: ``24 * B`` bytes within the 227 KB a CTA may opt
      into (B <= 9,685; u16 bins and EFB bundles reach B = 4,096).
    - onehot: the kernels keep their sums in registers and stage 128 rows
      at a time, whose shared memory does not grow with the width, so any
      feature count and any u8 or u16 width fits (u16 through ``base``,
      ``i16cmp``, ``staged`` and ``int8``); the per-leaf kernel needs whole
      128-row chunks in a block (``frontier_block_rows`` a multiple of
      128, which the config already demands), and outside the JAX
      package's cut the per-leaf histograms take the atomic kernel
      (``histogram.onehot_leaves_fits``), so the atomic budget holds too."""
    if cfg.grower_mode == "serial":
        return False
    width = kernel_width(cfg)
    budget_ok = _SMEM_PER_BIN * width <= SMEM_MAX_BYTES
    if cfg.hist_method == "onehot":
        budget_ok = budget_ok and cfg.frontier_block_rows % _OH_CHUNK == 0
    return ((not cfg.has_monotone or cfg.monotone_mode == "basic")
            and cfg.cegb_split_penalty == 0.0
            and n_cols >= 0
            and budget_ok)


def grow_tree(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              row_weight: torch.Tensor, feature_mask: torch.Tensor,
              num_bins: torch.Tensor, nan_bins: torch.Tensor,
              cfg: GrowerConfig, key: Optional[torch.Tensor] = None,
              monotone: Optional[torch.Tensor] = None,
              is_categorical: Optional[torch.Tensor] = None,
              efb=None) -> Tuple[TreeArrays, torch.Tensor, "object"]:
    """Grow one tree.  Returns ``(tree, node_assignment[num_data],
    host_tree)``, where ``host_tree`` is the same tree as numpy arrays (the
    frontier finishes each tree on the host, so the copy is free).  ``key``
    (``[2]``, ``random_gen.key_for_iteration``) seeds the per-node draws of
    ``feature_fraction_bynode`` and ``extra_trees``; ``monotone [F]`` gives
    the directions when ``cfg.has_monotone``; ``is_categorical [F]`` marks
    the categorical features (None: none); ``efb`` is the EFB layout when
    ``bins`` holds bundle columns."""
    if not _frontier_eligible(cfg, bins.shape[1]):
        raise NotPortedError(
            "this configuration needs the sequential (serial) grower, which "
            "is not ported yet: tree_grower=serial, monotone intermediate "
            "and advanced, CEGB and a histogram width the card's kernels "
            "refuse all need it")
    from .frontier import grow_tree_frontier
    return grow_tree_frontier(bins, grad, hess, row_weight, feature_mask,
                              num_bins, nan_bins, cfg, key=key,
                              monotone=monotone,
                              is_categorical=is_categorical, efb=efb)
