"""Leaf-wise (best-first) tree growth: configuration, tree layout, routing.

Port of the parts of the JAX package's ``ops/grower.py`` that the frontier
grower needs: ``GrowerConfig``, ``TreeArrays``, ``_BestSplits`` and the
``_frontier_eligible`` gate.  ``grow_tree`` routes to the frontier grower
(``ops/frontier.py``); the sequential one-split-at-a-time grower is not
ported yet, so a configuration that would need it raises ``NotPortedError``
instead of falling back.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..device import NotPortedError
from .histogram import _SMEM_PER_BIN, SMEM_MAX_BYTES
from .split import NEG_INF, SplitParams, SplitResult


class GrowerConfig(NamedTuple):
    """Static grower parameters."""
    num_leaves: int
    max_depth: int            # <=0: unlimited
    max_bin: int              # histogram width B
    split: SplitParams
    feature_fraction_bynode: float = 1.0
    extra_trees: bool = False
    has_monotone: bool = False
    cegb_split_penalty: float = 0.0
    # 'auto' takes the frontier grower whenever the features allow (see
    # _frontier_eligible), 'serial' asks for the one-split loop, 'frontier'
    # asks for batching
    grower_mode: str = "auto"
    frontier_k: int = 16          # leaves expanded per round
    frontier_block_rows: int = 512  # rows per kernel block


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

    @classmethod
    def empty(cls, n: int, device) -> "_BestSplits":
        def z():
            return torch.zeros(n, dtype=torch.float32, device=device)
        return cls(gain=torch.full((n,), NEG_INF, dtype=torch.float32,
                                   device=device),
                   feature=torch.zeros(n, dtype=torch.int32, device=device),
                   threshold=torch.zeros(n, dtype=torch.int32, device=device),
                   default_left=torch.zeros(n, dtype=torch.bool, device=device),
                   lg=z(), lh=z(), lc=z(), rg=z(), rh=z(), rc=z(),
                   lout=z(), rout=z())

    def set_rows(self, idx: torch.Tensor, s: SplitResult) -> "_BestSplits":
        """Write the ``[m]``-batched ``s`` into slots ``idx`` (in place)."""
        pairs = ((self.gain, s.gain), (self.feature, s.feature),
                 (self.threshold, s.threshold),
                 (self.default_left, s.default_left),
                 (self.lg, s.left_sum_g), (self.lh, s.left_sum_h),
                 (self.lc, s.left_count), (self.rg, s.right_sum_g),
                 (self.rh, s.right_sum_h), (self.rc, s.right_count),
                 (self.lout, s.left_output), (self.rout, s.right_output))
        for arr, val in pairs:
            arr[idx] = val
        return self


def _frontier_eligible(cfg: GrowerConfig, n_cols: int) -> bool:
    """True when the round-batched frontier grower (ops/frontier.py) can
    serve this call.  Cross-leaf-coupled features (monotone bounds, CEGB)
    and the per-node RNG features (feature_fraction_bynode, extra_trees)
    are not ported.

    The card's budget: the histogram kernels keep a privatised
    ``[features, B, 3]`` float64 histogram of one feature group in shared
    memory and split wider feature sets over ``gridDim.y``, so any feature
    count fits as long as ONE feature does: ``24 * B`` bytes within the
    227 KB a CTA may opt into (B <= 9,685; u8 bins give B <= 256)."""
    if cfg.grower_mode == "serial":
        return False
    return (not cfg.has_monotone
            and cfg.cegb_split_penalty == 0.0
            and cfg.feature_fraction_bynode >= 1.0
            and not cfg.extra_trees
            and n_cols >= 0
            and _SMEM_PER_BIN * cfg.max_bin <= SMEM_MAX_BYTES)


def grow_tree(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              row_weight: torch.Tensor, feature_mask: torch.Tensor,
              num_bins: torch.Tensor, nan_bins: torch.Tensor,
              cfg: GrowerConfig) -> Tuple[TreeArrays, torch.Tensor, "object"]:
    """Grow one tree.  Returns ``(tree, node_assignment[num_data],
    host_tree)``, where ``host_tree`` is the same tree as numpy arrays (the
    frontier finishes each tree on the host, so the copy is free)."""
    if not _frontier_eligible(cfg, bins.shape[1]):
        raise NotPortedError(
            "this configuration needs the sequential (serial) grower, which "
            "is not ported yet: tree_grower=serial, monotone constraints, "
            "CEGB, feature_fraction_bynode < 1 and extra_trees all need it")
    from .frontier import grow_tree_frontier
    return grow_tree_frontier(bins, grad, hess, row_weight, feature_mask,
                              num_bins, nan_bins, cfg)
