"""Device-side tree traversal over binned data.

Port of the JAX package's ``ops/predict.py``: the training/validation score
update.  Validation sets are binned with the training set's mappers, so the
bin-threshold comparison is exactly the reference's raw-value traversal
(``tree.h:133``), vectorized over all rows; a categorical split sends a row
left when its bin is in the split's bin bitset, and on an EFB bundle matrix
a feature's bin is decoded from its bundle column first.  The JAX version
loops while any row is still at an internal node; here the caller may pass
the tree's depth (known on the host) so the loop runs a fixed number of
steps and never reads the device.
"""
from __future__ import annotations

from typing import Optional

import torch

from .grower import TreeArrays
from .histogram import movable_bins, widen_bins
from .split import bitset_contains


def predict_leaf_binned(tree: TreeArrays, bins: torch.Tensor,
                        nan_bins: torch.Tensor,
                        depth: Optional[int] = None, efb=None) -> torch.Tensor:
    """Leaf index (int64) per row of binned features ``bins [N, NC]`` (u8
    or u16).  ``efb``: the ``(feat_bundle, feat_off, num_bins)`` numpy
    arrays when ``bins`` is an EFB bundle matrix (``io/efb.py``)."""
    n = bins.shape[0]
    dev = bins.device
    if depth == 0 or (depth is None and int(tree.num_leaves) <= 1):
        return torch.zeros(n, dtype=torch.int64, device=dev)
    sf = tree.split_feature.long()
    thr = tree.threshold.long()
    lch = tree.left_child.long()
    rch = tree.right_child.long()
    nanb = nan_bins.long()
    has_cat = bool(tree.is_cat_split.any())
    if efb is not None:
        fb, fo, fnb = (torch.as_tensor(a.astype("int64")).to(dev)
                       for a in efb)
    bins_mv = movable_bins(bins)
    rows = torch.arange(n, device=dev)
    cur = torch.zeros(n, dtype=torch.int64, device=dev)
    step = 0
    while (step < depth) if depth is not None else bool((cur >= 0).any()):
        node = cur.clamp(min=0)
        feat = sf[node].clamp(min=0)
        col = widen_bins(bins_mv[rows, fb[feat] if efb is not None else feat])
        if efb is not None:
            off, nbf = fo[feat], fnb[feat]
            col = torch.where((col >= off) & (col < off + nbf - 1),
                              col - off + 1, torch.zeros_like(col))
        nb = nanb[feat]
        is_miss = (col == nb) & (nb >= 0)
        goes_left = torch.where(is_miss, tree.default_left[node],
                                col <= thr[node])
        if has_cat:
            # categorical: bin-bitset membership (one-hot and sorted)
            goes_left = torch.where(tree.is_cat_split[node],
                                    bitset_contains(tree.cat_bits, col,
                                                    node), goes_left)
        nxt = torch.where(goes_left, lch[node], rch[node])
        cur = torch.where(cur >= 0, nxt, cur)
        step += 1
    return ~cur


def tree_depth(left_child, right_child, num_leaves: int) -> int:
    """Depth (internal nodes on the longest root->leaf path) of a host tree
    in the ``~leaf`` child encoding."""
    if num_leaves <= 1:
        return 0
    depth, stack = 0, [(0, 1)]
    while stack:
        node, d = stack.pop()
        depth = max(depth, d)
        for c in (int(left_child[node]), int(right_child[node])):
            if c >= 0:
                stack.append((c, d + 1))
    return depth
