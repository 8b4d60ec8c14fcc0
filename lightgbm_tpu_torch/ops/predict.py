"""Device-side tree traversal over binned data.

Port of the JAX package's ``ops/predict.py``: the training/validation score
update.  Validation sets are binned with the training set's mappers, so the
bin-threshold comparison is exactly the reference's raw-value traversal
(``tree.h:133``), vectorized over all rows.  The JAX version loops while any
row is still at an internal node; here the caller may pass the tree's depth
(known on the host) so the loop runs a fixed number of steps and never reads
the device.
"""
from __future__ import annotations

from typing import Optional

import torch

from .grower import TreeArrays


def predict_leaf_binned(tree: TreeArrays, bins: torch.Tensor,
                        nan_bins: torch.Tensor,
                        depth: Optional[int] = None) -> torch.Tensor:
    """Leaf index (int64) per row of binned features ``bins [N, F]``."""
    n = bins.shape[0]
    dev = bins.device
    if depth == 0 or (depth is None and int(tree.num_leaves) <= 1):
        return torch.zeros(n, dtype=torch.int64, device=dev)
    sf = tree.split_feature.long()
    thr = tree.threshold.long()
    lch = tree.left_child.long()
    rch = tree.right_child.long()
    nanb = nan_bins.long()
    rows = torch.arange(n, device=dev)
    cur = torch.zeros(n, dtype=torch.int64, device=dev)
    step = 0
    while (step < depth) if depth is not None else bool((cur >= 0).any()):
        node = cur.clamp(min=0)
        feat = sf[node].clamp(min=0)
        col = bins[rows, feat].long()
        nb = nanb[feat]
        is_miss = (col == nb) & (nb >= 0)
        goes_left = torch.where(is_miss, tree.default_left[node],
                                col <= thr[node])
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
