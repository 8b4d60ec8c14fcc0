"""Device batched ensemble prediction over raw feature values.

Port of the JAX package's ``ops/ensemble.py`` for numerical trees: every
tree's flat arrays are stacked into ``[T, ...]`` tensors on the device, and
each tree runs a vectorized traversal for all rows at once (a fixed number
of steps, the tree's depth, known when the trees are stacked).

Exactness: raw inputs are compared in float32.  Each f64 node threshold
``t`` is rounded DOWN to the nearest f32, so for any f32-representable
input ``x``: ``x <= t  <=>  f32(x) <= t32`` — the device decision matches
the host f64 decision exactly for f32 data.  Categorical and linear trees
are not ported (``NotPortedError``).
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..device import NotPortedError
from ..utils.common import K_ZERO_THRESHOLD
from .predict import tree_depth

_MT_NONE, _MT_ZERO, _MT_NAN = 0, 1, 2


class EnsembleArrays(NamedTuple):
    """Stacked flat trees (device layout of ``List[Tree]``)."""
    split_feature: torch.Tensor    # [T, M] int64 real feature ids
    threshold: torch.Tensor        # [T, M] f32 (f32-down-rounded reals)
    default_left: torch.Tensor     # [T, M] bool
    missing_type: torch.Tensor     # [T, M] int64
    left_child: torch.Tensor       # [T, M] int64 (~leaf encoding)
    right_child: torch.Tensor      # [T, M] int64
    leaf_value: torch.Tensor       # [T, L] f32
    has_split: List[bool]          # [T] host
    depth: List[int]               # [T] host: traversal steps per tree


def _f32_down(t: np.ndarray) -> np.ndarray:
    """Largest f32 <= t (so f32 compares reproduce the f64 decision)."""
    t32 = t.astype(np.float32)
    up = t32.astype(np.float64) > t
    return np.where(up, np.nextafter(t32, np.float32(-np.inf)), t32)


def stack_trees(models: List, device) -> EnsembleArrays:
    """Stack host ``Tree`` objects into device tensors (pad to max sizes)."""
    T = len(models)
    M = max(1, max(t.num_internal for t in models))
    L = max(1, max(t.num_leaves for t in models))
    sf = np.zeros((T, M), np.int64)
    th = np.zeros((T, M), np.float32)
    dl = np.zeros((T, M), bool)
    mt = np.zeros((T, M), np.int64)
    lc = np.full((T, M), -1, np.int64)
    rc = np.full((T, M), -1, np.int64)
    lv = np.zeros((T, L), np.float32)
    hs, depth = [], []
    for ti, t in enumerate(models):
        if getattr(t, "is_linear", False):
            raise NotPortedError("linear-tree prediction is not ported yet")
        m = t.num_internal if t.num_leaves > 1 else 0
        hs.append(t.num_leaves > 1)
        depth.append(tree_depth(t.left_child, t.right_child, t.num_leaves))
        if m:
            sf[ti, :m] = t.split_feature[:m]
            lc[ti, :m] = t.left_child[:m]
            rc[ti, :m] = t.right_child[:m]
            for j in range(m):
                if t.is_categorical_split(j):
                    raise NotPortedError(
                        "categorical-split prediction is not ported yet")
                th[ti, j] = _f32_down(np.float64(t.threshold[j]))
                dl[ti, j] = t.default_left(j)
                mt[ti, j] = t.missing_type(j)
        nl = max(1, t.num_leaves)
        lv[ti, :nl] = t.leaf_value[:nl] if len(t.leaf_value) >= nl else 0.0

    def d(a):
        return torch.as_tensor(a).to(device)
    return EnsembleArrays(
        split_feature=d(sf), threshold=d(th), default_left=d(dl),
        missing_type=d(mt), left_child=d(lc), right_child=d(rc),
        leaf_value=d(lv), has_split=hs, depth=depth)


def predict_leaf_raw(ens: EnsembleArrays, X: torch.Tensor, ti: int) -> torch.Tensor:
    """Leaf index per row of raw-valued ``X [N, F]`` f32 for tree ``ti``."""
    n = X.shape[0]
    if not ens.has_split[ti]:
        return torch.zeros(n, dtype=torch.int64, device=X.device)
    sf, th = ens.split_feature[ti], ens.threshold[ti]
    dl, mt = ens.default_left[ti], ens.missing_type[ti]
    lch, rch = ens.left_child[ti], ens.right_child[ti]
    rows = torch.arange(n, device=X.device)
    cur = torch.zeros(n, dtype=torch.int64, device=X.device)
    for _ in range(ens.depth[ti]):
        node = cur.clamp(min=0)
        x = X[rows, sf[node]]
        is_nan = torch.isnan(x)
        x0 = torch.where(is_nan, torch.zeros_like(x), x)
        node_mt = mt[node]
        is_miss = torch.where(
            node_mt == _MT_ZERO,
            is_nan | (torch.abs(x) <= K_ZERO_THRESHOLD),
            (node_mt == _MT_NAN) & is_nan)
        goes_left = torch.where(is_miss, dl[node], x0 <= th[node])
        nxt = torch.where(goes_left, lch[node], rch[node])
        cur = torch.where(cur >= 0, nxt, cur)
    return ~cur


def predict_raw_ensemble(ens: EnsembleArrays, X: torch.Tensor,
                         num_class: int) -> torch.Tensor:
    """Summed raw scores ``[K, N]`` over all stacked trees (tree ``t``
    belongs to class ``t % K``), float32 with Kahan compensation like the
    JAX version."""
    T = ens.leaf_value.shape[0]
    K = num_class
    acc = torch.zeros(K, X.shape[0], dtype=torch.float32, device=X.device)
    comp = torch.zeros_like(acc)
    for ti in range(T):
        delta = ens.leaf_value[ti][predict_leaf_raw(ens, X, ti)]
        k = ti % K
        y = delta - comp[k]
        t = acc[k] + y
        comp[k] = (t - acc[k]) - y
        acc[k] = t
    return acc
