"""Device batched ensemble prediction over raw feature values.

Port of the JAX package's ``ops/ensemble.py``: every tree's flat arrays are
stacked into ``[T, ...]`` tensors on the device, and each tree runs a
vectorized traversal for all rows at once (a fixed number of steps, the
tree's depth, known when the trees are stacked).  A categorical split sends
a row left when its value, as a non-negative integer category, is in the
split's value bitset (the reference ``Tree::CategoricalDecision``); the
bitsets of all trees are stacked into one word array.

Exactness: raw inputs are compared in float32.  Each f64 node threshold
``t`` is rounded DOWN to the nearest f32, so for any f32-representable
input ``x``: ``x <= t  <=>  f32(x) <= t32`` — the device decision matches
the host f64 decision exactly for f32 data.  A linear tree's leaf adds
``const + sum(coeff * x)`` over its leaf's features, or its constant leaf
value when one of them is NaN (reference ``PredictionFunLinear``).
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..utils.common import K_ZERO_THRESHOLD
from .predict import tree_depth

_MT_NONE, _MT_ZERO, _MT_NAN = 0, 1, 2


class EnsembleArrays(NamedTuple):
    """Stacked flat trees (device layout of ``List[Tree]``)."""
    split_feature: torch.Tensor    # [T, M] int64 real feature ids
    threshold: torch.Tensor        # [T, M] f32 (f32-down-rounded reals)
    is_cat: torch.Tensor           # [T, M] bool
    default_left: torch.Tensor     # [T, M] bool
    missing_type: torch.Tensor     # [T, M] int64
    left_child: torch.Tensor       # [T, M] int64 (~leaf encoding)
    right_child: torch.Tensor      # [T, M] int64
    leaf_value: torch.Tensor       # [T, L] f32
    # categorical bitsets, flattened across all trees
    cat_lo: torch.Tensor           # [T, M] int64 word offset into cat_words
    cat_nwords: torch.Tensor       # [T, M] int64
    cat_words: torch.Tensor        # [W] int64 (uint32 values)
    has_split: List[bool]          # [T] host
    depth: List[int]               # [T] host: traversal steps per tree
    # [T] host: whether a tree has a categorical split (read here, not
    # from is_cat on the device, so the traversal never syncs and a CUDA
    # graph can capture it)
    has_cat: List[bool]
    # linear trees (None when no tree of the stack is linear)
    leaf_const: torch.Tensor = None    # [T, L] f32
    leaf_coeff: torch.Tensor = None    # [T, L, K] f32
    leaf_feats: torch.Tensor = None    # [T, L, K] int64 (-1 = unused)


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
    ic = np.zeros((T, M), bool)
    clo = np.zeros((T, M), np.int64)
    cnw = np.zeros((T, M), np.int64)
    words: List[int] = []
    dl = np.zeros((T, M), bool)
    mt = np.zeros((T, M), np.int64)
    lc = np.full((T, M), -1, np.int64)
    rc = np.full((T, M), -1, np.int64)
    lv = np.zeros((T, L), np.float32)
    hs, depth, hc = [], [], []
    any_linear = any(getattr(t, "is_linear", False) for t in models)
    K = 1
    if any_linear:
        K = max([1] + [len(fs) for t in models if t.is_linear
                       for fs in t.leaf_features])
    const = np.zeros((T, L), np.float32)
    coeff = np.zeros((T, L, K), np.float32)
    feats = np.full((T, L, K), -1, np.int64)
    for ti, t in enumerate(models):
        m = t.num_internal if t.num_leaves > 1 else 0
        hs.append(t.num_leaves > 1)
        hc.append(False)
        depth.append(tree_depth(t.left_child, t.right_child, t.num_leaves))
        if m:
            sf[ti, :m] = t.split_feature[:m]
            lc[ti, :m] = t.left_child[:m]
            rc[ti, :m] = t.right_child[:m]
            for j in range(m):
                if t.is_categorical_split(j):
                    ic[ti, j] = True
                    hc[ti] = True
                    cidx = int(t.threshold[j])
                    lo, hi = t.cat_boundaries[cidx], t.cat_boundaries[cidx + 1]
                    clo[ti, j] = len(words)
                    cnw[ti, j] = hi - lo
                    words.extend(int(w) for w in t.cat_threshold[lo:hi])
                else:
                    th[ti, j] = _f32_down(np.float64(t.threshold[j]))
                    dl[ti, j] = t.default_left(j)
                    mt[ti, j] = t.missing_type(j)
        nl = max(1, t.num_leaves)
        lv[ti, :nl] = t.leaf_value[:nl] if len(t.leaf_value) >= nl else 0.0
        if any_linear and getattr(t, "is_linear", False):
            ncl = min(nl, len(t.leaf_const))
            const[ti, :ncl] = t.leaf_const[:ncl]
            for li in range(min(nl, len(t.leaf_features))):
                fs, cs = t.leaf_features[li], t.leaf_coeff[li]
                feats[ti, li, :len(fs)] = fs
                coeff[ti, li, :len(cs)] = cs
        elif any_linear:
            const[ti, :nl] = lv[ti, :nl]

    def d(a):
        return torch.as_tensor(a).to(device)
    return EnsembleArrays(
        split_feature=d(sf), threshold=d(th), is_cat=d(ic),
        default_left=d(dl), missing_type=d(mt), left_child=d(lc),
        right_child=d(rc), leaf_value=d(lv), cat_lo=d(clo),
        cat_nwords=d(cnw),
        cat_words=d(np.asarray(words or [0], np.int64) & 0xFFFFFFFF),
        has_split=hs, depth=depth, has_cat=hc,
        **(dict(leaf_const=d(const), leaf_coeff=d(coeff),
                leaf_feats=d(feats)) if any_linear else {}))


def predict_leaf_raw(ens: EnsembleArrays, X: torch.Tensor, ti: int) -> torch.Tensor:
    """Leaf index per row of raw-valued ``X [N, F]`` f32 for tree ``ti``."""
    n = X.shape[0]
    if not ens.has_split[ti]:
        return torch.zeros(n, dtype=torch.int64, device=X.device)
    sf, th = ens.split_feature[ti], ens.threshold[ti]
    dl, mt = ens.default_left[ti], ens.missing_type[ti]
    lch, rch = ens.left_child[ti], ens.right_child[ti]
    ic, clo, cnw = ens.is_cat[ti], ens.cat_lo[ti], ens.cat_nwords[ti]
    words = ens.cat_words
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
        if ens.has_cat[ti]:
            # categorical: the value's bit in the split's bitset
            iv = torch.where(torch.isfinite(x) & (x >= 0), x,
                             torch.full_like(x, -1.0)).to(torch.int64)
            wi = torch.div(iv, 32, rounding_mode="floor")
            in_range = (iv >= 0) & (wi < cnw[node])
            widx = torch.clamp(clo[node] + wi, 0, words.shape[0] - 1)
            bit = (words[widx] >> torch.remainder(iv, 32)) & 1
            goes_left = torch.where(ic[node], in_range & (bit == 1),
                                    goes_left)
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
        leaf = predict_leaf_raw(ens, X, ti)
        delta = ens.leaf_value[ti][leaf]
        if ens.leaf_const is not None:
            fs = ens.leaf_feats[ti][leaf]                    # [N, Kc]
            used = fs >= 0
            xv = torch.gather(X, 1, fs.clamp(min=0))
            nan_found = (used & torch.isnan(xv)).any(1)
            lin = ens.leaf_const[ti][leaf] + torch.where(
                used, torch.nan_to_num(xv) * ens.leaf_coeff[ti][leaf],
                torch.zeros((), device=X.device)).sum(1)
            delta = torch.where(nan_found, delta, lin)
        k = ti % K
        y = delta - comp[k]
        t = acc[k] + y
        comp[k] = (t - acc[k]) - y
        acc[k] = t
    return acc
