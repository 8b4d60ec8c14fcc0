"""TreeSHAP feature contributions (a copy of the JAX package's
``ops/shap.py``, numpy only).

Analog of the reference ``Tree::TreeSHAP`` (``src/io/tree.cpp:887``, per-row
recursive path algorithm from Lundberg et al.).  Re-designed for batch
execution: the DFS visit order and the feature layout of the "unique path"
are row-independent — only the hot/cold choice at each internal node varies
per row — so the path state carries a leading row axis and every row is
processed in one numpy pass per tree node (``[n, depth+1]`` path arrays
instead of the reference's per-row recursion).

Output convention matches ``PredictContrib`` (``c_api.cpp`` predict with
``pred_contrib``): per-row ``[num_features + 1]`` where the last column is
the expected value (bias) of the ensemble.
"""
from __future__ import annotations

import numpy as np


def _extend(pz, po, pw, pfeat, depth, zero_frac, one_frac, feat):
    """ExtendPath (tree.cpp:823-840), vectorized over rows.

    pz/po/pw: [n, max_depth+2] path arrays (mutated in place);
    zero_frac: scalar; one_frac: [n] or scalar.
    """
    pz[:, depth] = zero_frac
    po[:, depth] = one_frac
    pw[:, depth] = 1.0 if depth == 0 else 0.0
    pfeat[depth] = feat
    for i in range(depth - 1, -1, -1):
        pw[:, i + 1] += po[:, depth] * pw[:, i] * (i + 1.0) / (depth + 1.0)
        pw[:, i] = pz[:, depth] * pw[:, i] * (depth - i) / (depth + 1.0)


def _unwind(pz, po, pw, pfeat, depth, path_index):
    """UnwindPath (tree.cpp:842-862), vectorized over rows."""
    one_frac = po[:, path_index].copy()
    zero_frac = pz[:, path_index].copy()
    next_one_portion = pw[:, depth].copy()
    for i in range(depth - 1, -1, -1):
        nonzero = one_frac != 0
        tmp = pw[:, i].copy()
        pw[:, i] = np.where(
            nonzero,
            np.divide(next_one_portion * (depth + 1.0), (i + 1.0) * one_frac,
                      out=np.zeros_like(next_one_portion),
                      where=nonzero),
            np.divide(tmp, zero_frac * (depth - i) / (depth + 1.0),
                      out=np.zeros_like(tmp),
                      where=(zero_frac * (depth - i)) != 0))
        next_one_portion = np.where(
            nonzero, tmp - pw[:, i] * zero_frac * (depth - i) / (depth + 1.0),
            next_one_portion)
    for i in range(path_index, depth):
        pz[:, i] = pz[:, i + 1]
        po[:, i] = po[:, i + 1]
        pfeat[i] = pfeat[i + 1]


def _unwound_sum(pz, po, pw, depth, path_index):
    """UnwoundPathSum (tree.cpp:864-884), vectorized over rows → [n]."""
    one_frac = po[:, path_index]
    zero_frac = pz[:, path_index]
    next_one_portion = pw[:, depth].copy()
    total = np.zeros(pz.shape[0])
    for i in range(depth - 1, -1, -1):
        nonzero = one_frac != 0
        tmp = np.divide(next_one_portion * (depth + 1.0), (i + 1.0) * one_frac,
                        out=np.zeros_like(next_one_portion), where=nonzero)
        with_one = tmp
        denom = zero_frac * (depth - i) / (depth + 1.0)
        with_zero = np.divide(pw[:, i], denom, out=np.zeros_like(total),
                              where=denom != 0)
        total += np.where(nonzero, with_one, with_zero)
        next_one_portion = np.where(
            nonzero, pw[:, i] - tmp * zero_frac * (depth - i) / (depth + 1.0),
            next_one_portion)
    return total


def tree_shap(tree, X: np.ndarray) -> np.ndarray:
    """SHAP values for one tree over a batch: returns ``[n, F]`` phi
    (feature contributions only; the caller adds the expected value)."""
    n, F = X.shape
    phi = np.zeros((n, F))
    if tree.num_leaves <= 1:
        return phi
    max_path = _max_depth(tree) + 2
    pz = np.zeros((n, max_path))
    po = np.zeros((n, max_path))
    pw = np.zeros((n, max_path))
    pfeat = np.full(max_path, -1, np.int64)

    # precompute per-node per-row decisions once
    goes_left = {}
    for node in range(tree.num_internal):
        goes_left[node] = tree._decide(node, X[:, tree.split_feature[node]])

    def counts(idx: int) -> float:
        if idx < 0:
            return float(tree.leaf_count[~idx])
        return float(tree.internal_count[idx])

    def visit(node, depth, zero_frac, one_frac, feat,
              pz, po, pw, pfeat):
        pz, po, pw, pfeat = pz.copy(), po.copy(), pw.copy(), pfeat.copy()
        _extend(pz, po, pw, pfeat, depth, zero_frac, one_frac, feat)
        if node < 0:                                     # leaf
            leaf_val = float(tree.leaf_value[~node])
            for i in range(1, depth + 1):
                w = _unwound_sum(pz, po, pw, depth, i)
                phi[:, pfeat[i]] += w * (po[:, i] - pz[:, i]) * leaf_val
            return
        f = int(tree.split_feature[node])
        left, right = int(tree.left_child[node]), int(tree.right_child[node])
        w = counts(node)
        left_zero = counts(left) / w
        right_zero = counts(right) / w
        gl = goes_left[node]

        incoming_zero = 1.0
        incoming_one = np.ones(n)
        path_index = 0
        while path_index <= depth:
            if pfeat[path_index] == f:
                break
            path_index += 1
        if path_index != depth + 1:
            incoming_zero = pz[:, path_index].copy()
            incoming_one = po[:, path_index].copy()
            _unwind(pz, po, pw, pfeat, depth, path_index)
            depth -= 1
        else:
            incoming_zero = np.ones(n)

        # left child: hot for rows going left, cold otherwise
        visit(left, depth + 1, left_zero * incoming_zero,
              np.where(gl, incoming_one, 0.0), f, pz, po, pw, pfeat)
        visit(right, depth + 1, right_zero * incoming_zero,
              np.where(gl, 0.0, incoming_one), f, pz, po, pw, pfeat)

    # zero_frac at root slot is unused in sums; mirror the reference's
    # initial call with fractions 1 and feature -1 (tree.cpp:147,226 callers)
    visit(0, 0, np.ones(n), np.ones(n), -1, pz, po, pw, pfeat)
    return phi


def expected_value(tree) -> float:
    """Reference ``Tree::ExpectedValue`` (tree.cpp:991)."""
    if tree.num_leaves == 1:
        return float(tree.leaf_value[0]) if len(tree.leaf_value) else 0.0
    total = float(tree.internal_count[0])
    if total <= 0:
        return 0.0
    return float(np.sum(tree.leaf_count[:tree.num_leaves] / total
                        * tree.leaf_value[:tree.num_leaves]))


def _max_depth(tree) -> int:
    depth = np.zeros(tree.num_internal, np.int64)
    md = 1
    for node in range(tree.num_internal):
        for child in (tree.left_child[node], tree.right_child[node]):
            if child >= 0:
                depth[child] = depth[node] + 1
                md = max(md, int(depth[child]) + 1)
            else:
                md = max(md, int(depth[node]) + 1)
    return md


__all__ = ["tree_shap", "expected_value"]
