"""Leaf-wise linear model fitting for linear trees (``linear_tree=true``).

Port of the JAX package's ``ops/linear.py`` (reference
``LinearTreeLearner::CalculateLinear``,
``src/treelearner/linear_tree_learner.cpp:170-380``): per leaf, a ridge
regression of the Newton step on the raw values of the leaf's branch
features -- coefficients ``-(X^T H X + lambda I)^-1 X^T g`` -- with rows
that have NaN in any branch feature left out.  Plain PyTorch on the
model's device: every row adds its outer product to its own leaf's normal
equations (one ``index_add_`` for all leaves, summed in float64 as the
reference's double buffers do), and one batched ``torch.linalg.solve``
solves all leaves.
"""
from __future__ import annotations

import torch


def fit_leaf_linear(raw: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
                    node_assign: torch.Tensor, row_weight: torch.Tensor,
                    feat_mat: torch.Tensor, linear_lambda: float):
    """Fit per-leaf linear models.

    Args:
      raw: ``[n, F_total]`` float32 raw feature values (may hold NaN).
      grad, hess: ``[n]`` float32.
      node_assign: ``[n]`` leaf of each row.
      row_weight: ``[n]`` float32 (0 = bagged out).
      feat_mat: ``[L, K]`` int64 real-feature ids on each leaf's branch
        path, -1 padded.
      linear_lambda: ridge term on the feature dims, not the intercept
        (linear_tree_learner.cpp:343).

    Returns ``(coeffs [L, K] float64, consts [L] float64, ok [L] bool)``;
    ``ok`` is the reference's gate on non-NaN rows (at least the leaf's
    feature count + 1).
    """
    L, K = feat_mat.shape
    dev = raw.device
    leaf = node_assign.long()
    feats = feat_mat.long()[leaf]                               # [n, K]
    fvalid = feats >= 0
    xv = torch.gather(raw, 1, feats.clamp(min=0))               # [n, K]
    row_nan = (torch.isnan(xv) & fvalid).any(1)
    w = (row_weight > 0) & ~row_nan
    xa = torch.cat([torch.where(fvalid, torch.nan_to_num(xv), 0.0),
                    torch.ones_like(xv[:, :1])], 1).double()
    xa = xa * w[:, None]                                        # [n, K+1]
    xthx = torch.zeros(L, K + 1, K + 1, dtype=torch.float64, device=dev)
    xthx.index_add_(0, leaf, xa[:, :, None] * (xa * hess.double()[:, None])
                    [:, None, :])
    xtg = torch.zeros(L, K + 1, dtype=torch.float64, device=dev)
    xtg.index_add_(0, leaf, xa * grad.double()[:, None])
    lv = feat_mat >= 0                                           # [L, K]
    # ridge on the feature dims; a unit diagonal on padded dims keeps the
    # system regular (their rows are zero, so they solve to 0), and a tiny
    # jitter guards an exactly singular leaf, which ``ok`` gates
    diag = torch.cat([torch.where(lv, linear_lambda, 1.0).double(),
                      torch.zeros(L, 1, dtype=torch.float64, device=dev)], 1)
    eye = torch.eye(K + 1, dtype=torch.float64, device=dev)
    a = xthx + torch.diag_embed(diag) + 1e-10 * eye
    beta = -torch.linalg.solve(a, xtg[:, :, None])[..., 0]      # [L, K+1]
    nnz = torch.zeros(L, dtype=torch.int64, device=dev)
    nnz.index_add_(0, leaf, w.long())
    ok = nnz >= lv.sum(1) + 1
    return beta[:, :K], beta[:, K], ok


def linear_leaf_delta(raw: torch.Tensor, leaf: torch.Tensor,
                      coeffs: torch.Tensor, consts: torch.Tensor,
                      feat_mat: torch.Tensor,
                      fallback: torch.Tensor) -> torch.Tensor:
    """Per-row linear leaf output ``const[leaf] + sum(coef * x)`` in
    float32; rows with NaN in any of their leaf's features take
    ``fallback[leaf]``, the constant leaf value (reference
    ``PredictionFunLinear``, tree.cpp:127-136)."""
    leaf = leaf.long()
    feats = feat_mat.long()[leaf]                               # [n, K]
    fvalid = feats >= 0
    vals = torch.gather(raw, 1, feats.clamp(min=0))
    nan_found = (torch.isnan(vals) & fvalid).any(1)
    lin = consts[leaf] + torch.where(
        fvalid, coeffs[leaf] * torch.nan_to_num(vals),
        torch.zeros((), device=raw.device)).sum(1)
    return torch.where(nan_found, fallback[leaf], lin)
