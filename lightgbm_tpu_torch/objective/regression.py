"""Regression objectives (reference ``src/objective/regression_objective.hpp``).

Port of the JAX package's ``objective/regression.py``: each class mirrors one
reference objective's gradient/hessian closed forms -- L2 ``:93``, L1
``:207``, Huber ``:293``, Fair ``:351``, Poisson ``:398``, Quantile ``:478``,
MAPE ``:576``, Gamma ``:677``, Tweedie ``:712`` -- as float32 torch ops in
the JAX order; boost-from-score and leaf renewal are numpy on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import ObjectiveFunction, _percentile_of, as_f32, from_f32
from ..utils.log import Log


def _weighted(grad, hess, weight):
    if weight is not None:
        grad, hess = grad * weight, hess * weight
    return grad, hess


def _renew_by_percentile(leaf_pred, resid, weight, leaf_values, num_leaves,
                         alpha):
    """Per-leaf (weighted) percentile of the residuals (RenewTreeOutput,
    regression_objective.hpp:254)."""
    out = leaf_values.copy()
    for leaf in range(num_leaves):
        rows = leaf_pred == leaf
        if rows.any():
            w = weight[rows] if weight is not None else None
            out[leaf] = _percentile_of(resid[rows].astype(np.float64), w,
                                       alpha)
    return out


class RegressionL2Loss(ObjectiveFunction):
    name = "regression"

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = config.reg_sqrt

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.sqrt and self.label is not None:
            self.trans_label = np.sign(self.label) * np.sqrt(np.abs(self.label))
        else:
            self.trans_label = self.label

    def get_gradients(self, score, label, weight):
        return _weighted(score - label, torch.ones_like(score), weight)

    def boost_from_score(self, class_id=0):
        lbl = self.trans_label
        if lbl is None:
            return 0.0
        if self.weight is not None:
            return float(np.sum(lbl * self.weight) / np.sum(self.weight))
        return float(np.mean(lbl))

    def convert_output(self, score):
        if self.sqrt:
            s, was_np = as_f32(score)
            return from_f32(torch.sign(s) * s * s, was_np)
        return score


class RegressionL1Loss(RegressionL2Loss):
    name = "regression_l1"

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = False

    def get_gradients(self, score, label, weight):
        return _weighted(torch.sign(score - label), torch.ones_like(score),
                         weight)

    def boost_from_score(self, class_id=0):
        if self.label is None:
            return 0.0
        return _percentile_of(self.label.astype(np.float64), self.weight, 0.5)

    def convert_output(self, score):
        return score

    def need_renew_tree_output(self):
        return True

    def renew_leaf_values(self, leaf_pred, score, leaf_values, num_leaves):
        # median of residuals per leaf
        return _renew_by_percentile(leaf_pred, self.label - score,
                                    self.weight, leaf_values, num_leaves, 0.5)


class HuberLoss(RegressionL2Loss):
    name = "huber"

    def __init__(self, config):
        super().__init__(config)
        self.alpha = config.alpha
        self.sqrt = False

    def get_gradients(self, score, label, weight):
        grad = torch.clamp(score - label, -self.alpha, self.alpha)
        return _weighted(grad, torch.ones_like(score), weight)


class FairLoss(RegressionL2Loss):
    name = "fair"

    def __init__(self, config):
        super().__init__(config)
        self.c = config.fair_c
        self.sqrt = False

    def get_gradients(self, score, label, weight):
        diff = score - label
        grad = self.c * diff / (torch.abs(diff) + self.c)
        hess = self.c * self.c / (torch.abs(diff) + self.c) ** 2
        return _weighted(grad, hess, weight)

    def boost_from_score(self, class_id=0):
        return 0.0


class PoissonLoss(RegressionL2Loss):
    name = "poisson"

    def __init__(self, config):
        super().__init__(config)
        self.max_delta_step = config.poisson_max_delta_step
        self.sqrt = False

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.label is not None and np.any(self.label < 0):
            Log.fatal("[poisson]: at least one target label is negative")

    def get_gradients(self, score, label, weight):
        grad = torch.exp(score) - label
        hess = torch.exp(score + self.max_delta_step)
        return _weighted(grad, hess, weight)

    def boost_from_score(self, class_id=0):
        mean = super().boost_from_score(class_id)
        return float(np.log(max(mean, 1e-20)))

    def convert_output(self, score):
        s, was_np = as_f32(score)
        return from_f32(torch.exp(s), was_np)


class QuantileLoss(RegressionL2Loss):
    name = "quantile"

    def __init__(self, config):
        super().__init__(config)
        self.alpha = config.alpha
        self.sqrt = False

    def get_gradients(self, score, label, weight):
        grad = torch.where(score - label >= 0,
                           torch.full_like(score, 1.0 - self.alpha),
                           torch.full_like(score, -self.alpha))
        return _weighted(grad, torch.ones_like(score), weight)

    def boost_from_score(self, class_id=0):
        if self.label is None:
            return 0.0
        return _percentile_of(self.label.astype(np.float64), self.weight,
                              self.alpha)

    def need_renew_tree_output(self):
        return True

    def renew_leaf_values(self, leaf_pred, score, leaf_values, num_leaves):
        return _renew_by_percentile(leaf_pred, self.label - score,
                                    self.weight, leaf_values, num_leaves,
                                    self.alpha)


class MAPELoss(RegressionL2Loss):
    name = "mape"

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = False
        self._lw_dev = {}

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        # per-row 1/|label| factors folded into weights (mape hpp:585)
        lbl = np.abs(self.label.astype(np.float64)) if self.label is not None else None
        base = self.weight if self.weight is not None else 1.0
        self.label_weight = (base / np.maximum(1.0, lbl)) if lbl is not None else None
        self._lw_dev = {}

    def get_gradients(self, score, label, weight):
        lw = self._lw_dev.get(score.device)
        if lw is None:
            lw = torch.as_tensor(self.label_weight).to(score.device,
                                                       torch.float32)
            self._lw_dev[score.device] = lw
        return torch.sign(score - label) * lw, lw

    def boost_from_score(self, class_id=0):
        if self.label is None:
            return 0.0
        return _percentile_of(self.label.astype(np.float64),
                              self.label_weight, 0.5)

    def need_renew_tree_output(self):
        return True

    def renew_leaf_values(self, leaf_pred, score, leaf_values, num_leaves):
        return _renew_by_percentile(leaf_pred, self.label - score,
                                    self.label_weight, leaf_values,
                                    num_leaves, 0.5)


class GammaLoss(PoissonLoss):
    name = "gamma"

    def get_gradients(self, score, label, weight):
        grad = 1.0 - label * torch.exp(-score)
        hess = label * torch.exp(-score)
        return _weighted(grad, hess, weight)


class TweedieLoss(PoissonLoss):
    name = "tweedie"

    def __init__(self, config):
        super().__init__(config)
        self.rho = config.tweedie_variance_power

    def get_gradients(self, score, label, weight):
        exp_1 = torch.exp((1.0 - self.rho) * score)
        exp_2 = torch.exp((2.0 - self.rho) * score)
        grad = -label * exp_1 + exp_2
        hess = -label * (1.0 - self.rho) * exp_1 + (2.0 - self.rho) * exp_2
        return _weighted(grad, hess, weight)
