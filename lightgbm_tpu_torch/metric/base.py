"""Metric interface + regression/binary/multiclass metrics.

A copy of the JAX package's ``metric/base.py`` (numpy on the host, the same
formulas; the reference ``Metric``, ``include/LightGBM/metric.h``, and
``src/metric/{regression,binary,multiclass}_metric.hpp``).  The gamma
metric's constant takes ``math.lgamma`` in place of scipy's ``gammaln``.
``eval(score, objective)`` receives RAW scores and uses the objective's
output transform, exactly like the reference.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from ..config import Config


class Metric:
    name: str = "base"
    higher_better: bool = False

    def __init__(self, config: Config):
        self.config = config

    def init(self, metadata, num_data: int) -> None:
        self.num_data = num_data
        self.label = metadata.label
        self.weight = metadata.weight
        self.query_boundaries = metadata.query_boundaries
        self.sum_weights = (float(np.sum(self.weight))
                            if self.weight is not None else float(num_data))

    def eval(self, score: np.ndarray, objective=None) -> List[Tuple[str, float, bool]]:
        raise NotImplementedError

    # -- helpers --------------------------------------------------------
    def _transform(self, score: np.ndarray, objective) -> np.ndarray:
        if objective is not None:
            out = objective.convert_output(score)
            return np.asarray(out)
        return score

    def _avg(self, pointwise: np.ndarray) -> float:
        if self.weight is not None:
            return float(np.sum(pointwise * self.weight) / self.sum_weights)
        return float(np.mean(pointwise))


class _PointwiseRegressionMetric(Metric):
    def point_loss(self, y: np.ndarray, p: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def eval(self, score, objective=None):
        pred = self._transform(score, objective)
        return [(self.name, self._avg(self.point_loss(self.label, pred)), self.higher_better)]


class L2Metric(_PointwiseRegressionMetric):
    name = "l2"

    def point_loss(self, y, p):
        return (y - p) ** 2


class RMSEMetric(_PointwiseRegressionMetric):
    name = "rmse"

    def eval(self, score, objective=None):
        pred = self._transform(score, objective)
        return [(self.name, float(np.sqrt(self._avg((self.label - pred) ** 2))), False)]


class L1Metric(_PointwiseRegressionMetric):
    name = "l1"

    def point_loss(self, y, p):
        return np.abs(y - p)


class QuantileMetric(_PointwiseRegressionMetric):
    name = "quantile"

    def point_loss(self, y, p):
        a = self.config.alpha
        d = y - p
        return np.where(d >= 0, a * d, (a - 1) * d)


class HuberMetric(_PointwiseRegressionMetric):
    name = "huber"

    def point_loss(self, y, p):
        a = self.config.alpha
        d = np.abs(y - p)
        return np.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a))


class FairMetric(_PointwiseRegressionMetric):
    name = "fair"

    def point_loss(self, y, p):
        c = self.config.fair_c
        x = np.abs(y - p)
        return c * x - c * c * np.log1p(x / c)


class PoissonMetric(_PointwiseRegressionMetric):
    name = "poisson"

    def point_loss(self, y, p):
        eps = 1e-10
        return p - y * np.log(np.maximum(p, eps))


class MAPEMetric(_PointwiseRegressionMetric):
    name = "mape"

    def point_loss(self, y, p):
        return np.abs((y - p) / np.maximum(1.0, np.abs(y)))


class GammaMetric(_PointwiseRegressionMetric):
    name = "gamma"

    def point_loss(self, y, p):
        psi = 1.0
        theta = -1.0 / np.maximum(p, 1e-10)
        a = psi
        b = -np.log(-theta)
        c = 1.0 / psi * np.log(y / psi) - np.log(y) - math.lgamma(1.0 / psi)
        return -((y * theta + b) / a + c)


class GammaDevianceMetric(_PointwiseRegressionMetric):
    name = "gamma_deviance"

    def point_loss(self, y, p):
        eps = 1e-10
        frac = y / np.maximum(p, eps)
        return 2.0 * (frac - np.log(np.maximum(frac, eps)) - 1.0)


class TweedieMetric(_PointwiseRegressionMetric):
    name = "tweedie"

    def point_loss(self, y, p):
        rho = self.config.tweedie_variance_power
        eps = 1e-10
        p = np.maximum(p, eps)
        a = y * np.exp((1.0 - rho) * np.log(p)) / (1.0 - rho)
        b = np.exp((2.0 - rho) * np.log(p)) / (2.0 - rho)
        return -a + b


class BinaryLoglossMetric(Metric):
    name = "binary_logloss"

    def eval(self, score, objective=None):
        prob = np.clip(self._transform(score, objective), 1e-15, 1 - 1e-15)
        y = (self.label > 0).astype(np.float64)
        loss = -(y * np.log(prob) + (1 - y) * np.log(1 - prob))
        return [(self.name, self._avg(loss), False)]


class BinaryErrorMetric(Metric):
    name = "binary_error"

    def eval(self, score, objective=None):
        prob = self._transform(score, objective)
        y = (self.label > 0).astype(np.float64)
        err = ((prob > 0.5) != (y > 0)).astype(np.float64)
        return [(self.name, self._avg(err), False)]


class AUCMetric(Metric):
    name = "auc"
    higher_better = True

    def eval(self, score, objective=None):
        # weighted rank-sum AUC with tie handling (reference
        # binary_metric.hpp AUCMetric::Eval), vectorized over tie groups
        score = np.asarray(score, dtype=np.float64).ravel()
        y = (self.label > 0)
        w = (self.weight if self.weight is not None
             else np.ones(len(y))).astype(np.float64)
        order = np.argsort(score, kind="mergesort")
        s, ys, ws = score[order], y[order], w[order]
        pos_w = ws[ys].sum()
        neg_w = ws[~ys].sum()
        if pos_w <= 0 or neg_w <= 0:
            return [(self.name, 0.5, True)]
        # group boundaries of tied scores
        new_grp = np.empty(len(s), bool)
        new_grp[0] = True
        new_grp[1:] = s[1:] != s[:-1]
        gid = np.cumsum(new_grp) - 1
        n_grp = gid[-1] + 1
        wp = np.bincount(gid, weights=ws * ys, minlength=n_grp)       # pos mass/group
        wn = np.bincount(gid, weights=ws * ~ys, minlength=n_grp)      # neg mass/group
        neg_below = np.concatenate([[0.0], np.cumsum(wn)[:-1]])
        auc = np.sum(wp * (neg_below + wn / 2.0)) / (pos_w * neg_w)
        return [(self.name, float(auc), True)]


class AveragePrecisionMetric(Metric):
    name = "average_precision"
    higher_better = True

    def eval(self, score, objective=None):
        y = (self.label > 0).astype(np.float64)
        w = self.weight if self.weight is not None else np.ones(len(y))
        order = np.argsort(-np.asarray(score), kind="mergesort")
        ys, ws = y[order], w[order]
        tp = np.cumsum(ws * ys)
        fp = np.cumsum(ws * (1 - ys))
        precision = tp / np.maximum(tp + fp, 1e-20)
        total_pos = tp[-1]
        if total_pos <= 0:
            return [(self.name, 0.0, True)]
        ap = np.sum(precision * ws * ys) / total_pos
        return [(self.name, float(ap), True)]


class MultiLoglossMetric(Metric):
    name = "multi_logloss"

    def eval(self, score, objective=None):
        # score: [K, N]
        prob = np.clip(self._transform(score, objective), 1e-15, 1.0)
        lbl = self.label.astype(np.int64)
        p_true = prob[lbl, np.arange(len(lbl))]
        return [(self.name, self._avg(-np.log(p_true)), False)]


class MultiErrorMetric(Metric):
    name = "multi_error"

    def eval(self, score, objective=None):
        prob = self._transform(score, objective)     # [K, N]
        lbl = self.label.astype(np.int64)
        k = self.config.multi_error_top_k
        if k <= 1:
            err = (np.argmax(prob, axis=0) != lbl).astype(np.float64)
        else:
            topk = np.argsort(-prob, axis=0)[:k]
            err = (~(topk == lbl[None, :]).any(axis=0)).astype(np.float64)
        return [(self.name if k <= 1 else f"multi_error@{k}", self._avg(err), False)]


class AucMuMetric(Metric):
    """AUC-mu multiclass ranking metric (Kleiman & Page 2019), the analog of
    the reference ``AucMuMetric`` (``src/metric/multiclass_metric.hpp:183``).

    For every class pair (i, j), rows of the two classes are projected onto
    the separating direction ``t1 * (w_i - w_j) . score`` and a pairwise
    Mann-Whitney statistic is computed (ties credit 0.5, matching the
    reference's "j first then subtract half the tied j mass" accounting);
    the result averages over all C(K, 2) pairs.  Raw scores are used, as in
    the reference.  One deviation: ties are exact-equality groups rather
    than kEpsilon(=1e-15)-chained comparisons — indistinguishable except for
    adversarially spaced scores.
    """
    name = "auc_mu"
    higher_better = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        from ..utils.log import LightGBMError
        K = self.config.num_class
        if K < 2:
            raise LightGBMError("auc_mu requires num_class >= 2")
        self.num_class = K
        lbl = self.label.astype(np.int64)
        self._idx_by_class = [np.flatnonzero(lbl == c) for c in range(K)]
        if self.weight is not None:
            self._class_weight_sums = np.asarray(
                [float(self.weight[ix].sum()) for ix in self._idx_by_class])
        # class-weight matrix (reference config.cpp:157-180: default is
        # all-ones with zero diagonal; user matrix must be KxK, diagonal
        # forced to zero)
        W = self.config.auc_mu_weights
        if W:
            if len(W) != K * K:
                raise LightGBMError(
                    f"auc_mu_weights must have {K * K} elements, "
                    f"but found {len(W)}")
            mat = np.asarray(W, np.float64).reshape(K, K)
            np.fill_diagonal(mat, 0.0)
        else:
            mat = np.ones((K, K), np.float64)
            np.fill_diagonal(mat, 0.0)
        self._class_weights = mat

    def eval(self, score, objective=None):
        K = self.num_class
        lbl = self.label.astype(np.int64)
        ans = 0.0
        for i in range(K):
            ix_i = self._idx_by_class[i]
            for j in range(i + 1, K):
                ix_j = self._idx_by_class[j]
                if len(ix_i) == 0 or len(ix_j) == 0:
                    continue
                curr_v = self._class_weights[i] - self._class_weights[j]
                t1 = curr_v[i] - curr_v[j]
                idx = np.concatenate([ix_i, ix_j])
                d = t1 * (curr_v @ score[:, idx])             # [ni+nj]
                is_i = lbl[idx] == i
                w = (self.weight[idx] if self.weight is not None
                     else np.ones(len(idx)))
                order = np.argsort(d, kind="stable")
                d_s, is_i_s, w_s = d[order], is_i[order], w[order]
                jw = np.where(~is_i_s, w_s, 0.0)
                new_grp = np.concatenate([[True], np.diff(d_s) != 0.0])
                gid = np.cumsum(new_grp) - 1
                n_grp = int(gid[-1]) + 1
                jw_grp = np.bincount(gid, weights=jw, minlength=n_grp)
                j_below = np.concatenate([[0.0], np.cumsum(jw_grp)])[:-1]
                credit = j_below[gid] + 0.5 * jw_grp[gid]
                s_ij = float(np.sum(np.where(is_i_s, w_s * credit, 0.0)))
                if self.weight is None:
                    ans += s_ij / len(ix_i) / len(ix_j)
                else:
                    ans += (s_ij / self._class_weight_sums[i]
                            / self._class_weight_sums[j])
        ans = 2.0 * ans / K / (K - 1)
        return [(self.name, float(ans), True)]
