"""Metric interface + the binary metrics.

A copy of ``Metric``, ``BinaryLoglossMetric`` and ``AUCMetric`` from the JAX
package's ``metric/base.py`` (numpy on the host, the same formulas).
``eval(score, objective)`` receives RAW scores and uses the objective's
output transform, exactly like the reference.
"""
from __future__ import annotations

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


class BinaryLoglossMetric(Metric):
    name = "binary_logloss"

    def eval(self, score, objective=None):
        prob = np.clip(self._transform(score, objective), 1e-15, 1 - 1e-15)
        y = (self.label > 0).astype(np.float64)
        loss = -(y * np.log(prob) + (1 - y) * np.log(1 - prob))
        return [(self.name, self._avg(loss), False)]


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

