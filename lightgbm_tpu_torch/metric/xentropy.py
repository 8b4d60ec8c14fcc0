"""Cross-entropy metrics (reference ``src/metric/xentropy_metric.hpp``):
``cross_entropy`` (:71), ``cross_entropy_lambda`` (:166) and
``kullback_leibler`` (:249).  A copy of the JAX package's
``metric/xentropy.py``."""
from __future__ import annotations

import numpy as np

from .base import Metric


def _xent(y: np.ndarray, p: np.ndarray) -> np.ndarray:
    p = np.clip(p, 1e-15, 1.0 - 1e-15)
    return -(y * np.log(p) + (1.0 - y) * np.log(1.0 - p))


class CrossEntropyMetric(Metric):
    name = "cross_entropy"

    def eval(self, score, objective=None):
        p = np.asarray(self._transform(score, objective), np.float64).ravel()
        return [(self.name, self._avg(_xent(self.label, p)), False)]


class CrossEntropyLambdaMetric(Metric):
    name = "cross_entropy_lambda"

    def eval(self, score, objective=None):
        score = np.asarray(score, np.float64).ravel()
        if objective is not None:
            hhat = np.asarray(objective.convert_output(score))
        else:
            hhat = np.log1p(np.exp(score))
        w = self.weight if self.weight is not None else 1.0
        p = 1.0 - np.exp(-w * hhat)
        # reference averages by num_data, not sum of weights
        # (xentropy_metric.hpp:221)
        loss = float(np.mean(_xent(self.label, p)))
        return [(self.name, loss, False)]


class KullbackLeiblerDivergence(Metric):
    name = "kullback_leibler"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        y = np.clip(self.label.astype(np.float64), 1e-15, 1.0 - 1e-15)
        ent = y * np.log(y) + (1.0 - y) * np.log(1.0 - y)
        # degenerate labels 0/1 contribute zero entropy
        ent = np.where((self.label <= 0) | (self.label >= 1), 0.0, ent)
        self._offset = self._avg(ent)

    def eval(self, score, objective=None):
        p = np.asarray(self._transform(score, objective), np.float64).ravel()
        return [(self.name, self._offset + self._avg(_xent(self.label, p)), False)]


__all__ = ["CrossEntropyMetric", "CrossEntropyLambdaMetric",
           "KullbackLeiblerDivergence"]
