"""Ranking metrics: NDCG@k and MAP@k.

A copy of the JAX package's ``metric/rank.py`` (numpy on the host).  Analog
of the reference ``NDCGMetric`` (``src/metric/rank_metric.hpp:19``) and
``MapMetric`` (``src/metric/map_metric.hpp:21``) with ``DCGCalculator``
(``src/metric/dcg_calculator.cpp``).  The reference loops queries under
OpenMP; here all queries are evaluated at once in a padded ``[Q, L]`` numpy
layout (sort once, mask padded slots).
"""
from __future__ import annotations

from typing import List

import numpy as np

from .base import Metric
from ..objective.rank import default_label_gain, check_rank_labels
from ..utils.log import LightGBMError


def _padded_layout(boundaries: np.ndarray):
    counts = np.diff(boundaries).astype(np.int64)
    Q, L = len(counts), int(max(1, counts.max()))
    idx = boundaries[:-1, None] + np.minimum(np.arange(L)[None, :],
                                             np.maximum(counts[:, None] - 1, 0))
    mask = np.arange(L)[None, :] < counts[:, None]
    return idx, mask, counts


def _sorted_by_score(score, label, idx, mask):
    """Labels per query re-ordered by descending score (stable)."""
    s = score[idx]
    s_masked = np.where(mask, s, -np.inf)
    order = np.argsort(-s_masked, axis=1, kind="stable")
    return np.take_along_axis(label[idx], order, axis=1)


class NDCGMetric(Metric):
    name = "ndcg"
    higher_better = True

    def __init__(self, config):
        super().__init__(config)
        self.eval_at = list(config.eval_at) or [1, 2, 3, 4, 5]
        self.label_gain = (np.asarray(config.label_gain, np.float64)
                           if config.label_gain else default_label_gain())

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.query_boundaries is None:
            raise LightGBMError("The NDCG metric requires query information")
        check_rank_labels(self.label, len(self.label_gain))
        b = np.asarray(self.query_boundaries, np.int64)
        self._idx, self._mask, self._counts = _padded_layout(b)
        Q, L = self._mask.shape
        self._disc = 1.0 / np.log2(2.0 + np.arange(L))
        # ideal (max) DCG per query per k: labels sorted descending
        lab = np.where(self._mask, self.label[self._idx], -1)
        ideal = -np.sort(-lab, axis=1)                 # descending
        gains_ideal = np.where(ideal >= 0, self.label_gain[np.maximum(ideal, 0)
                                                           .astype(np.int64)], 0.0)
        csum = np.cumsum(gains_ideal * self._disc[None, :], axis=1)
        self._inv_max = {}
        for k in self.eval_at:
            kk = np.minimum(k, self._counts) - 1
            mx = csum[np.arange(Q), np.maximum(kk, 0)]
            inv = np.where(mx > 0, 1.0 / np.maximum(mx, 1e-300), -1.0)
            self._inv_max[k] = inv
        # per-query weights: reference uses metadata query weights; we derive
        # them from row weights (constant within query) when present
        if self.weight is not None:
            self._qw = self.weight[b[:-1]].astype(np.float64)
        else:
            self._qw = np.ones(Q, np.float64)
        self._sum_qw = float(self._qw.sum())

    def eval(self, score, objective=None) -> List:
        score = np.asarray(score, np.float64).ravel()
        sl = _sorted_by_score(score, self.label, self._idx, self._mask)
        gains = np.where(self._mask,
                         self.label_gain[np.maximum(sl, 0).astype(np.int64)], 0.0)
        csum = np.cumsum(gains * self._disc[None, :], axis=1)
        Q = len(self._counts)
        out = []
        for k in self.eval_at:
            kk = np.minimum(k, self._counts) - 1
            dcg = csum[np.arange(Q), np.maximum(kk, 0)]
            inv = self._inv_max[k]
            ndcg = np.where(inv <= 0, 1.0, dcg * np.maximum(inv, 0.0))
            val = float(np.sum(ndcg * self._qw) / self._sum_qw)
            out.append((f"ndcg@{k}", val, True))
        return out


class MapMetric(Metric):
    name = "map"
    higher_better = True

    def __init__(self, config):
        super().__init__(config)
        self.eval_at = list(config.eval_at) or [1, 2, 3, 4, 5]

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.query_boundaries is None:
            raise LightGBMError("For MAP metric, there should be query information")
        b = np.asarray(self.query_boundaries, np.int64)
        self._idx, self._mask, self._counts = _padded_layout(b)
        rel = (self.label[self._idx] > 0.5) & self._mask
        self._npos = rel.sum(axis=1)
        if self.weight is not None:
            self._qw = self.weight[b[:-1]].astype(np.float64)
        else:
            self._qw = np.ones(len(self._counts), np.float64)
        self._sum_qw = float(self._qw.sum())

    def eval(self, score, objective=None) -> List:
        score = np.asarray(score, np.float64).ravel()
        sl = _sorted_by_score(score, self.label, self._idx, self._mask)
        hit = (sl > 0.5) & self._mask                      # [Q, L]
        cum_hits = np.cumsum(hit, axis=1)
        ranks = np.arange(1, hit.shape[1] + 1)[None, :]
        prec_at_hit = np.where(hit, cum_hits / ranks, 0.0)
        csum_ap = np.cumsum(prec_at_hit, axis=1)
        Q = len(self._counts)
        out = []
        for k in self.eval_at:
            kk = np.minimum(k, self._counts)
            sum_ap = csum_ap[np.arange(Q), np.maximum(kk - 1, 0)]
            denom = np.minimum(self._npos, kk)
            ap = np.where(self._npos > 0,
                          sum_ap / np.maximum(denom, 1), 1.0)
            val = float(np.sum(ap * self._qw) / self._sum_qw)
            out.append((f"map@{k}", val, True))
        return out


__all__ = ["NDCGMetric", "MapMetric"]
