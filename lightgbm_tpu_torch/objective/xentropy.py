"""Cross-entropy objectives over probabilistic labels in [0, 1].

Port of the JAX package's ``objective/xentropy.py`` (reference
``src/objective/xentropy_objective.hpp``): ``CrossEntropy`` (:44) --
standard logistic cross-entropy with linear weights -- and
``CrossEntropyLambda`` (:152) -- the score maps to an intensity
``lambda = log(1 + e^f)`` and weights enter as ``p = 1 - (1-z)^w``.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import ObjectiveFunction, as_f32, from_f32
from ..utils.log import Log


def _check_unit_interval(label: np.ndarray, name: str) -> None:
    if np.any(label < 0.0) or np.any(label > 1.0):
        Log.fatal("[%s]: label must be in the interval [0, 1]", name)


class CrossEntropy(ObjectiveFunction):
    name = "cross_entropy"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        _check_unit_interval(self.label, self.name)
        if self.weight is not None:
            if np.min(self.weight) < 0.0:
                Log.fatal("[%s]: at least one weight is negative", self.name)
            if np.sum(self.weight) == 0.0:
                Log.fatal("[%s]: sum of weights is zero", self.name)

    def get_gradients(self, score, label, weight):
        z = 1.0 / (1.0 + torch.exp(-score))
        grad = z - label
        hess = z * (1.0 - z)
        if weight is not None:
            grad, hess = grad * weight, hess * weight
        return grad, hess

    def boost_from_score(self, class_id=0):
        if self.weight is not None:
            pavg = float(np.sum(self.label * self.weight) / np.sum(self.weight))
        else:
            pavg = float(np.mean(self.label))
        pavg = min(max(pavg, 1e-15), 1.0 - 1e-15)
        init = np.log(pavg / (1.0 - pavg))
        Log.info("[%s:BoostFromScore]: pavg=%f -> initscore=%f",
                 self.name, pavg, init)
        return float(init)

    def convert_output(self, score):
        s, was_np = as_f32(score)
        return from_f32(1.0 / (1.0 + torch.exp(-s)), was_np)


class CrossEntropyLambda(ObjectiveFunction):
    name = "cross_entropy_lambda"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        _check_unit_interval(self.label, self.name)
        if self.weight is not None and np.min(self.weight) <= 0.0:
            Log.fatal("[%s]: at least one weight is non-positive", self.name)

    def get_gradients(self, score, label, weight):
        if weight is None:
            z = 1.0 / (1.0 + torch.exp(-score))
            return z - label, z * (1.0 - z)
        # weighted case (xentropy_objective.hpp:199-216)
        w, y = weight, label
        epf = torch.exp(score)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-w * hhat)
        enf = torch.exp(-score)
        grad = (1.0 - y / z) * w / (1.0 + enf)
        c = 1.0 / (1.0 - z)
        d = 1.0 + epf
        a = w * epf / (d * d)
        d = c - 1.0
        b = (c / (d * d)) * (1.0 + w * epf - c)
        hess = a * (1.0 + y * b)
        return grad, hess

    def boost_from_score(self, class_id=0):
        if self.weight is not None:
            havg = float(np.sum(self.label * self.weight) / np.sum(self.weight))
        else:
            havg = float(np.mean(self.label))
        init = np.log(max(np.exp(havg) - 1.0, 1e-15))
        Log.info("[%s:BoostFromScore]: havg=%f -> initscore=%f",
                 self.name, havg, init)
        return float(init)

    def convert_output(self, score):
        # output is the intensity lambda > 0, NOT a probability
        # (xentropy_objective.hpp:222-234)
        s, was_np = as_f32(score)
        return from_f32(torch.log1p(torch.exp(s)), was_np)
