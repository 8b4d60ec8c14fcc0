"""Multiclass objectives (reference ``src/objective/multiclass_objective.hpp``):
softmax (K coupled trees per iteration) and one-vs-all.  Port of the JAX
package's ``objective/multiclass.py``; scores are ``[K, N]``."""
from __future__ import annotations

import numpy as np
import torch

from .base import ObjectiveFunction, as_f32, from_f32
from .binary import BinaryLogloss
from ..utils.log import Log


def _softmax0(s: torch.Tensor) -> torch.Tensor:
    p = torch.exp(s - torch.max(s, dim=0, keepdim=True).values)
    return p / torch.sum(p, dim=0, keepdim=True)


class MulticlassSoftmax(ObjectiveFunction):
    name = "multiclass"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = config.num_class

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.label is not None:
            lbl = self.label.astype(np.int32)
            if lbl.min() < 0 or lbl.max() >= self.num_class:
                Log.fatal("Label must be in [0, %d) for multiclass objective", self.num_class)

    @property
    def num_model_per_iteration(self):
        return self.num_class

    def get_gradients_multi(self, score, label, weight):
        """score: [K, N]; returns ([K, N], [K, N])."""
        p = _softmax0(score)                                          # [K, N]
        classes = torch.arange(self.num_class, device=score.device)
        onehot = (classes[:, None] == label[None, :].to(torch.int32))
        grad = p - onehot.to(p.dtype)
        factor = self.num_class / (self.num_class - 1.0)
        hess = factor * p * (1.0 - p)
        if weight is not None:
            grad = grad * weight[None, :]
            hess = hess * weight[None, :]
        return grad, hess

    def boost_from_score(self, class_id=0):
        if self.label is None:
            return 0.0
        w = self.weight if self.weight is not None else np.ones_like(self.label)
        pavg = float(np.sum(w * (self.label.astype(np.int32) == class_id)) / np.sum(w))
        pavg = min(max(pavg, 1e-15), 1.0 - 1e-15)
        return float(np.log(pavg))

    def convert_output(self, score):
        """score: [K, N] raw -> softmax probabilities (float32)."""
        s, was_np = as_f32(score)
        return from_f32(_softmax0(s), was_np)


class MulticlassOVA(ObjectiveFunction):
    name = "multiclassova"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = config.num_class
        self.sigmoid = config.sigmoid
        self._binary = [BinaryLogloss(config) for _ in range(self.num_class)]

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        for k, b in enumerate(self._binary):
            class Meta:  # per-class binarized view
                pass
            m = Meta()
            m.label = (self.label.astype(np.int32) == k).astype(np.float32) \
                if self.label is not None else None
            m.weight = self.weight
            m.query_boundaries = None
            b.init(m, num_data)

    @property
    def num_model_per_iteration(self):
        return self.num_class

    def get_gradients_multi(self, score, label, weight):
        grads, hesss = [], []
        lbl = label.to(torch.int32)
        for k, b in enumerate(self._binary):
            g, h = b.get_gradients(score[k], (lbl == k).to(torch.float32),
                                   weight)
            grads.append(g)
            hesss.append(h)
        return torch.stack(grads), torch.stack(hesss)

    def boost_from_score(self, class_id=0):
        return self._binary[class_id].boost_from_score()

    def convert_output(self, score):
        s, was_np = as_f32(score)
        return from_f32(1.0 / (1.0 + torch.exp(-self.sigmoid * s)), was_np)
