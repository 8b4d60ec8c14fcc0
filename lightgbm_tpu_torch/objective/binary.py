"""Binary classification objective (reference
``src/objective/binary_objective.hpp``): sigmoid-parameterized logloss with
class weighting (``scale_pos_weight`` / ``is_unbalance``).  Port of the JAX
package's ``objective/binary.py``; gradients are float32 torch ops in the
same order as the JAX ones."""
from __future__ import annotations

import numpy as np
import torch

from .base import ObjectiveFunction
from ..utils.log import Log


class BinaryLogloss(ObjectiveFunction):
    name = "binary"

    def __init__(self, config, is_unbalance=None):
        super().__init__(config)
        self.sigmoid = config.sigmoid
        self.is_unbalance = config.is_unbalance if is_unbalance is None else is_unbalance
        self.scale_pos_weight = config.scale_pos_weight
        if self.sigmoid <= 0.0:
            Log.fatal("Sigmoid parameter %f should be greater than zero", self.sigmoid)
        self.label_weights = (1.0, 1.0)

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        lbl = self.label
        if lbl is None:
            return
        cnt_pos = float(np.sum(lbl > 0))
        cnt_neg = float(len(lbl) - cnt_pos)
        if cnt_pos == 0 or cnt_neg == 0:
            Log.warning("Contains only one class")
        # is_unbalance: weight classes inversely to frequency (binary_objective.hpp:70)
        if self.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            # the MINORITY class is weighted up (binary_objective.hpp:82-89:
            # label_weights_[1] is the positive-class weight)
            if cnt_pos > cnt_neg:
                self.label_weights = (cnt_pos / cnt_neg, 1.0)
            else:
                self.label_weights = (1.0, cnt_neg / cnt_pos)
        else:
            self.label_weights = (1.0, self.scale_pos_weight)
        self.cnt_pos, self.cnt_neg = cnt_pos, cnt_neg

    def get_gradients(self, score, label, weight):
        is_pos = label > 0
        one = torch.ones_like(score)
        y = torch.where(is_pos, one, -one)
        lw = torch.where(is_pos, one * self.label_weights[1],
                         one * self.label_weights[0])
        response = -y * self.sigmoid / (1.0 + torch.exp(y * self.sigmoid * score))
        abs_response = torch.abs(response)
        grad = response * lw
        hess = abs_response * (self.sigmoid - abs_response) * lw
        if weight is not None:
            grad, hess = grad * weight, hess * weight
        return grad, hess

    def boost_from_score(self, class_id=0):
        if self.label is None:
            return 0.0
        if self.weight is not None:
            pavg = float(np.sum(self.weight * (self.label > 0)) / np.sum(self.weight))
        else:
            pavg = self.cnt_pos / max(1.0, self.cnt_pos + self.cnt_neg)
        pavg = min(max(pavg, 1e-15), 1.0 - 1e-15)
        init = np.log(pavg / (1.0 - pavg)) / self.sigmoid
        Log.info("[%s:BoostFromScore]: pavg=%f -> initscore=%f", self.name, pavg, init)
        return float(init)

    def convert_output(self, score):
        """Sigmoid of raw scores, computed in float32 like the JAX package
        (which runs it through jnp with 64-bit mode off); numpy in, numpy
        out, tensor in, tensor out."""
        if isinstance(score, torch.Tensor):
            s = score.to(torch.float32)
            return 1.0 / (1.0 + torch.exp(-self.sigmoid * s))
        s = torch.as_tensor(np.asarray(score, np.float64)).to(torch.float32)
        return (1.0 / (1.0 + torch.exp(-self.sigmoid * s))).numpy()
