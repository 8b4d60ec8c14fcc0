"""Objective function interface.

Port of the JAX package's ``objective/base.py``: per-row gradients/hessians
from scores as torch tensors on the scores' device, automatic initial score
(``BoostFromScore``), the output transform (``ConvertOutput``) and the
leaf-output renewal of the L1-style objectives (``RenewTreeOutput``, numpy
on the host, as in the JAX package).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config


class ObjectiveFunction:
    name: str = "base"

    def __init__(self, config: Config):
        self.config = config
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None

    # -- lifecycle ------------------------------------------------------
    def init(self, metadata, num_data: int) -> None:
        """Bind dataset metadata (reference ``ObjectiveFunction::Init``)."""
        self.num_data = num_data
        self.label = metadata.label
        self.weight = metadata.weight
        self.query_boundaries = metadata.query_boundaries

    # -- core -----------------------------------------------------------
    def get_gradients(self, score: torch.Tensor, label: torch.Tensor,
                      weight: Optional[torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def boost_from_score(self, class_id: int = 0) -> float:
        """Initial constant score (reference ``BoostFromScore``); 0 if the
        objective does not support boosting from average."""
        return 0.0

    def convert_output(self, score):
        return score

    @property
    def num_model_per_iteration(self) -> int:
        return 1

    def need_renew_tree_output(self) -> bool:
        return False

    def renew_leaf_values(self, leaf_pred: np.ndarray, score: np.ndarray,
                          leaf_values: np.ndarray, num_leaves: int) -> np.ndarray:
        """Percentile re-fit of leaf outputs (reference ``RenewTreeOutput``,
        used by L1/quantile/MAPE)."""
        return leaf_values


def as_f32(score):
    """``(float32 tensor, was_numpy)``: an output transform computes in
    float32 like the JAX package's ``jnp`` (64-bit mode off); numpy in,
    numpy out, tensor in, tensor out."""
    if isinstance(score, torch.Tensor):
        return score.to(torch.float32), False
    return torch.as_tensor(np.asarray(score, np.float64)).to(torch.float32), True


def from_f32(t: torch.Tensor, was_numpy: bool):
    return t.numpy() if was_numpy else t


def _percentile_of(values: np.ndarray, weights: Optional[np.ndarray], alpha: float) -> float:
    """Weighted percentile (reference ``PercentileFun``/``WeightedPercentileFun``,
    ``regression_objective.hpp:23-70``)."""
    if len(values) == 0:
        return 0.0
    order = np.argsort(values)
    v = values[order]
    if weights is None:
        # reference PercentileFun: linear interpolation on positions
        pos = alpha * (len(v) - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, len(v) - 1)
        return float(v[lo] + (pos - lo) * (v[hi] - v[lo]))
    w = weights[order]
    cw = np.cumsum(w)
    threshold = alpha * cw[-1]
    idx = int(np.searchsorted(cw, threshold))
    return float(v[min(idx, len(v) - 1)])
