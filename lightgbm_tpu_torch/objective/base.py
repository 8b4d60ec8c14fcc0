"""Objective function interface.

Port of the JAX package's ``objective/base.py``: per-row gradients/hessians
from scores as torch tensors on the scores' device, automatic initial score
(``BoostFromScore``) and the output transform (``ConvertOutput``).  Leaf
renewal for L1-style objectives is not ported (no ported objective needs it).
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
