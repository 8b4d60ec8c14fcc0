"""Objective factory (reference ``src/objective/objective_function.cpp:16-48``).
Every objective of the JAX package is ported (the ranking ones,
``lambdarank`` and ``rank_xendcg``, need query groups); ``none`` (a custom
objective: the caller passes the gradients) makes no objective."""
from __future__ import annotations

from typing import Optional

from ..config import Config
from ..utils.log import Log
from .base import ObjectiveFunction
from .binary import BinaryLogloss
from .multiclass import MulticlassOVA, MulticlassSoftmax
from .rank import LambdarankNDCG, RankXENDCG
from .regression import (FairLoss, GammaLoss, HuberLoss, MAPELoss,
                         PoissonLoss, QuantileLoss, RegressionL1Loss,
                         RegressionL2Loss, TweedieLoss)
from .xentropy import CrossEntropy, CrossEntropyLambda

_REGISTRY = {
    "regression": RegressionL2Loss,
    "regression_l1": RegressionL1Loss,
    "huber": HuberLoss,
    "fair": FairLoss,
    "poisson": PoissonLoss,
    "quantile": QuantileLoss,
    "mape": MAPELoss,
    "gamma": GammaLoss,
    "tweedie": TweedieLoss,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
    "xentropy": CrossEntropy,
    "xentlambda": CrossEntropyLambda,
    "lambdarank": LambdarankNDCG,
    "rank_xendcg": RankXENDCG,
}


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    name = config.objective
    if name == "none":
        return None
    if name not in _REGISTRY:
        Log.fatal("Unknown objective type name: %s", name)
    return _REGISTRY[name](config)


__all__ = ["ObjectiveFunction", "create_objective"]
