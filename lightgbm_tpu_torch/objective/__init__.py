"""Objective factory (reference ``src/objective/objective_function.cpp:16-48``).
Every objective of the JAX package is ported (the ranking ones,
``lambdarank`` and ``rank_xendcg``, need query groups) except ``none`` (a
custom objective), which raises ``NotPortedError``."""
from __future__ import annotations

from ..config import Config
from ..device import NotPortedError
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
# objectives of the JAX package that this package has not ported yet
NOT_PORTED = ("none",)


def create_objective(config: Config) -> ObjectiveFunction:
    name = config.objective
    if name in NOT_PORTED:
        raise NotPortedError(f"objective {name!r} is not ported yet")
    if name not in _REGISTRY:
        Log.fatal("Unknown objective type name: %s", name)
    return _REGISTRY[name](config)


__all__ = ["ObjectiveFunction", "create_objective"]
