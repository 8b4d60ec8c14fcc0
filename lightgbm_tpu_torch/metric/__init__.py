"""Metric factory (reference ``src/metric/metric.cpp:18-62``), with the JAX
package's alias table.  Every metric of the JAX package is ported (the
ranking ones, ``ndcg`` and ``map``, need query groups); an unknown name is
ignored with a warning, as there."""
from __future__ import annotations

from typing import List

from ..config import Config
from ..utils.log import Log
from .base import (Metric, L1Metric, L2Metric, RMSEMetric, QuantileMetric,
                   HuberMetric, FairMetric, PoissonMetric, MAPEMetric,
                   GammaMetric, GammaDevianceMetric, TweedieMetric,
                   BinaryLoglossMetric, BinaryErrorMetric, AUCMetric,
                   AveragePrecisionMetric, MultiLoglossMetric, MultiErrorMetric,
                   AucMuMetric)
from .rank import MapMetric, NDCGMetric
from .xentropy import (CrossEntropyLambdaMetric, CrossEntropyMetric,
                       KullbackLeiblerDivergence)

_ALIASES = {
    "mean_squared_error": "l2", "mse": "l2", "regression": "l2", "regression_l2": "l2",
    "l2_root": "rmse", "root_mean_squared_error": "rmse",
    "mean_absolute_error": "l1", "regression_l1": "l1", "mae": "l1",
    "mean_absolute_percentage_error": "mape",
    "multi_logloss": "multi_logloss", "multiclass": "multi_logloss",
    "softmax": "multi_logloss", "multiclassova": "multi_logloss",
    "multiclass_ova": "multi_logloss", "ova": "multi_logloss", "ovr": "multi_logloss",
    "xentropy": "cross_entropy", "xentlambda": "cross_entropy_lambda",
    "kldiv": "kullback_leibler",
    "mean_average_precision": "map",
}

_REGISTRY = {
    "l1": L1Metric, "l2": L2Metric, "rmse": RMSEMetric, "quantile": QuantileMetric,
    "huber": HuberMetric, "fair": FairMetric, "poisson": PoissonMetric,
    "mape": MAPEMetric, "gamma": GammaMetric, "gamma_deviance": GammaDevianceMetric,
    "tweedie": TweedieMetric, "binary_logloss": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric, "auc": AUCMetric,
    "average_precision": AveragePrecisionMetric,
    "multi_logloss": MultiLoglossMetric, "multi_error": MultiErrorMetric,
    "auc_mu": AucMuMetric,
    "cross_entropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyLambdaMetric,
    "kullback_leibler": KullbackLeiblerDivergence,
    "ndcg": NDCGMetric, "map": MapMetric,
}


def create_metric(name: str, config: Config):
    name = _ALIASES.get(name, name)
    if name in ("custom", "none", "null", "na", ""):
        return None
    if name not in _REGISTRY:
        Log.warning("Unknown metric %s, ignored", name)
        return None
    return _REGISTRY[name](config)


def create_metrics(config: Config) -> List[Metric]:
    out = []
    seen = set()
    for name in config.metric:
        name = _ALIASES.get(name, name)
        if name in seen:
            continue
        seen.add(name)
        m = create_metric(name, config)
        if m is not None:
            out.append(m)
    return out


__all__ = ["Metric", "create_metric", "create_metrics"]
