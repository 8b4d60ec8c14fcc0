"""Metric factory (reference ``src/metric/metric.cpp:18-62``).  The binary
metrics ``auc`` and ``binary_logloss`` are ported; any other metric name
raises ``NotPortedError``."""
from __future__ import annotations

from typing import List

from ..config import Config
from ..device import NotPortedError
from .base import AUCMetric, BinaryLoglossMetric, Metric

_REGISTRY = {"binary_logloss": BinaryLoglossMetric, "auc": AUCMetric}


def create_metric(name: str, config: Config):
    if name in ("custom", "none", "null", "na", ""):
        return None
    if name not in _REGISTRY:
        raise NotPortedError(
            f"metric {name!r} is not ported yet (ported: auc, binary_logloss)")
    return _REGISTRY[name](config)


def create_metrics(config: Config) -> List[Metric]:
    out = []
    seen = set()
    for name in config.metric:
        if name in seen:
            continue
        seen.add(name)
        m = create_metric(name, config)
        if m is not None:
            out.append(m)
    return out


__all__ = ["Metric", "create_metric", "create_metrics"]
