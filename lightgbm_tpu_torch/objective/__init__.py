"""Objective factory (reference ``src/objective/objective_function.cpp:16-48``).
Only the binary objective is ported; every other name raises
``NotPortedError``."""
from __future__ import annotations

from ..config import Config
from ..device import NotPortedError
from .base import ObjectiveFunction
from .binary import BinaryLogloss

_REGISTRY = {"binary": BinaryLogloss}


def create_objective(config: Config) -> ObjectiveFunction:
    name = config.objective
    if name not in _REGISTRY:
        raise NotPortedError(
            f"objective {name!r} is not ported yet (ported: binary)")
    return _REGISTRY[name](config)


__all__ = ["ObjectiveFunction", "create_objective"]
