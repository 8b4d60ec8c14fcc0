"""One-liner distributed estimators: the Dask-package analog.

Port of the JAX package's ``parallel/estimators.py`` (reference
``python-package/lightgbm/dask.py`` ``DaskLGBMClassifier`` /
``DaskLGBMRegressor``): sklearn-style estimators whose ``fit`` runs
``parallel.trainer.train_distributed`` over each rank's local partition.

The process group is found in this order:

1. an initialized ``torch.distributed`` group is used as it is;
2. the ``machines`` constructor param / ``machines`` entry in params -- a
   ``host[:port],host[:port]`` list, wired by ``parallel.set_network``
   (the rank is the local host's entry, the first entry the coordinator);
3. the ``LGBM_TPU_MACHINES`` environment variable, same format;
4. none of the above: single-process training.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch.distributed as dist

from ..sklearn import LGBMClassifier, LGBMRegressor
from ..utils.log import Log, LightGBMError
from .trainer import train_distributed

__all__ = ["DistLGBMClassifier", "DistLGBMRegressor"]


def _distributed_active() -> bool:
    return dist.is_initialized()


def _resolve_network(machines, local_listen_port: int, time_out: int,
                     device) -> None:
    """Bring up the process group when a machine list is known and no
    group exists yet; otherwise leave the topology alone."""
    if _distributed_active():
        return
    machines = machines or os.environ.get("LGBM_TPU_MACHINES") or ""
    if not machines:
        return                      # single process
    from .mesh import set_network
    set_network(machines, local_listen_port=local_listen_port,
                listen_time_out=time_out, device=device)


class _DistMixin:
    """fit() plumbing shared by the distributed estimators."""

    def _dist_fit(self, X, y, sample_weight=None, group=None,
                  eval_set=None, eval_group=None,
                  early_stopping_rounds=None,
                  feature_name=None, categorical_feature=None):
        params = self._lgb_params()
        machines = params.pop("machines", None) or getattr(
            self, "machines", None)
        port = int(params.pop("local_listen_port", 0) or
                   getattr(self, "local_listen_port", 12400))
        time_out = int(params.pop("time_out", 0) or 120)
        # aliases train_distributed's engine would parse again
        for k in ("num_machines", "num_machine"):
            params.pop(k, None)
        _resolve_network(machines, port, time_out, self.device)

        valid = None
        vgroup = None
        if eval_set:
            if len(eval_set) > 1:
                Log.warning("Dist estimators pool ONE validation shard; "
                            "using eval_set[0] and ignoring %d more",
                            len(eval_set) - 1)
            vX, vy = eval_set[0]
            valid = (vX, np.asarray(self._prep_eval_label(
                np.asarray(vy).ravel())).ravel())
            if eval_group:
                vgroup = eval_group[0]

        self._evals_result = {}
        booster = train_distributed(
            params, X, y, num_boost_round=self.n_estimators,
            weight=sample_weight, group=group, valid_data=valid,
            valid_group=vgroup,
            early_stopping_rounds=early_stopping_rounds,
            evals_result=self._evals_result,
            feature_name=feature_name,
            categorical_feature=categorical_feature, device=self.device)
        self._Booster = booster
        self._best_iteration = getattr(booster, "best_iteration", -1)
        self._n_features = (int(X.shape[1]) if hasattr(X, "shape")
                            else len(X[0]))
        self.fitted_ = True
        return self


class DistLGBMRegressor(_DistMixin, LGBMRegressor):
    """Distributed (multi-process) LGBMRegressor."""

    def __init__(self, machines: Optional[Any] = None,
                 local_listen_port: int = 12400, **kwargs):
        self.machines = machines
        self.local_listen_port = local_listen_port
        super().__init__(**kwargs)

    def fit(self, X, y, sample_weight=None, eval_set=None,
            early_stopping_rounds=None, feature_name=None,
            categorical_feature=None, **_ignored):
        y = np.asarray(y, np.float64).ravel()
        return self._dist_fit(
            X, y, sample_weight=sample_weight, eval_set=eval_set,
            early_stopping_rounds=early_stopping_rounds,
            feature_name=feature_name,
            categorical_feature=categorical_feature)


class DistLGBMClassifier(_DistMixin, LGBMClassifier):
    """Distributed (multi-process) LGBMClassifier.

    Class discovery pools the label sets across ranks (a rank whose shard
    misses a class must still agree on the global code mapping).
    """

    def __init__(self, machines: Optional[Any] = None,
                 local_listen_port: int = 12400, **kwargs):
        self.machines = machines
        self.local_listen_port = local_listen_port
        super().__init__(**kwargs)

    def fit(self, X, y, sample_weight=None, eval_set=None,
            early_stopping_rounds=None, feature_name=None,
            categorical_feature=None, **_ignored):
        from .mesh import default_mesh
        y = np.asarray(y).ravel()
        local = np.unique(y)
        mesh = default_mesh()
        if mesh.size > 1:
            if not np.issubdtype(local.dtype, np.number):
                raise LightGBMError(
                    "multi-process DistLGBMClassifier needs numeric labels "
                    "(cross-rank class pooling rides float collectives); "
                    "encode string labels before sharding")
            local_f = local.astype(np.float64)
            n_max = int(mesh.gather_np(np.array([len(local_f)],
                                                np.int64)).max())
            padded = np.pad(local_f, (0, n_max - len(local_f)),
                            constant_values=local_f[0] if len(local_f)
                            else 0.0)
            self._classes = np.unique(mesh.gather_np(padded).ravel())
        else:
            self._classes = local
        self._n_classes = len(self._classes)
        y_enc = np.searchsorted(self._classes, y).astype(np.float64)
        self._resolve_classification_objective()
        return self._dist_fit(
            X, y_enc, sample_weight=sample_weight, eval_set=eval_set,
            early_stopping_rounds=early_stopping_rounds,
            feature_name=feature_name,
            categorical_feature=categorical_feature)
