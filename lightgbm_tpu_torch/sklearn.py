"""scikit-learn API wrappers.

A copy of the JAX package's ``sklearn.py`` on this package's engine (the
reference ``python-package/lightgbm/sklearn.py``: ``LGBMModel`` (:180),
``LGBMRegressor`` (:780), ``LGBMClassifier`` (:806), ``LGBMRanker`` (:958)
plus the custom objective/eval wrappers (:19,103)).  One parameter more:
``device`` (None: the CUDA card, raising ``NoCudaDeviceError`` without
one; ``"cpu"`` for the plain PyTorch path), estimator state forwarded to
``train`` as ``n_jobs`` is kept, never a booster parameter.  scikit-learn
is optional: without it the estimators derive from stand-in bases.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .io.dataset import _is_dataframe, _is_sparse
from .basic import Booster, Dataset
from .engine import train
from .utils.log import LightGBMError

try:
    # real sklearn bases when available: estimator tags (__sklearn_tags__,
    # required by sklearn>=1.6 meta-estimators like GridSearchCV), clone()
    # and repr support all ride the official protocol
    from sklearn.base import BaseEstimator as _SKLBase
    from sklearn.base import ClassifierMixin as _SKLClassifierMixin
    from sklearn.base import RegressorMixin as _SKLRegressorMixin
except ImportError:                                  # sklearn is optional
    _SKLBase = object

    class _SKLClassifierMixin:
        pass

    class _SKLRegressorMixin:
        pass

__all__ = ["LGBMModel", "LGBMClassifier", "LGBMRegressor", "LGBMRanker"]


class _ObjectiveFunctionWrapper:
    """Adapt sklearn-style ``fobj(y_true, y_pred) -> grad, hess`` to the
    engine's ``fobj(preds, dataset)`` (reference ``sklearn.py:19``)."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, preds, dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        if argc == 2:
            grad, hess = self.func(labels, preds)
        elif argc == 3:
            grad, hess = self.func(labels, preds, dataset.get_group())
        else:
            raise TypeError(f"Self-defined objective should have 2 or 3 arguments, got {argc}")
        return grad, hess


class _EvalFunctionWrapper:
    """Adapt ``feval(y_true, y_pred) -> name, value, higher_better``
    (reference ``sklearn.py:103``)."""

    def __init__(self, func: Callable):
        self.func = func

    def __call__(self, preds, dataset):
        labels = dataset.get_label()
        argc = self.func.__code__.co_argcount
        if argc == 2:
            return self.func(labels, preds)
        elif argc == 3:
            return self.func(labels, preds, dataset.get_weight())
        elif argc == 4:
            return self.func(labels, preds, dataset.get_weight(), dataset.get_group())
        raise TypeError(f"Self-defined eval function should have 2-4 arguments, got {argc}")


class LGBMModel(_SKLBase):
    """Base sklearn estimator (reference ``sklearn.py:180``)."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[str] = None, class_weight=None,
                 min_split_gain: float = 0.0, min_child_weight: float = 1e-3,
                 min_child_samples: int = 20, subsample: float = 1.0,
                 subsample_freq: int = 0, colsample_bytree: float = 1.0,
                 reg_alpha: float = 0.0, reg_lambda: float = 0.0,
                 random_state: Optional[int] = None, n_jobs: int = -1,
                 silent: bool = True,
                 importance_type: str = "split", device=None, **kwargs):
        # ``silent`` sits at the reference's position (sklearn.py:180) so
        # positional callers bind identically; it is estimator state, not a
        # booster param
        self.silent = silent
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.importance_type = importance_type
        self.device = device
        self._other_params: Dict[str, Any] = dict(kwargs)
        self._Booster: Optional[Booster] = None
        self._evals_result: Dict = {}
        self._best_iteration: int = -1
        self._n_features: int = -1
        self._objective = objective
        self.fitted_ = False

    # -- sklearn protocol ----------------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = {k: getattr(self, k) for k in (
            "boosting_type", "num_leaves", "max_depth", "learning_rate",
            "n_estimators", "subsample_for_bin", "objective", "class_weight",
            "min_split_gain", "min_child_weight", "min_child_samples",
            "subsample", "subsample_freq", "colsample_bytree", "reg_alpha",
            "reg_lambda", "random_state", "n_jobs", "silent",
            "importance_type", "device")}
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for k, v in params.items():
            if hasattr(self, k) and not k.startswith("_"):
                setattr(self, k, v)
            else:
                self._other_params[k] = v
        return self

    # -- param assembly -------------------------------------------------
    def _lgb_params(self) -> Dict[str, Any]:
        p = {
            "boosting": self.boosting_type,
            "num_leaves": self.num_leaves,
            "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "min_gain_to_split": self.min_split_gain,
            "min_sum_hessian_in_leaf": self.min_child_weight,
            "min_data_in_leaf": self.min_child_samples,
            "bagging_fraction": self.subsample,
            "bagging_freq": self.subsample_freq,
            "feature_fraction": self.colsample_bytree,
            "lambda_l1": self.reg_alpha,
            "lambda_l2": self.reg_lambda,
            # reference sklearn wrapper: silent picks the verbosity (an
            # explicit verbose/verbosity kwarg in _other_params overrides)
            "verbose": -1 if self.silent else 1,
        }
        if self.random_state is not None:
            p["seed"] = int(self.random_state)
        p.update(self._other_params)
        if callable(self._objective):
            p["objective"] = "none"
        elif self._objective is not None:
            p["objective"] = self._objective
        return p

    def _class_weight_to_sample_weight(self, y, sample_weight):
        if self.class_weight is None:
            return sample_weight
        from sklearn.utils.class_weight import compute_sample_weight
        cw = compute_sample_weight(self.class_weight, y)
        return cw if sample_weight is None else cw * sample_weight

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_group=None, eval_metric=None, early_stopping_rounds=None,
            feature_name="auto", categorical_feature="auto", callbacks=None,
            init_model=None, verbose: Any = False):
        if not _is_sparse(X) and not _is_dataframe(X):
            # DataFrames pass through untouched so Dataset's pandas path
            # (category-dtype -> codes, auto feature names) applies;
            # non-pandas frame look-alikes contribute their .values
            X = np.asarray(getattr(X, "values", X), dtype=np.float64)
        y = np.asarray(y).ravel()
        self._n_features = X.shape[1]
        params = self._lgb_params()
        if eval_metric is not None and not callable(eval_metric):
            metrics = eval_metric if isinstance(eval_metric, list) else [eval_metric]
            existing = params.get("metric")
            if existing:
                existing = existing if isinstance(existing, list) else [existing]
                metrics = existing + [m for m in metrics if m not in existing]
            params["metric"] = metrics

        fobj = _ObjectiveFunctionWrapper(self._objective) if callable(self._objective) else None
        feval = _EvalFunctionWrapper(eval_metric) if callable(eval_metric) else None

        sample_weight = self._class_weight_to_sample_weight(y, sample_weight)
        train_set = Dataset(X, label=y, weight=sample_weight, group=group,
                            init_score=init_score, params=params,
                            feature_name=feature_name,
                            categorical_feature=categorical_feature)
        valid_sets, valid_names = [], []
        if eval_set is not None:
            for i, (vX, vy) in enumerate(eval_set):
                if not _is_sparse(vX) and not _is_dataframe(vX):
                    # DataFrames stay intact: Dataset(reference=train_set)
                    # re-codes category dtypes against the training mapping
                    vX = np.asarray(getattr(vX, "values", vX), dtype=np.float64)
                vy = np.asarray(vy).ravel()
                same_X = vX is X or (not _is_sparse(vX) and not _is_dataframe(vX)
                                     and not _is_sparse(X) and not _is_dataframe(X)
                                     and vX.shape == X.shape
                                     and np.array_equal(vX, X))
                # the reference wrapper reuses the train set only when BOTH
                # X and y match (same X with held-out labels is a distinct
                # eval set); compare in encoded space, y is already encoded.
                # A caller-supplied eval weight/group also forces a real
                # eval Dataset — reusing train_set would drop them.
                vy_enc = np.asarray(self._prep_eval_label(vy)).ravel()
                vw = eval_sample_weight[i] if eval_sample_weight else None
                vg = eval_group[i] if eval_group else None
                if (same_X and np.array_equal(vy_enc, y)
                        and vw is None and vg is None):
                    valid_sets.append(train_set)
                else:
                    valid_sets.append(Dataset(vX, label=vy_enc,
                                              weight=vw, group=vg,
                                              reference=train_set))
                valid_names.append(eval_names[i] if eval_names else f"valid_{i}")

        if isinstance(init_model, LGBMModel):
            # reference sklearn wrapper: continued training accepts a
            # filename, a Booster, or another fitted estimator
            init_model = init_model.booster_

        self._evals_result = {}
        self._Booster = train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None, valid_names=valid_names or None,
            fobj=fobj, feval=feval, init_model=init_model,
            early_stopping_rounds=early_stopping_rounds,
            verbose_eval=verbose, evals_result=self._evals_result,
            callbacks=callbacks, device=self.device)
        self._best_iteration = self._Booster.best_iteration
        self.fitted_ = True
        return self

    def _prep_eval_label(self, y):
        return y

    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs):
        self._check_fitted()
        if not _is_sparse(X) and not _is_dataframe(X):
            X = np.asarray(getattr(X, "values", X), dtype=np.float64)
        if X.shape[1] != self._n_features:
            raise LightGBMError(
                f"Number of features of the model must match the input. Model "
                f"n_features_ is {self._n_features} and input n_features is {X.shape[1]}")
        ni = num_iteration if num_iteration is not None else (
            self._best_iteration if self._best_iteration > 0 else -1)
        return self._Booster.predict(X, raw_score=raw_score,
                                     start_iteration=start_iteration,
                                     num_iteration=ni, pred_leaf=pred_leaf,
                                     pred_contrib=pred_contrib, **kwargs)

    def _check_fitted(self):
        if self._Booster is None:
            raise LightGBMError("Estimator not fitted, call fit before exploiting the model.")

    # -- fitted attributes ---------------------------------------------
    @property
    def booster_(self) -> Booster:
        self._check_fitted()
        return self._Booster

    @property
    def evals_result_(self) -> Dict:
        self._check_fitted()
        return self._evals_result

    @property
    def best_iteration_(self) -> int:
        self._check_fitted()
        return self._best_iteration

    @property
    def best_score_(self) -> Dict:
        self._check_fitted()
        return self._Booster.best_score

    @property
    def n_features_(self) -> int:
        self._check_fitted()
        return self._n_features

    @property
    def n_features_in_(self) -> int:
        return self.n_features_

    @property
    def feature_importances_(self) -> np.ndarray:
        self._check_fitted()
        return self._Booster.feature_importance(importance_type=self.importance_type)

    @property
    def feature_name_(self) -> List[str]:
        self._check_fitted()
        return self._Booster.feature_name()

    @property
    def objective_(self):
        self._check_fitted()
        return self._objective if self._objective is not None else self._default_objective()

    def _default_objective(self) -> str:
        return "regression"

    def __sklearn_is_fitted__(self) -> bool:
        return self.fitted_


class LGBMRegressor(_SKLRegressorMixin, LGBMModel):
    """LightGBM regressor (reference ``sklearn.py:780``)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if self._objective is None:
            self._objective = "regression"

    def _default_objective(self):
        return "regression"

    def score(self, X, y, sample_weight=None):
        from sklearn.metrics import r2_score
        return r2_score(y, self.predict(X), sample_weight=sample_weight)


class LGBMClassifier(_SKLClassifierMixin, LGBMModel):
    """LightGBM classifier (reference ``sklearn.py:806``)."""

    def fit(self, X, y, **kwargs):
        y = np.asarray(y).ravel()
        self._classes = np.unique(y)
        self._n_classes = len(self._classes)
        self._class_map = {c: i for i, c in enumerate(self._classes)}
        y_enc = np.searchsorted(self._classes, y).astype(np.float64)
        self._resolve_classification_objective()
        return super().fit(X, y_enc, **kwargs)

    def _resolve_classification_objective(self) -> None:
        """Default/upgrade the objective from ``_n_classes`` (binary vs
        multiclass + ``num_class``).  ONE copy, shared with the
        distributed ``DistLGBMClassifier`` so the two fits cannot resolve
        the same data to different objectives."""
        if self._objective is None or (isinstance(self._objective, str)
                                       and self._objective in ("binary", "multiclass", "multiclassova")):
            if self._n_classes > 2:
                if not isinstance(self._objective, str) or self._objective == "binary":
                    self._objective = "multiclass"
                self._other_params["num_class"] = self._n_classes
            elif self._objective is None:
                self._objective = "binary"

    def _prep_eval_label(self, y):
        return np.searchsorted(self._classes, np.asarray(y).ravel()).astype(np.float64)

    def _default_objective(self):
        return "binary"

    def predict(self, X, raw_score: bool = False, **kwargs):
        result = self.predict_proba(X, raw_score=raw_score, **kwargs)
        if raw_score or kwargs.get("pred_leaf") or kwargs.get("pred_contrib"):
            return result
        if result.ndim > 1 and result.shape[1] > 1:
            return self._classes[np.argmax(result, axis=1)]
        return self._classes[(result > 0.5).astype(np.int64)]

    def predict_proba(self, X, raw_score: bool = False, **kwargs):
        self._check_fitted()
        result = super().predict(X, raw_score=raw_score, **kwargs)
        if raw_score or kwargs.get("pred_leaf") or kwargs.get("pred_contrib"):
            return result
        if result.ndim == 1:
            return np.vstack([1.0 - result, result]).T
        return result

    def score(self, X, y, sample_weight=None):
        from sklearn.metrics import accuracy_score
        return accuracy_score(y, self.predict(X), sample_weight=sample_weight)

    @property
    def classes_(self) -> np.ndarray:
        self._check_fitted()
        return self._classes

    @property
    def n_classes_(self) -> int:
        self._check_fitted()
        return self._n_classes


class LGBMRanker(LGBMModel):
    """LightGBM ranker (reference ``sklearn.py:958``)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if self._objective is None:
            self._objective = "lambdarank"

    def _default_objective(self):
        return "lambdarank"

    def fit(self, X, y, group=None, eval_set=None, eval_group=None, **kwargs):
        if group is None:
            raise LightGBMError("Should set group for ranking task")
        if eval_set is not None and eval_group is None:
            raise LightGBMError("Eval_group cannot be None when eval_set is not None")
        return super().fit(X, y, group=group, eval_set=eval_set,
                           eval_group=eval_group, **kwargs)
