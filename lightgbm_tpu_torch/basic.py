"""Python-facing core objects: ``Dataset`` and ``Booster``.

Port of the main-path surface of the JAX package's ``basic.py``: lazy
Dataset construction with reference alignment for validation data, field
access (query groups included), ``Booster`` training (``update``),
evaluation, prediction (dense or ``scipy.sparse`` input) and model text IO (``save_model``, ``model_to_string``, loading from ``model_file`` /
``model_str``).  Every entry point takes ``device``: ``None`` means the CUDA
card and raises ``NoCudaDeviceError`` without one; pass ``"cpu"`` to run the
plain PyTorch path.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Union

import numpy as np

from .config import Config
from .device import NotPortedError, resolve_device
from .io.dataset import Dataset as _InnerDataset, _is_dataframe
from .models import model_io
from .models.gbdt import GBDT
from .utils.log import check, LightGBMError

__all__ = ["Dataset", "Booster", "LightGBMError"]

# rows of a densified block when predicting scipy.sparse input
_SPARSE_PREDICT_BLOCK = 65536


class Dataset:
    """Lazily-constructed dataset (reference ``basic.py:935``)."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List[int], List[str]] = "auto",
                 params: Optional[Dict[str, Any]] = None, device=None):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        self.device = device
        self._inner: Optional[_InnerDataset] = None

    def construct(self, device=None) -> "Dataset":
        """Bin the data and place it on ``device`` (default: the one given
        at construction, else CUDA)."""
        dev = resolve_device(device if device is not None else self.device)
        self.device = dev
        if self._inner is None:
            if isinstance(self.data, str):
                raise NotPortedError("loading data files is not ported yet")
            cfg = Config.from_params(self.params)
            # a DataFrame names its features by its columns (the JAX
            # package's _pandas_to_numpy), and categorical features given
            # by name resolve against those names
            if self.feature_name == "auto" and _is_dataframe(self.data):
                self.feature_name = [str(c) for c in self.data.columns]
            feature_names = (None if self.feature_name == "auto"
                             else list(self.feature_name))
            cats = (None if self.categorical_feature == "auto"
                    else self.categorical_feature)
            if cats is not None and feature_names is not None \
                    and not isinstance(cats, str):
                cats = [feature_names.index(c) if isinstance(c, str) else c
                        for c in cats]
            ref_inner = (self.reference.construct(dev)._inner
                         if self.reference is not None else None)
            self._inner = _InnerDataset.from_data(
                self.data, cfg, label=self.label, weight=self.weight,
                group=self.group, init_score=self.init_score,
                categorical_feature=cats, feature_names=feature_names,
                reference=ref_inner)
        self._inner.device_data(dev)
        return self

    # ------------------------------------------------------------------
    def set_field(self, name: str, data) -> None:
        self.construct()
        self._inner.metadata.set_field(name, data)

    def get_field(self, name: str):
        self.construct()
        return self._inner.metadata.get_field(name)

    def get_label(self):
        return self.get_field("label")

    def set_group(self, group) -> None:
        self.group = group
        if self._inner is not None:
            self._inner.metadata.set_field("group", group)

    def get_group(self):
        """Query sizes (None without query information)."""
        qb = self.get_field("group")
        return None if qb is None else np.diff(qb)

    def num_data(self) -> int:
        self.construct()
        return self._inner.num_data

    def num_feature(self) -> int:
        self.construct()
        return self._inner.num_total_features

    def save_binary(self, filename: str) -> "Dataset":
        self.construct()
        self._inner.save_binary(filename)
        return self

    def subset(self, used_indices, params=None) -> "Dataset":
        raise NotPortedError("Dataset.subset is not ported yet")

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params, device=self.device)


class Booster:
    """Training/prediction handle (reference ``basic.py:2043``)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None, device=None):
        self.params = dict(params or {})
        self.device = resolve_device(device)
        self.train_set = train_set
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self.name_valid_sets: List[str] = []
        if train_set is not None:
            check(isinstance(train_set, Dataset), "training data should be Dataset instance")
            cfg = Config.from_params(self.params)
            train_set.params = dict(self.params)
            train_set.construct(self.device)
            self._gbdt = self._create_engine(cfg, train_set._inner,
                                             self.device)
        elif model_file is not None:
            with open(model_file) as f:
                self._load_from_string(f.read())
        elif model_str is not None:
            self._load_from_string(model_str)
        else:
            raise LightGBMError("need at least one of train_set / model_file / model_str")

    @staticmethod
    def _create_engine(cfg: Config, inner_train, device):
        """The boosting class by ``boosting`` (the JAX package's
        ``Booster._create_engine``, without its out-of-core routing)."""
        from .models.dart import DART
        from .models.goss import GOSS
        from .models.rf import RF
        cls = {"gbdt": GBDT, "dart": DART, "goss": GOSS, "rf": RF}[cfg.boosting]
        return cls(cfg, inner_train, device=device)

    def _load_from_string(self, model_str: str) -> None:
        if model_io.parse_pandas_categorical(model_str):
            raise NotPortedError("pandas categorical models are not ported yet")
        self._gbdt = model_io.load_model_from_string(
            model_str, functools.partial(GBDT, device=self.device))

    # ------------------------------------------------------------------
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        data.params = dict(self.params)
        data.construct(self.device)
        self._gbdt.add_valid_data(data._inner, name)
        self.name_valid_sets.append(name)
        return self

    def update(self) -> bool:
        """One boosting iteration; returns True if stopped (no splits)
        (reference ``Booster.update``, ``basic.py:2448``)."""
        return self._gbdt.train_one_iter()

    def set_train_data_name(self, name: str) -> "Booster":
        self._gbdt.train_data_name = name
        return self

    def current_iteration(self) -> int:
        return self._gbdt.iter_

    def num_trees(self) -> int:
        return self._gbdt.num_trees

    def num_model_per_iteration(self) -> int:
        return self._gbdt.num_tree_per_iteration

    def num_feature(self) -> int:
        return self._gbdt.max_feature_idx + 1

    def eval_valid(self):
        return [r for r in self._gbdt.eval_current()
                if r[0] in self.name_valid_sets]

    # ------------------------------------------------------------------
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                **kwargs) -> np.ndarray:
        if num_iteration is None:
            num_iteration = self.best_iteration
        if hasattr(data, "values"):
            data = data.values
        sparse = hasattr(data, "tocsr") and hasattr(data, "nnz")
        data = data.tocsr() if sparse else np.asarray(data, dtype=np.float64)
        n_feat = self.num_feature()
        data_feat = data.shape[1] if data.ndim == 2 else data.shape[0]
        if data_feat != n_feat and not kwargs.get("predict_disable_shape_check", False):
            raise LightGBMError(
                f"The number of features in data ({data_feat}) is not the same "
                f"as it was in training data ({n_feat}).\n"
                "You can set ``predict_disable_shape_check=true`` to discard this error")
        if pred_leaf:
            fn = functools.partial(self._gbdt.predict_leaf_index,
                                   num_iteration=num_iteration)
        else:
            fn = functools.partial(self._gbdt.predict,
                                   num_iteration=num_iteration,
                                   start_iteration=start_iteration,
                                   raw_score=raw_score)
        if sparse:
            # densified row blocks, as the JAX package predicts sparse input
            return np.concatenate([
                fn(np.asarray(data[s:s + _SPARSE_PREDICT_BLOCK].toarray(),
                              np.float64))
                for s in range(0, data.shape[0], _SPARSE_PREDICT_BLOCK)])
        return fn(data)

    # ------------------------------------------------------------------
    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: Optional[str] = None) -> "Booster":
        with open(filename, "w") as f:
            f.write(self.model_to_string(num_iteration, start_iteration, importance_type))
        return self

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0,
                        importance_type: Optional[str] = None) -> str:
        if importance_type is None:
            importance_type = ("gain" if int(self.params.get(
                "saved_feature_importance_type", 0)) == 1 else "split")
        if num_iteration is None:
            num_iteration = self.best_iteration      # reference default
        text = model_io.save_model_to_string(
            self._gbdt, num_iteration, start_iteration,
            1 if importance_type == "gain" else 0)
        # the same trailing pandas_categorical line as the JAX package
        return text + model_io.format_pandas_categorical(None)

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        return self._gbdt.feature_importance(importance_type, iteration or -1)

    def feature_name(self) -> List[str]:
        if self._gbdt.train_data is not None:
            return list(self._gbdt.train_data.feature_names)
        return list(getattr(self._gbdt, "feature_names_", []))
