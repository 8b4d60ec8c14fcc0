"""Python-facing core objects: ``Dataset`` and ``Booster``.

Port of the JAX package's ``basic.py``: lazy Dataset construction from
arrays, ``scipy.sparse``, pandas frames (category columns coded against the
training data's lists) or a data file (with its ``.weight``/``.query``/
``.init`` sidecars and role columns), reference alignment for validation
data, row subsets, field access, and the ``Booster``: training (``update``,
custom gradients), rollback, refit, parameter resets, evaluation, the
predict family (dense, sparse, frame or file input; leaves and TreeSHAP
contributions), model text IO, dumps and pickling.  A training set whose
bin matrix is over the out-of-core budget stays in host RAM and trains on
``stream.StreamGBDT``/``StreamGOSS``.  Every entry point takes
``device``: ``None`` means the CUDA card and raises ``NoCudaDeviceError``
without one; pass ``"cpu"`` to run the plain PyTorch path.  Multi-process
training (``set_network``) is not ported and raises ``NotPortedError``.
"""
from __future__ import annotations

import functools
import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from .config import Config
from .device import NotPortedError, resolve_device
from .io.dataset import (Dataset as _InnerDataset, _is_dataframe, _is_sparse,
                         _pandas_to_numpy, _require_pandas_mapping,
                         _sanitize_feature_names)
from .models import model_io
from .models.gbdt import GBDT, host_scores
from .utils.log import check, LightGBMError

__all__ = ["Dataset", "Booster", "LightGBMError"]


class Dataset:
    """Lazily-constructed dataset (reference ``basic.py:935``)."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 silent: bool = False,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List[int], List[str]] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True, device=None):
        # ``silent`` injects verbose=-1 unless the caller set a verbosity
        self.silent = silent
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        self.free_raw_data = free_raw_data
        self.device = device
        self._inner: Optional[_InnerDataset] = None
        self.used_indices: Optional[np.ndarray] = None
        # per-category-column category lists of a pandas frame (reference
        # pandas_categorical, basic.py:391); filled at construction
        self.pandas_categorical = None

    def construct(self, device=None) -> "Dataset":
        """Bin the data and place it on ``device`` (default: the one given
        at construction, else CUDA).  A dataset that streams
        (``stream_plan()``) keeps its bin matrix in host RAM."""
        dev = resolve_device(device if device is not None else self.device)
        self.device = dev
        if self._inner is None:
            self._inner = self._build_inner(dev)
        if self._inner.stream_plan() is None:
            self._inner.device_data(dev)
        return self

    def _build_inner(self, dev) -> _InnerDataset:
        if self.silent and not any(a in self.params for a in
                                   ("verbose", "verbosity")):
            self.params["verbose"] = -1
        cfg = Config.from_params(self.params)
        data = self.data
        if isinstance(data, str):
            data = self._load_file(data, cfg)
        ref_inner = (self.reference.construct(dev)._inner
                     if self.reference is not None else None)
        if _is_dataframe(data):
            ref_pc = (self.reference.pandas_categorical
                      if self.reference is not None else None)
            if self.reference is not None:
                # code a validation frame against the training lists
                _require_pandas_mapping(data, ref_pc, "validation DataFrame")
            data, df_names, cat_spec, self.pandas_categorical = \
                _pandas_to_numpy(data, self.categorical_feature, ref_pc)
            if self.feature_name == "auto":
                self.feature_name = df_names
            self.categorical_feature = cat_spec
        if self.used_indices is not None and ref_inner is not None:
            inner = ref_inner.subset(self.used_indices)
            if self.label is not None:
                label = np.asarray(self.label)
                inner.metadata.set_field(
                    "label", label[self.used_indices]
                    if len(label) != len(self.used_indices) else label)
            return inner
        feature_names = (None if self.feature_name == "auto"
                         else list(self.feature_name))
        cats = (None if self.categorical_feature == "auto"
                else self.categorical_feature)
        if cats is not None and feature_names is not None \
                and not isinstance(cats, str):
            cats = [feature_names.index(c) if isinstance(c, str) else c
                    for c in cats]
        return _InnerDataset.from_data(
            data, cfg, label=self.label, weight=self.weight,
            group=self.group, init_score=self.init_score,
            categorical_feature=cats, feature_names=feature_names,
            reference=ref_inner)

    def _load_file(self, path: str, cfg: Config):
        """A data file's matrix; its label, role columns, header names and
        sidecar files (reference ``Metadata::Init``, src/io/metadata.cpp:
        ``<data>.weight`` a weight a row, ``<data>.query`` the group sizes,
        ``<data>.init`` the init scores) fill what the caller left unset."""
        from .io.loader import load_file
        data, label, feat_names, fweight, fgroup = load_file(path, cfg)
        if self.label is None:
            self.label = label
        if self.weight is None and fweight is not None:
            self.weight = fweight
        if self.group is None and fgroup is not None:
            self.group = fgroup
        if self.feature_name == "auto" and feat_names:
            self.feature_name = feat_names
        if self.weight is None and os.path.exists(path + ".weight"):
            self.weight = np.loadtxt(path + ".weight", dtype=np.float64,
                                     ndmin=1)
        if self.group is None and os.path.exists(path + ".query"):
            self.group = np.loadtxt(path + ".query",
                                    dtype=np.int64).reshape(-1)
        if self.init_score is None and os.path.exists(path + ".init"):
            self.init_score = np.loadtxt(path + ".init", dtype=np.float64,
                                         ndmin=1)
        return data

    # ------------------------------------------------------------------
    def set_field(self, name: str, data) -> None:
        self.construct()
        self._inner.metadata.set_field(name, data)

    def get_field(self, name: str):
        self.construct()
        return self._inner.metadata.get_field(name)

    def _set_meta(self, name: str, value) -> None:
        setattr(self, name, value)
        if self._inner is not None:
            self._inner.metadata.set_field(name, value)

    def set_label(self, label) -> None:
        self._set_meta("label", label)

    def set_weight(self, weight) -> None:
        self._set_meta("weight", weight)

    def set_group(self, group) -> None:
        self._set_meta("group", group)

    def set_init_score(self, init_score) -> None:
        self._set_meta("init_score", init_score)

    def get_label(self):
        return self.get_field("label")

    def get_weight(self):
        return self.get_field("weight")

    def get_group(self):
        """Query sizes (None without query information)."""
        qb = self.get_field("group")
        return None if qb is None else np.diff(qb)

    def get_init_score(self):
        return self.get_field("init_score")

    def num_data(self) -> int:
        self.construct()
        return self._inner.num_data

    def num_feature(self) -> int:
        self.construct()
        return self._inner.num_total_features

    def get_feature_name(self) -> List[str]:
        self.construct()
        return list(self._inner.feature_names)

    # ------------------------------------------------------------------
    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, silent: bool = False,
                     params=None) -> "Dataset":
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score, silent=silent,
                       params=params or self.params, device=self.device)

    def subset(self, used_indices: Sequence[int], params=None) -> "Dataset":
        """Rows ``used_indices`` of this Dataset, binned by its mappers."""
        ds = Dataset(None, reference=self, params=params or self.params,
                     device=self.device)
        ds.used_indices = np.asarray(used_indices, dtype=np.int64)
        return ds

    def save_binary(self, filename: str) -> "Dataset":
        self.construct()
        self._inner.save_binary(filename)
        return self

    def get_data(self):
        """The raw data this Dataset was built from (None for a subset or a
        binary cache)."""
        return self.data

    def get_params(self) -> Dict[str, Any]:
        return dict(self.params)

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        if categorical_feature == self.categorical_feature:
            return self
        if self._inner is not None:
            if self.data is None:
                raise LightGBMError(
                    "Cannot set categorical feature after freed raw data; "
                    "set free_raw_data=False when constructing the Dataset")
            self._inner = None          # raw data held: re-bin lazily
        self.categorical_feature = categorical_feature
        return self

    def set_feature_name(self, feature_name) -> "Dataset":
        self.feature_name = feature_name
        if self._inner is not None:
            names = _sanitize_feature_names(list(feature_name))
            check(len(names) == self._inner.num_total_features,
                  "Length of feature names doesn't equal with num_feature")
            self._inner.feature_names = names
        return self

    def set_reference(self, reference: "Dataset") -> "Dataset":
        if self._inner is not None:
            raise LightGBMError(
                "Cannot set reference after the Dataset was constructed")
        self.reference = reference
        return self

    def get_ref_chain(self, ref_limit: int = 100):
        """Set of Datasets reachable through reference links."""
        head = self
        ref_chain = set()
        while len(ref_chain) < ref_limit and isinstance(head, Dataset):
            ref_chain.add(head)
            if head.reference is None or head.reference in ref_chain:
                break
            head = head.reference
        return ref_chain

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """Stack another Dataset's features onto this one column-wise
        (reference ``Dataset::AddFeaturesFrom``).  Both must hold in-memory
        raw data with equal rows; the merged Dataset re-bins lazily."""
        if (self.data is None or other.data is None
                or isinstance(self.data, str) or isinstance(other.data, str)):
            raise LightGBMError(
                "Cannot add features from a Dataset without in-memory raw "
                "data (file-backed or freed Datasets are not mergeable)")
        a, b = self.data, other.data
        if hasattr(a, "values"):
            a = a.values
        if hasattr(b, "values"):
            b = b.values
        check(a.shape[0] == b.shape[0], "Datasets must have equal rows")
        width_a = a.shape[1]
        if _is_sparse(a) or _is_sparse(b):
            import scipy.sparse as sps
            merged = sps.hstack([sps.csr_matrix(a), sps.csr_matrix(b)],
                                format="csr")
        else:
            merged = np.concatenate([np.asarray(a, np.float64),
                                     np.asarray(b, np.float64)], axis=1)
        self.data = merged
        if (isinstance(self.feature_name, list)
                and isinstance(other.feature_name, list)):
            self.feature_name = list(self.feature_name) + list(other.feature_name)
        # the other's categorical indices shift by this Dataset's width;
        # names ride the feature_name merge
        oc = other.categorical_feature
        if oc != "auto" and oc:
            shifted = [c + width_a if isinstance(c, (int, np.integer)) else c
                       for c in oc]
            mine = ([] if self.categorical_feature == "auto"
                    else list(self.categorical_feature))
            self.categorical_feature = mine + shifted
        self._inner = None
        return self

    def num_bins_total(self) -> int:
        self.construct()
        return int(sum(self._inner.num_bin(i)
                       for i in range(self._inner.num_features)))


# dataset parameters are baked into the bin matrix: reset_parameter refuses
# them once the training Dataset exists (reference ResetConfig)
_DATASET_PARAMS = frozenset({
    "max_bin", "max_bin_by_feature", "min_data_in_bin",
    "bin_construct_sample_cnt", "data_random_seed", "use_missing",
    "zero_as_missing", "feature_pre_filter", "enable_bundle",
    "categorical_feature", "linear_tree", "pre_partition",
})


class Booster:
    """Training/prediction handle (reference ``basic.py:2043``)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None,
                 silent: bool = False, device=None):
        self.params = dict(params or {})
        self.silent = silent
        if silent and not any(a in self.params for a in
                              ("verbose", "verbosity")):
            self.params["verbose"] = -1
        self.device = resolve_device(device)
        self.train_set = train_set
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self.name_valid_sets: List[str] = []
        self.valid_sets_py: List[Dataset] = []
        self.pandas_categorical = None
        self._attr: Dict[str, str] = {}
        if train_set is not None:
            check(isinstance(train_set, Dataset), "training data should be Dataset instance")
            cfg = Config.from_params(self.params)
            train_set.params = dict(self.params)
            train_set.construct(self.device)
            self.pandas_categorical = train_set.pandas_categorical
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
        ``Booster._create_engine``): when the training set's bin matrix is
        over the out-of-core budget, or ``stream_rows`` forces it, the
        streaming engines train from host RAM in row blocks."""
        if inner_train.stream_plan() is not None:
            from .stream.booster import StreamGBDT, StreamGOSS
            scls = {"gbdt": StreamGBDT, "goss": StreamGOSS}.get(cfg.boosting)
            if scls is None:
                raise LightGBMError(
                    "out-of-core streaming supports boosting=gbdt/goss "
                    f"(got {cfg.boosting}); raise max_bin_matrix_bytes or "
                    "unset stream_rows to train device-resident")
            return scls(cfg, inner_train, device=device)
        from .models.dart import DART
        from .models.goss import GOSS
        from .models.rf import RF
        cls = {"gbdt": GBDT, "dart": DART, "goss": GOSS, "rf": RF}[cfg.boosting]
        return cls(cfg, inner_train, device=device)

    def _load_from_string(self, model_str: str) -> None:
        self._gbdt = model_io.load_model_from_string(
            model_str, functools.partial(GBDT, device=self.device))
        self.name_valid_sets = []
        self.valid_sets_py = []
        self.pandas_categorical = model_io.parse_pandas_categorical(model_str)

    # ------------------------------------------------------------------
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        data.params = dict(self.params)
        data.construct(self.device)
        self._gbdt.add_valid_data(data._inner, name)
        self.name_valid_sets.append(name)
        self.valid_sets_py.append(data)
        return self

    def update(self, train_set: Optional[Dataset] = None, fobj=None) -> bool:
        """One boosting iteration; returns True if stopped (no splits)
        (reference ``Booster.update``, ``basic.py:2448``).  ``fobj(score,
        train_set)`` gives the gradients and hessians (host arrays)."""
        if train_set is not None:
            raise LightGBMError("resetting train_set after construction is not supported yet")
        if fobj is not None:
            grad, hess = fobj(self._inner_raw_score(), self.train_set)
            return self._gbdt.train_one_iter(np.asarray(grad),
                                             np.asarray(hess))
        return self._gbdt.train_one_iter()

    def _inner_raw_score(self) -> np.ndarray:
        s = host_scores(self._gbdt._train_score)
        return s[0] if self._gbdt.num_tree_per_iteration == 1 else s.T.reshape(-1)

    def rollback_one_iter(self) -> "Booster":
        self._gbdt.rollback_one_iter()
        return self

    def refit(self, data, label, decay_rate: float = 0.9) -> "Booster":
        """Refit the trees' leaf values on new data (reference
        ``Booster.refit``; ``GBDT::RefitTree``)."""
        self._gbdt.refit(np.asarray(data, np.float64), label, decay_rate)
        return self

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """Re-apply training parameters mid-run (reference
        ``Booster.reset_parameter`` -> ``GBDT::ResetConfig``).  A grower
        parameter (num_leaves, min_data_in_leaf, ...) rebuilds the grower's
        configuration; dataset parameters are refused once the training
        data is binned."""
        bad = sorted(_DATASET_PARAMS
                     & {Config.resolve_alias(str(k)) for k in params})
        gbdt = self._gbdt
        if bad and gbdt.train_data is not None:
            raise LightGBMError(
                "Cannot change dataset parameters %s after the Dataset was "
                "constructed; rebuild the Dataset instead" % bad)
        self.params.update(params)
        gbdt.config.update(params)
        gbdt.config.finalize()
        if "learning_rate" in params:
            gbdt.shrinkage_rate = float(gbdt.config.learning_rate)
        if gbdt.train_data is not None:
            gbdt._grower_cfg = gbdt._make_grower_cfg()
        return self

    def attr(self, key: str):
        """A free-form attribute (reference ``Booster.attr``)."""
        return self._attr.get(key)

    def set_attr(self, **kwargs) -> "Booster":
        """Set (or with value None, delete) free-form attributes."""
        for k, v in kwargs.items():
            if v is None:
                self._attr.pop(k, None)
            else:
                self._attr[k] = str(v)
        return self

    def lower_bound(self) -> float:
        """Sum of the trees' least leaf values (reference
        ``LGBM_BoosterGetLowerBoundValue``)."""
        return float(sum(float(np.min(t.leaf_value)) if len(t.leaf_value)
                         else 0.0 for t in self._gbdt.models))

    def upper_bound(self) -> float:
        """Sum of the trees' greatest leaf values."""
        return float(sum(float(np.max(t.leaf_value)) if len(t.leaf_value)
                         else 0.0 for t in self._gbdt.models))

    def model_from_string(self, model_str: str) -> "Booster":
        """Replace this booster's model in place."""
        self._load_from_string(model_str)
        return self

    def shuffle_models(self, start_iteration: int = 0,
                       end_iteration: int = -1) -> "Booster":
        """Shuffle the order of iterations [start, end) (reference
        ``GBDT::ShuffleModels``), with the device trees and their weights."""
        gbdt = self._gbdt
        K = gbdt.num_tree_per_iteration
        models = list(gbdt.models)
        n_iters = len(models) // K
        end = n_iters if end_iteration <= 0 else min(end_iteration, n_iters)
        start = max(0, start_iteration)
        if start >= end:
            raise LightGBMError(
                f"shuffle_models: empty range [{start}, {end})")
        rng = np.random.default_rng(gbdt.config.seed)
        order = np.arange(start, end)
        rng.shuffle(order)

        def shuffle_list(lst):
            blocks = [lst[i * K:(i + 1) * K] for i in range(n_iters)]
            out = blocks[:start] + [blocks[i] for i in order] + blocks[end:]
            return [t for blk in out for t in blk]

        same_len = len(gbdt._device_trees) == len(models)
        gbdt.models = shuffle_list(models)
        if same_len:
            gbdt._device_trees = shuffle_list(gbdt._device_trees)
            gbdt._tree_depths = shuffle_list(gbdt._tree_depths)
            gbdt._tree_weights = shuffle_list(gbdt._tree_weights)
        gbdt._ens_cache = None
        return self

    def set_train_data_name(self, name: str) -> "Booster":
        self._train_data_name = name
        self._gbdt.train_data_name = name
        return self

    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        return float(self._gbdt.models[tree_id].leaf_value[leaf_id])

    # -- pickling through the model text, like the reference -------------
    def __getstate__(self):
        return {"params": self.params,
                "best_iteration": self.best_iteration,
                "best_score": self.best_score,
                "device": str(self.device),
                # every tree: the default would cut an early-stopped model
                # at best_iteration
                "model_str": self.model_to_string(num_iteration=-1)}

    def __setstate__(self, state):
        self.params = state["params"]
        self.best_iteration = state["best_iteration"]
        self.best_score = state["best_score"]
        self.device = resolve_device(state["device"])
        self.train_set = None
        self._attr = {}
        self._load_from_string(state["model_str"])

    def set_network(self, machines, local_listen_port: int = 12400,
                    listen_time_out: int = 120,
                    num_machines: Optional[int] = None) -> "Booster":
        raise NotPortedError("multi-process training (set_network) is not "
                             "ported yet")

    def free_network(self) -> "Booster":
        raise NotPortedError("multi-process training (free_network) is not "
                             "ported yet")

    def free_dataset(self) -> "Booster":
        """Drop the python-side Dataset references; the engine keeps its
        binned copy, so training and prediction go on (a custom
        ``fobj``/``feval`` then sees ``None``)."""
        self.train_set = None
        self.valid_sets_py = []
        return self

    def current_iteration(self) -> int:
        return self._gbdt.iter_

    def num_trees(self) -> int:
        return self._gbdt.num_trees

    def num_model_per_iteration(self) -> int:
        return self._gbdt.num_tree_per_iteration

    def num_feature(self) -> int:
        return self._gbdt.max_feature_idx + 1

    # ------------------------------------------------------------------
    def eval_train(self, feval=None):
        return self._eval_set(
            getattr(self, "_train_data_name", "training"), -1, feval)

    def eval_valid(self, feval=None):
        out = []
        for i in range(len(self.name_valid_sets)):
            out.extend(self._eval_set(self.name_valid_sets[i], i, feval))
        return out

    def eval(self, data=None, name="eval", feval=None):
        return list(self._gbdt.eval_current())

    def _eval_set(self, name, idx, feval):
        gb = self._gbdt
        out = []
        if idx < 0:
            # training metrics on demand (a loaded model has none)
            if getattr(gb, "train_metrics", None) and gb._train_score is not None:
                score = host_scores(gb._train_score)
                s = score[0] if gb.num_tree_per_iteration == 1 else score
                for m in gb.train_metrics:
                    for mname, val, hib in m.eval(s, gb.objective):
                        out.append((name, mname, val, hib))
        else:
            out = [r for r in gb.eval_current() if r[0] == name]
        out.extend(self._feval_results(name, idx, feval))
        return out

    def _feval_results(self, name, idx, feval):
        """feval's rows for one eval set (idx -1: training), without the
        builtin metrics."""
        if feval is None:
            return []
        if idx < 0:
            if self._gbdt._train_score is None:
                return []
            score = host_scores(self._gbdt._train_score)
            dataset = self.train_set
        else:
            score = host_scores(self._gbdt._valid_scores[idx])
            dataset = (self.valid_sets_py[idx] if self.valid_sets_py
                       else None)
        s = score[0] if self._gbdt.num_tree_per_iteration == 1 else score
        res = feval(s, dataset)
        if isinstance(res, tuple):
            res = [res]
        return [(name, mname, val, hib) for mname, val, hib in res]

    # ------------------------------------------------------------------
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs) -> np.ndarray:
        """Predictions for a matrix, a ``scipy.sparse`` matrix, a pandas
        frame or a data file.  ``pred_contrib`` gives TreeSHAP
        contributions ``[n, F + 1]`` a class; sparse input gives sparse
        output in its own format."""
        if num_iteration is None:
            num_iteration = self.best_iteration
        if isinstance(data, str):
            from .io.loader import detect_file_format, load_file
            fmt = detect_file_format(data)
            data = load_file(data, Config.from_params(
                dict(self.params or {}, **kwargs)))[0]
            if (fmt == "libsvm" and data.ndim == 2
                    and data.shape[1] < self.num_feature()):
                # a LibSVM file's width is its greatest index seen, so
                # trailing all-zero features may be absent; dense formats
                # keep the shape check
                data = np.pad(data,
                              ((0, 0),
                               (0, self.num_feature() - data.shape[1])))
        if _is_dataframe(data):
            _require_pandas_mapping(data, self.pandas_categorical,
                                    "prediction DataFrame")
            # category columns coded against the training lists
            data = _pandas_to_numpy(data, "auto", self.pandas_categorical)[0]
        elif hasattr(data, "values"):
            data = data.values
        in_fmt = getattr(data, "format", None) if _is_sparse(data) else None
        data = (data.tocsr() if in_fmt is not None
                else np.asarray(data, dtype=np.float64))
        n_feat = self.num_feature()
        data_feat = data.shape[1] if data.ndim == 2 else data.shape[0]
        if data_feat != n_feat and not kwargs.get("predict_disable_shape_check", False):
            raise LightGBMError(
                f"The number of features in data ({data_feat}) is not the same "
                f"as it was in training data ({n_feat}).\n"
                "You can set ``predict_disable_shape_check=true`` to discard this error")
        if pred_leaf:
            return self._gbdt.predict_leaf_index(data, num_iteration)
        if pred_contrib:
            return self._gbdt.predict_contrib(
                data, num_iteration, start_iteration,
                sparse=in_fmt is not None, sparse_format=in_fmt)
        return self._gbdt.predict(data, num_iteration, start_iteration,
                                  raw_score)

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
        # the trailing pandas_categorical line of the reference python
        # package (basic.py _dump_pandas_categorical:445)
        return text + model_io.format_pandas_categorical(
            self.pandas_categorical)

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> dict:
        g = self._gbdt
        return {
            "name": "tree",
            "version": "v3",
            "num_class": g.num_class,
            "num_tree_per_iteration": g.num_tree_per_iteration,
            "label_index": 0,
            "max_feature_idx": g.max_feature_idx,
            "objective": g.config.objective,
            "feature_names": (g.train_data.feature_names if g.train_data else []),
            "pandas_categorical": self.pandas_categorical,
            "tree_info": [dict(tree_index=i, **t.to_json())
                          for i, t in enumerate(g.models)],
        }

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        return self._gbdt.feature_importance(importance_type, iteration or -1)

    def feature_name(self) -> List[str]:
        if self._gbdt.train_data is not None:
            return list(self._gbdt.train_data.feature_names)
        return list(getattr(self._gbdt, "feature_names_", []))

    def get_split_value_histogram(self, feature, bins=None,
                                  xgboost_style: bool = False):
        """Histogram of a feature's numerical split thresholds across the
        model (reference ``basic.py:3164``)."""
        if isinstance(feature, str):
            names = self.feature_name()
            if feature not in names:
                raise LightGBMError(f"Unknown feature name {feature!r}")
            feature = names.index(feature)
        values = np.array([float(t.threshold[j]) for t in self._gbdt.models
                           for j in range(t.num_internal)
                           if int(t.split_feature[j]) == feature
                           and not t.is_categorical_split(j)],
                          dtype=np.float64)
        n_unique = len(np.unique(values))
        if bins is None or (isinstance(bins, int) and bins > n_unique):
            bins = max(n_unique, 1)
        hist, bin_edges = np.histogram(values, bins=bins)
        if xgboost_style:
            ret = np.column_stack((bin_edges[1:], hist))
            ret = ret[ret[:, 1] > 0]
            try:
                import pandas as pd
                return pd.DataFrame(ret, columns=["SplitValue", "Count"])
            except ImportError:
                return ret
        return hist, bin_edges

    def trees_to_dataframe(self):
        """One row per node (reference ``basic.py:2245``)."""
        import pandas as pd
        if self.num_trees() == 0:
            raise LightGBMError("There are no trees in this Booster and thus nothing to parse")
        names = self.feature_name()

        def child_name(tree_index, c):
            return (f"{tree_index}-S{c['split_index']}" if "split_index" in c
                    else f"{tree_index}-L{c['leaf_index']}")

        def node_rows(tree_index, node, depth, parent):
            if "split_index" in node:
                name = f"{tree_index}-S{node['split_index']}"
                feat_idx = node["split_feature"]
                left, right = node["left_child"], node["right_child"]
                rows = [{
                    "tree_index": tree_index, "node_depth": depth,
                    "node_index": name,
                    "left_child": child_name(tree_index, left),
                    "right_child": child_name(tree_index, right),
                    "parent_index": parent,
                    "split_feature": (names[feat_idx] if feat_idx < len(names)
                                      else f"Column_{feat_idx}"),
                    "split_gain": node["split_gain"],
                    "threshold": node["threshold"],
                    "decision_type": node["decision_type"],
                    "missing_direction": ("left" if node["default_left"]
                                          else "right"),
                    "missing_type": node["missing_type"],
                    "value": node["internal_value"], "weight": None,
                    "count": node["internal_count"]}]
                rows += node_rows(tree_index, left, depth + 1, name)
                rows += node_rows(tree_index, right, depth + 1, name)
                return rows
            return [{
                "tree_index": tree_index, "node_depth": depth,
                "node_index": f"{tree_index}-L{node.get('leaf_index', 0)}",
                "left_child": None, "right_child": None,
                "parent_index": parent, "split_feature": None,
                "split_gain": None, "threshold": None, "decision_type": None,
                "missing_direction": None, "missing_type": None,
                "value": node["leaf_value"],
                "weight": node.get("leaf_weight"),
                "count": node.get("leaf_count", 0)}]

        rows = []
        for ti in self.dump_model()["tree_info"]:
            rows += node_rows(ti["tree_index"], ti["tree_structure"], 1, None)
        return pd.DataFrame(rows, columns=[
            "tree_index", "node_depth", "node_index", "left_child",
            "right_child", "parent_index", "split_feature", "split_gain",
            "threshold", "decision_type", "missing_direction", "missing_type",
            "value", "weight", "count"])
