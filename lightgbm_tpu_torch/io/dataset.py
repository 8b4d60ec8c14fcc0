"""Dataset: binned feature matrix + metadata, resident on the device.

Port of the dense path of the JAX package's ``io/dataset.py``: per-feature
bin mappers from a row sample, real<->inner feature maps with trivial
features dropped, label/weight/init-score metadata, validation sets aligned
to the training set's bin mappers.  The bin matrix is byte-identical to the
JAX package's (same sampler, same ``BinMapper.value_to_bin``).

Not ported yet (each raises ``NotPortedError``): sparse input, categorical
features, a u16 bin matrix (more than 256 bins in a feature), EFB bundles,
binary cache files and out-of-core streaming.  Dense Higgs-shaped data forms
no EFB bundle; the bundle search below runs only to detect one and refuse.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..device import NotPortedError, resolve_device
from ..utils.log import Log, check, LightGBMError
from ..utils.random_gen import Random
from .bin import BinMapper, BinType, MissingType
from .efb import MAX_BUNDLE_BINS, find_bundles


class Metadata:
    """Label / weight / query-boundary / init-score store (reference
    ``dataset.h:41``, ``src/io/metadata.cpp``)."""

    def __init__(self, num_data: int = 0) -> None:
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None  # [num_queries+1]
        self.init_score: Optional[np.ndarray] = None

    def set_field(self, name: str, data) -> None:
        if data is None:
            setattr(self, {"label": "label", "weight": "weight", "group": "query_boundaries",
                           "query": "query_boundaries", "init_score": "init_score"}[name], None)
            return
        arr = np.asarray(data)
        if name == "label":
            check(len(arr) == self.num_data, "label length mismatch")
            self.label = arr.astype(np.float32).ravel()
        elif name == "weight":
            check(len(arr) == self.num_data, "weight length mismatch")
            self.weight = arr.astype(np.float32).ravel()
        elif name in ("group", "query"):
            sizes = arr.astype(np.int64).ravel()
            if sizes.sum() == self.num_data:      # group sizes
                self.query_boundaries = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
            elif len(sizes) and sizes[0] == 0 and sizes[-1] == self.num_data:  # boundaries
                self.query_boundaries = sizes
            else:
                raise LightGBMError("group sizes do not sum to num_data")
        elif name == "init_score":
            check(len(arr) % self.num_data == 0, "init_score length mismatch")
            self.init_score = arr.astype(np.float64).ravel()
        else:
            raise LightGBMError(f"unknown field {name}")

    def get_field(self, name: str):
        return {"label": self.label, "weight": self.weight,
                "group": self.query_boundaries, "query": self.query_boundaries,
                "init_score": self.init_score}[name]

    @property
    def num_queries(self) -> int:
        return 0 if self.query_boundaries is None else len(self.query_boundaries) - 1


@dataclass
class DeviceData:
    """Device-resident tensors consumed by the tree learner."""
    bins: Any            # [num_data, num_features] uint8
    num_bins: Any        # [num_features] int32 — bins per feature
    bin_offsets: Any     # [num_features+1] int32 — flattened histogram offsets
    default_bins: Any    # [num_features] int32 — bin containing raw value 0
    nan_bins: Any        # [num_features] int32 — MISSING bin: trailing NaN
    #                      bin (NAN type), zero bin (ZERO type), or -1
    is_categorical: Any  # [num_features] bool
    monotone: Any        # [num_features] int8 (-1/0/+1)
    total_bins: int
    device: torch.device = torch.device("cpu")


class Dataset:
    """Binned training/validation data (construction analog of
    ``DatasetLoader::ConstructFromSampleData``, ``src/io/dataset_loader.cpp:618``)."""

    def __init__(self, config: Optional[Config] = None) -> None:
        self.config = config or Config()
        self.num_data: int = 0
        self.num_total_features: int = 0
        self.bin_mappers: List[BinMapper] = []          # per real feature
        self.used_features: List[int] = []              # inner -> real feature idx
        self.real_to_inner: Dict[int, int] = {}
        self.bins: Optional[np.ndarray] = None          # [num_data, num_used] u8
        self.metadata = Metadata()
        self.feature_names: List[str] = []
        self.reference: Optional["Dataset"] = None
        self._device: Dict[torch.device, DeviceData] = {}

    # ------------------------------------------------------------------
    @property
    def num_features(self) -> int:
        return len(self.used_features)

    def num_bin(self, inner_feature: int) -> int:
        return self.bin_mappers[self.used_features[inner_feature]].num_bin

    # ------------------------------------------------------------------
    @classmethod
    def from_data(cls, data: np.ndarray, config: Optional[Config] = None,
                  label=None, weight=None, group=None, init_score=None,
                  categorical_feature: Optional[Sequence[int]] = None,
                  feature_names: Optional[Sequence[str]] = None,
                  reference: Optional["Dataset"] = None) -> "Dataset":
        """Construct from a raw dense row-major matrix (the
        ``LGBM_DatasetCreateFromMat`` path, ``src/c_api.cpp``)."""
        config = config or Config()
        if hasattr(data, "tocsr") and hasattr(data, "nnz"):
            raise NotPortedError("sparse input is not ported yet (dense only)")
        if config.linear_tree:
            raise NotPortedError("linear_tree is not ported yet")
        if config.stream_rows or config.max_bin_matrix_bytes:
            raise NotPortedError("out-of-core streaming is not ported yet")
        self = cls(config)
        data = _to_2d_float(data)
        self.num_data, self.num_total_features = data.shape
        self.feature_names = _sanitize_feature_names(
            list(feature_names)) if feature_names else [
            f"Column_{i}" for i in range(self.num_total_features)]

        if reference is not None:
            # validation set: align bins with the training set
            # (reference LoadFromFileAlignWithOtherDataset, dataset_loader.cpp:260)
            check(self.num_total_features == reference.num_total_features,
                  "validation data has different number of features")
            self.reference = reference
            self.bin_mappers = reference.bin_mappers
            self.used_features = reference.used_features
            self.real_to_inner = reference.real_to_inner
        else:
            cats = set(_resolve_categorical(categorical_feature, self.feature_names, config))
            if cats:
                raise NotPortedError(
                    "categorical features are not ported yet (got %s)"
                    % sorted(cats))
            self._construct_bin_mappers(data)

        self._bin_data(data)
        if reference is None:
            self._check_no_bundles()
        md = Metadata(self.num_data)
        self.metadata = md
        if label is not None:
            md.set_field("label", label)
        if weight is not None:
            md.set_field("weight", weight)
        if group is not None:
            md.set_field("group", group)
        if init_score is not None:
            md.set_field("init_score", init_score)
        return self

    # ------------------------------------------------------------------
    def _construct_bin_mappers(self, data) -> None:
        cfg = self.config
        n = self.num_data
        # row sampling for bin construction (reference bin_construct_sample_cnt,
        # dataset_loader.cpp SampleTextDataFromFile:902)
        sample_cnt = min(n, cfg.bin_construct_sample_cnt)
        rng = Random(cfg.data_random_seed)
        sample_idx = rng.sample(n, sample_cnt)
        sample = data[sample_idx]
        self.bin_mappers = [self._find_bin_one(f, sample[:, f], sample_cnt)
                            for f in range(self.num_total_features)]
        self._finalize_used_features()

    def _find_bin_one(self, f: int, values: np.ndarray,
                      sample_cnt: int) -> BinMapper:
        """Config-resolved numerical ``BinMapper.find_bin`` for one feature."""
        cfg = self.config
        if cfg.forcedbins_filename:
            raise NotPortedError("forcedbins_filename is not ported yet")
        mbf = cfg.max_bin_by_feature
        fb = mbf[f] if f < len(mbf) else cfg.max_bin
        return BinMapper.find_bin(
            values, sample_cnt, fb, cfg.min_data_in_bin,
            cfg.min_data_in_leaf, cfg.feature_pre_filter,
            bin_type=BinType.NUMERICAL,
            use_missing=cfg.use_missing, zero_as_missing=cfg.zero_as_missing,
            forced_upper_bounds=None)

    def _finalize_used_features(self) -> None:
        self.used_features = [f for f, m in enumerate(self.bin_mappers)
                              if not m.is_trivial]
        if not self.used_features:
            Log.warning("There are no meaningful features, as all feature values are constant.")
        self.real_to_inner = {f: i for i, f in enumerate(self.used_features)}

    def _bin_data(self, data: np.ndarray) -> None:
        max_nb = max((self.bin_mappers[f].num_bin for f in self.used_features), default=1)
        if max_nb > 256:
            raise NotPortedError(
                "a feature with %d bins needs the u16 bin matrix, which is "
                "not ported yet (max_bin <= 255)" % max_nb)
        bins = np.empty((self.num_data, len(self.used_features)), dtype=np.uint8)
        for i, f in enumerate(self.used_features):
            bins[:, i] = self.bin_mappers[f].value_to_bin(data[:, f]).astype(np.uint8)
        self.bins = bins

    # ------------------------------------------------------------------
    # EFB (reference FindGroups, src/io/dataset.cpp:60-180): the JAX package
    # bundles mutually exclusive sparse features; the port refuses data on
    # which a bundle would form, so both packages train on the same columns
    def _check_no_bundles(self) -> None:
        cfg = self.config
        if not (cfg.enable_bundle and self.num_features > 1
                and cfg.tree_learner not in ("feature", "voting")):
            return
        feats = self.used_features
        nb = np.array([self.bin_mappers[f].num_bin for f in feats], np.int64)
        can = np.array([
            self.bin_mappers[f].default_bin == 0
            and self.bin_mappers[f].num_bin <= MAX_BUNDLE_BINS
            for f in feats])
        if int(can.sum()) < 2:
            return
        n = self.num_data
        s = min(n, max(1, cfg.bin_construct_sample_cnt))
        sample_idx = Random(cfg.data_random_seed + 1).sample(n, s)
        bundles = find_bundles(self.bins[sample_idx], nb, can)
        if len(bundles) < self.num_features:
            raise NotPortedError(
                "EFB would bundle %d features into %d columns on this data; "
                "EFB is not ported yet (pass enable_bundle=false)"
                % (self.num_features, len(bundles)))

    # ------------------------------------------------------------------
    def device_data(self, device=None) -> DeviceData:
        """Materialize device tensors on ``device`` (lazily cached)."""
        dev = resolve_device(device)
        if dev in self._device:
            return self._device[dev]
        cfg = self.config
        if any(v != 0 for v in cfg.monotone_constraints):
            raise NotPortedError("monotone_constraints are not ported yet")
        feats = self.used_features
        nb = np.array([self.bin_mappers[f].num_bin for f in feats], dtype=np.int32)
        offsets = np.concatenate([[0], np.cumsum(nb)]).astype(np.int32)
        default_bins = np.array([self.bin_mappers[f].default_bin for f in feats], dtype=np.int32)

        # per-feature MISSING bin (or -1): the trailing NaN bin for
        # NaN-missing features, and the ZERO bin (default_bin) for
        # zero_as_missing features — the grower's partition, the binned
        # traversal and the split search all route this bin by the split's
        # default direction
        def _miss_bin(m):
            if m.missing_type == MissingType.NAN:
                return m.num_bin - 1
            if m.missing_type == MissingType.ZERO:
                return m.default_bin
            return -1
        nan_bins = np.array([_miss_bin(self.bin_mappers[f]) for f in feats],
                            dtype=np.int32)

        def t(a):
            return torch.as_tensor(a).to(dev)
        dd = DeviceData(
            bins=t(self.bins),
            num_bins=t(nb),
            bin_offsets=t(offsets),
            default_bins=t(default_bins),
            nan_bins=t(nan_bins),
            is_categorical=torch.zeros(len(feats), dtype=torch.bool, device=dev),
            monotone=torch.zeros(len(feats), dtype=torch.int8, device=dev),
            total_bins=int(offsets[-1]),
            device=dev,
        )
        self._device[dev] = dd
        return dd


def _to_2d_float(data) -> np.ndarray:
    if hasattr(data, "values"):   # pandas
        data = data.values
    arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    check(arr.ndim == 2, "data must be 2-dimensional")
    return np.ascontiguousarray(arr, dtype=np.float64)


def _sanitize_feature_names(names: "List[str]") -> "List[str]":
    """Reference ``Dataset::set_feature_names`` (``dataset.h:605-625``):
    whitespace becomes underscores, special JSON characters and duplicates
    are rejected."""
    out = []
    had_space = False
    for name in names:
        name = str(name)
        if any(c in name for c in '",:[]{}'):
            raise ValueError(
                f"Do not support special JSON characters in feature name "
                f"({name!r})")
        if any(c.isspace() for c in name):
            had_space = True
            name = "".join("_" if c.isspace() else c for c in name)
        out.append(name)
    if had_space:
        Log.warning("Found whitespace in feature_names, replaced with "
                    "underscores")
    if len(set(out)) != len(out):
        dup = next(n for n in out if out.count(n) > 1)
        raise ValueError(f"Feature ({dup}) appears more than one time.")
    return out


def _resolve_categorical(categorical_feature, feature_names: List[str], config: Config) -> List[int]:
    spec = categorical_feature if categorical_feature is not None else config.categorical_feature
    if spec is None or spec == "" or spec == "auto":
        return []
    out: List[int] = []
    items = spec if isinstance(spec, (list, tuple)) else [s for s in str(spec).split(",") if s]
    for it in items:
        if isinstance(it, str) and not it.lstrip("-").isdigit():
            if it.startswith("name:"):
                it = it[5:]
            if it in feature_names:
                out.append(feature_names.index(it))
            else:
                Log.warning("categorical feature %s not found in feature names", it)
        else:
            out.append(int(it))
    return sorted(set(out))
