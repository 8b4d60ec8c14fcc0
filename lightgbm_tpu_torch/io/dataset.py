"""Dataset: binned feature matrix + metadata, resident on the device.

Port of the JAX package's ``io/dataset.py``: per-feature bin mappers from
a row sample (numerical and categorical, with forced bin bounds from
``forcedbins_filename``), real<->inner feature maps with trivial features
dropped, label/weight/query/init-score metadata, validation sets aligned to
the training set's bin mappers and bundles.  The bin matrix is ``uint8``,
or ``uint16`` when a feature or an EFB bundle has more than 256 bins; EFB
(``io/efb.py``) packs mutually exclusive sparse features into shared
columns.  A ``scipy.sparse`` matrix is binned feature by feature over its
stored values (numpy), never densified.  The bin matrix and the bundles are
byte-identical to the JAX package's (same samplers, the same native
binner, ``native/parser.cpp``, with ``BinMapper.value_to_bin`` where it is
unavailable, same bundle search).  The binary cache (``save_binary``,
``load_binary``) has the JAX package's ``.npz`` layout, so a cache written
by either package loads in the other; ``subset`` takes rows and shares the
bin mappers; pandas ``category`` columns become their codes against the
training data's category lists (``_pandas_to_numpy``).  With
``linear_tree`` the dense raw values are kept as ``raw_data`` (float32).

Out-of-core training (``stream/``): ``stream_plan()`` decides from the
``max_bin_matrix_bytes``/``stream_rows`` knobs (or the fake-cap seam)
whether the bin matrix streams from host RAM; ``host_bin_matrix()`` is its
row-block view and ``device_meta()`` the per-feature metadata without the
bins on the device.  A configured stream budget turns EFB off (a config-
only gate, ``_efb_config_allows``).
"""
from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..utils.log import Log, check, LightGBMError
from ..utils.random_gen import Random
from .bin import BinMapper, BinType, MissingType
from .efb import (MAX_BUNDLE_BINS, build_bundle_matrix, bundle_layout,
                  decode_bundle_column, find_bundles)


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
    bins: Any            # [num_data, num_cols] uint8/uint16 -- EFB bundle
    #                      columns when efb is set, else per-feature
    num_bins: Any        # [num_features] int32 — bins per feature
    bin_offsets: Any     # [num_features+1] int32 — flattened histogram offsets
    default_bins: Any    # [num_features] int32 — bin containing raw value 0
    nan_bins: Any        # [num_features] int32 — MISSING bin: trailing NaN
    #                      bin (NAN type), zero bin (ZERO type), or -1
    is_categorical: Any  # [num_features] bool
    monotone: Any        # [num_features] int8 (-1/0/+1)
    total_bins: int
    device: torch.device = torch.device("cpu")
    # EFB (io/efb.py): host numpy (feat_bundle, feat_off, num_bins) and the
    # widest bundle, or (None, 0) when bins are per-feature columns
    efb: Any = None
    bundle_bins: int = 0


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
        # raw feature values, kept only for linear trees (the reference
        # keeps Dataset::raw_data_ when linear_tree=true, dataset.h:717)
        self.raw_data: Optional[np.ndarray] = None
        # EFB state (io/efb.py): None when bundling is off / had no effect
        self.bundles: Optional[List[List[int]]] = None
        self.feat_bundle: Optional[np.ndarray] = None   # [num_features] i32
        self.feat_off: Optional[np.ndarray] = None      # [num_features] i32
        self.bundle_widths: Optional[np.ndarray] = None  # [n_bundles] i32

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
        ``LGBM_DatasetCreateFromMat`` path, ``src/c_api.cpp``) or a
        ``scipy.sparse`` matrix (the ``LGBM_DatasetCreateFromCSR`` path):
        its bin mappers come from a densified row sample and its binning
        and EFB packing stream over row blocks (``_bin_data_sparse``)."""
        config = config or Config()
        self = cls(config)
        sparse = _is_sparse(data)
        check(not (sparse and config.linear_tree),
              "linear_tree with sparse input is not supported")
        data = data.tocsr() if sparse else _to_2d_float(data)
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
            self._construct_bin_mappers(data, cats)

        if sparse:
            self._bin_data_sparse(data, reference)
        else:
            self._bin_data(data)
            if reference is not None:
                self._adopt_bundling(reference)
            else:
                self._apply_bundling()
        if config.linear_tree or (reference is not None
                                  and reference.raw_data is not None):
            self.raw_data = np.asarray(data, np.float32)
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
    def _construct_bin_mappers(self, data, cats: set) -> None:
        cfg = self.config
        n = self.num_data
        # row sampling for bin construction (reference bin_construct_sample_cnt,
        # dataset_loader.cpp SampleTextDataFromFile:902)
        sample_cnt = min(n, cfg.bin_construct_sample_cnt)
        rng = Random(cfg.data_random_seed)
        sample_idx = rng.sample(n, sample_cnt)
        if _is_sparse(data):
            # a column at a time: never the whole [sample, F] dense sample
            sample_csc = data[sample_idx].tocsc()
            col = lambda f: np.asarray(  # noqa: E731
                sample_csc[:, [f]].toarray(), np.float64).ravel()
        else:
            sample = data[sample_idx]
            col = lambda f: sample[:, f]  # noqa: E731
        self.bin_mappers = [self._find_bin_one(f, col(f), sample_cnt, cats)
                            for f in range(self.num_total_features)]
        self._finalize_used_features()

    def _find_bin_one(self, f: int, values: np.ndarray, sample_cnt: int,
                      cats: set) -> BinMapper:
        """Config-resolved ``BinMapper.find_bin`` for one feature."""
        cfg = self.config
        mbf = cfg.max_bin_by_feature
        fb = mbf[f] if f < len(mbf) else cfg.max_bin
        bt = BinType.CATEGORICAL if f in cats else BinType.NUMERICAL
        forced = (self._forced_bin_bounds().get(f)
                  if bt == BinType.NUMERICAL else None)
        return BinMapper.find_bin(
            values, sample_cnt, fb, cfg.min_data_in_bin,
            cfg.min_data_in_leaf, cfg.feature_pre_filter, bin_type=bt,
            use_missing=cfg.use_missing, zero_as_missing=cfg.zero_as_missing,
            forced_upper_bounds=forced)

    def _forced_bin_bounds(self) -> Dict[int, List[float]]:
        """forcedbins_filename JSON -> {feature: [bin_upper_bound, ...]}
        (reference ``DatasetLoader::GetForcedBins``,
        src/io/dataset_loader.cpp:1365; categorical features are skipped by
        the caller)."""
        cached = getattr(self, "_forced_bins_cache", None)
        if cached is not None:
            return cached
        out: Dict[int, List[float]] = {}
        path = self.config.forcedbins_filename
        if path:
            import json
            try:
                with open(path) as fh:
                    arr = json.load(fh)
                for item in arr:
                    bounds = sorted(set(float(b)
                                        for b in item["bin_upper_bound"]))
                    out[int(item["feature"])] = bounds
            except (OSError, ValueError, KeyError) as e:
                Log.warning("Could not parse forcedbins file %s (%s); "
                            "ignoring", path, e)
        self._forced_bins_cache = out
        return out

    def _finalize_used_features(self) -> None:
        self.used_features = [f for f, m in enumerate(self.bin_mappers)
                              if not m.is_trivial]
        if not self.used_features:
            Log.warning("There are no meaningful features, as all feature values are constant.")
        self.real_to_inner = {f: i for i, f in enumerate(self.used_features)}

    def _bin_data(self, data: np.ndarray) -> None:
        max_nb = max((self.bin_mappers[f].num_bin for f in self.used_features), default=1)
        dtype = np.uint8 if max_nb <= 256 else np.uint16
        # native threaded binning (parser.cpp BinValues); numpy fallback
        from ..native import bin_values
        native = bin_values(data, self.bin_mappers, self.used_features)
        if native is not None:
            self.bins = native.astype(dtype, copy=False)
            return
        bins = np.empty((self.num_data, len(self.used_features)), dtype=dtype)
        for i, f in enumerate(self.used_features):
            bins[:, i] = self.bin_mappers[f].value_to_bin(data[:, f]).astype(dtype)
        self.bins = bins

    def _bin_data_sparse(self, data, reference: Optional["Dataset"]) -> None:
        """Bin a scipy CSR matrix and pack it into the bundle columns, the
        bundle layout first (from the reference, or from a binned row
        sample).

        The JAX package bins densified row blocks; here each feature's
        column is binned over its stored values only, into the output (a
        bundled column, or its own), so nothing is densified: a feature's
        implicit zeros take ``value_to_bin(0)``, its stored values their
        own bins (``value_to_bin`` is elementwise), and a bundle's members
        write their non-default bins in member order, last writer winning
        as in ``build_bundle_matrix``.  The matrix is the JAX package's
        byte for byte."""
        feats = self.used_features
        csc = data.tocsc()
        csc.sum_duplicates()                  # as toarray() sums them
        if reference is not None:
            if reference.bundles is not None:
                self._share_bundles(reference)
        else:
            self._plan_bundles_from_sample(data)
        nb_used = np.array([self.bin_mappers[f].num_bin for f in feats], np.int64)
        if self.bundles is not None:
            groups = self.bundles
            width_max = int(self.bundle_widths.max()) if groups else 2
        else:
            groups = [[i] for i in range(len(feats))]
            width_max = int(nb_used.max(initial=2))
        dtype = np.uint8 if width_max <= 256 else np.uint16
        out = np.zeros((self.num_data, len(groups)), dtype=dtype)
        for g, grp in enumerate(groups):
            if len(grp) == 1:
                rows, b, zb = self._stored_bins(csc, grp[0])
                out[:, g] = zb
                out[rows, g] = b
                continue
            for i in grp:
                rows, b, _ = self._stored_bins(csc, i)
                nz = b != 0
                out[rows[nz], g] = int(self.feat_off[i]) + b[nz] - 1
        self.bins = out

    def _stored_bins(self, csc, i: int):
        """``(rows, bins, zero bin)`` of used feature ``i``: the rows that
        store a value of it in ``csc``, their bins, and the bin of an
        implicit zero."""
        f = self.used_features[i]
        m = self.bin_mappers[f]
        p0, p1 = csc.indptr[f], csc.indptr[f + 1]
        return (csc.indices[p0:p1],
                m.value_to_bin(np.asarray(csc.data[p0:p1], np.float64)),
                int(m.value_to_bin(np.zeros(1))[0]))

    # ------------------------------------------------------------------
    # EFB (io/efb.py; reference FindGroups, src/io/dataset.cpp:60-180)
    @staticmethod
    def _efb_config_allows(cfg, num_features: int) -> bool:
        """Config-only part of the EFB gate.  Out-of-core streaming turns
        bundling off whenever a stream budget or block size is CONFIGURED
        (not merely triggered): the streaming grower trains plain
        per-feature columns, and the bundle layout must not depend on the
        data size, which triggers the stream."""
        from ..stream.host_matrix import effective_budget_bytes
        return (cfg.enable_bundle and num_features > 1
                and cfg.tree_learner not in ("feature", "voting")
                and not cfg.stream_rows
                and not effective_budget_bytes(cfg))

    def _efb_candidates(self):
        """(num_bins, bundleable) arrays over used features, or None when
        bundling cannot apply (disabled / feature-sharded learners / a
        stream budget / too few candidates)."""
        cfg = self.config
        if not self._efb_config_allows(cfg, self.num_features):
            return None
        feats = self.used_features
        nb = np.array([self.bin_mappers[f].num_bin for f in feats], np.int64)
        can = np.array([
            self.bin_mappers[f].bin_type == BinType.NUMERICAL
            and self.bin_mappers[f].default_bin == 0
            and self.bin_mappers[f].num_bin <= MAX_BUNDLE_BINS
            for f in feats])
        if int(can.sum()) < 2:
            return None
        return nb, can

    def _plan_bundles_from_binned(self, sb: np.ndarray) -> None:
        """Greedy conflict-bounded bundle search over a binned row sample
        (reference ``FindGroups``); sets the bundle layout when bundling
        wins."""
        cand = self._efb_candidates()
        if cand is None:
            return
        nb, can = cand
        bundles = find_bundles(sb, nb, can)
        if len(bundles) >= self.num_features:
            return                                     # nothing bundled
        self.bundles = bundles
        self.feat_bundle, self.feat_off, self.bundle_widths = \
            bundle_layout(bundles, nb)
        Log.info("EFB: bundled %d features into %d dense columns",
                 self.num_features, len(bundles))

    def _plan_bundles_from_sample(self, data) -> None:
        """The sparse path's bundle search: bins a row sample first (the
        dense path samples its binned matrix instead), at most 50,000
        rows."""
        if self._efb_candidates() is None:
            return
        cfg = self.config
        n = self.num_data
        s = min(n, max(1, cfg.bin_construct_sample_cnt), 50_000)
        sample_idx = Random(cfg.data_random_seed + 1).sample(n, s)
        sub = data[sample_idx].tocsc()
        sub.sum_duplicates()
        sb = np.empty((s, len(self.used_features)), dtype=np.uint16)
        for i in range(len(self.used_features)):
            rows, b, zb = self._stored_bins(sub, i)
            sb[:, i] = zb
            sb[rows, i] = b
        self._plan_bundles_from_binned(sb)

    def _apply_bundling(self) -> None:
        """Dense path: plan from a sample of the binned matrix, then pack."""
        if self._efb_candidates() is None:
            return
        n = self.num_data
        s = min(n, max(1, self.config.bin_construct_sample_cnt))
        sample_idx = Random(self.config.data_random_seed + 1).sample(n, s)
        self._plan_bundles_from_binned(self.bins[sample_idx])
        if self.bundles is not None:
            self.bins = build_bundle_matrix(self.bins, self.bundles,
                                            self.feat_off,
                                            self.bundle_widths)

    def _share_bundles(self, reference: "Dataset") -> None:
        self.bundles = reference.bundles
        self.feat_bundle = reference.feat_bundle
        self.feat_off = reference.feat_off
        self.bundle_widths = reference.bundle_widths

    def _adopt_bundling(self, reference: "Dataset") -> None:
        """Validation sets pack with the training set's bundle layout."""
        if reference.bundles is None:
            return
        self.bins = build_bundle_matrix(
            self.bins, reference.bundles, reference.feat_off,
            reference.bundle_widths)
        self._share_bundles(reference)

    def unbundled_bins(self) -> np.ndarray:
        """Per-feature ``[N, F]`` bin matrix, decoding bundles if present."""
        if self.bundles is None:
            return self.bins
        nb = np.array([self.bin_mappers[f].num_bin
                       for f in self.used_features], np.int64)
        dtype = np.uint8 if int(nb.max(initial=2)) <= 256 else np.uint16
        out = np.zeros((self.num_data, self.num_features), dtype=dtype)
        for i in range(self.num_features):
            col = self.bins[:, self.feat_bundle[i]].astype(np.int64)
            out[:, i] = decode_bundle_column(
                col, int(self.feat_off[i]), int(nb[i])).astype(dtype)
        return out

    # ------------------------------------------------------------------
    def save_binary(self, path: str) -> None:
        """Binary cache (reference ``Dataset::SaveBinaryFile``) in the JAX
        package's ``.npz`` layout: the bin matrix, the mappers' state as
        JSON, the bundles and the metadata."""
        import json
        md = self.metadata
        np.savez_compressed(
            path if path.endswith(".npz") else path + ".npz",
            bins=self.bins,
            meta=json.dumps({
                "num_data": self.num_data,
                "num_total_features": self.num_total_features,
                "used_features": self.used_features,
                "feature_names": self.feature_names,
                "mappers": [m.to_state() for m in self.bin_mappers],
                "bundles": self.bundles,
            }),
            label=md.label if md.label is not None else np.empty(0),
            weight=md.weight if md.weight is not None else np.empty(0),
            query=(md.query_boundaries if md.query_boundaries is not None
                   else np.empty(0, dtype=np.int64)),
            init_score=(md.init_score if md.init_score is not None
                        else np.empty(0)),
        )

    @classmethod
    def load_binary(cls, path: str, config: Optional[Config] = None) -> "Dataset":
        import json
        z = np.load(path if path.endswith(".npz") else path + ".npz",
                    allow_pickle=False)
        meta = json.loads(str(z["meta"]))
        self = cls(config)
        self.num_data = int(meta["num_data"])
        self.num_total_features = int(meta["num_total_features"])
        self.used_features = [int(f) for f in meta["used_features"]]
        self.real_to_inner = {f: i for i, f in enumerate(self.used_features)}
        self.feature_names = list(meta["feature_names"])
        self.bin_mappers = [BinMapper.from_state(st) for st in meta["mappers"]]
        self.bins = z["bins"]
        if meta.get("bundles"):
            self.bundles = [[int(x) for x in g] for g in meta["bundles"]]
            nb = np.array([self.bin_mappers[f].num_bin
                           for f in self.used_features], np.int64)
            self.feat_bundle, self.feat_off, self.bundle_widths = \
                bundle_layout(self.bundles, nb)
        self.metadata = Metadata(self.num_data)
        if z["label"].size:
            self.metadata.label = z["label"].astype(np.float32)
        if z["weight"].size:
            self.metadata.weight = z["weight"].astype(np.float32)
        if z["query"].size:
            self.metadata.query_boundaries = z["query"].astype(np.int64)
        if z["init_score"].size:
            self.metadata.init_score = z["init_score"].astype(np.float64)
        return self

    def subset(self, indices) -> "Dataset":
        """Row subset sharing the bin mappers and bundles (reference
        ``Dataset::CopySubrow``; ``engine.cv`` builds its folds with it).
        Query boundaries do not carry over, as in the JAX package."""
        indices = np.asarray(indices, dtype=np.int64)
        sub = Dataset(self.config)
        sub.num_data = len(indices)
        sub.num_total_features = self.num_total_features
        sub.bin_mappers = self.bin_mappers
        sub.used_features = self.used_features
        sub.real_to_inner = self.real_to_inner
        sub.feature_names = self.feature_names
        sub.bins = self.bins[indices]
        sub._share_bundles(self)
        sub.reference = self
        sub.metadata = Metadata(sub.num_data)
        md = self.metadata
        if md.label is not None:
            sub.metadata.label = md.label[indices]
        if md.weight is not None:
            sub.metadata.weight = md.weight[indices]
        if md.init_score is not None:
            ns = len(md.init_score) // self.num_data
            sub.metadata.init_score = md.init_score.reshape(
                ns, self.num_data)[:, indices].ravel()
        return sub

    # ------------------------------------------------------------------
    # out-of-core streaming (stream/)
    def stream_plan(self):
        """``StreamPlan`` when this dataset should train out-of-core (its
        bin matrix exceeds the ``max_bin_matrix_bytes`` budget, or the
        fake-cap seam's, or ``stream_rows`` forces it), else ``None``.  The
        decision lives here, so every consumer makes the same choice."""
        if self.bins is None:
            return None
        from ..stream.host_matrix import plan_streaming
        return plan_streaming(self.num_data, self.bins.shape[1],
                              self.bins.dtype.itemsize, self.config)

    def host_bin_matrix(self, plan=None):
        """Row-block view of the host bin matrix for the streaming
        trainer."""
        from ..stream.host_matrix import HostBinMatrix
        plan = plan or self.stream_plan()
        check(plan is not None, "host_bin_matrix needs a streaming plan")
        return HostBinMatrix(self.bins, plan.block_rows)

    def device_meta(self, device=None) -> DeviceData:
        """The per-feature metadata tensors on ``device`` WITHOUT the bin
        matrix (``bins`` is None): the streaming trainer keeps the bins in
        host RAM and moves row blocks instead."""
        return self._device_tensors(resolve_device(device), with_bins=False)

    def device_data(self, device=None) -> DeviceData:
        """Materialize device tensors on ``device`` (lazily cached)."""
        dev = resolve_device(device)
        if dev not in self._device:
            self._device[dev] = self._device_tensors(dev, with_bins=True)
        return self._device[dev]

    def _device_tensors(self, dev: torch.device, with_bins: bool
                        ) -> DeviceData:
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
            if m.bin_type != BinType.NUMERICAL:
                return -1
            if m.missing_type == MissingType.NAN:
                return m.num_bin - 1
            if m.missing_type == MissingType.ZERO:
                return m.default_bin
            return -1
        nan_bins = np.array([_miss_bin(self.bin_mappers[f]) for f in feats],
                            dtype=np.int32)

        # monotone directions by inner feature, from the real-feature list
        is_cat = np.array([self.bin_mappers[f].bin_type == BinType.CATEGORICAL
                           for f in feats], dtype=bool)
        mono = np.zeros(len(feats), dtype=np.int8)
        mc = self.config.monotone_constraints
        for i, f in enumerate(feats):
            if f < len(mc):
                mono[i] = mc[f]
        efb = None
        bundle_bins = 0
        if self.bundles is not None:
            efb = (self.feat_bundle.astype(np.int32),
                   self.feat_off.astype(np.int32), nb.astype(np.int32))
            bundle_bins = int(self.bundle_widths.max())

        def t(a):
            return torch.as_tensor(a).to(dev)
        return DeviceData(
            bins=t(self.bins) if with_bins else None,
            num_bins=t(nb),
            bin_offsets=t(offsets),
            default_bins=t(default_bins),
            nan_bins=t(nan_bins),
            is_categorical=t(is_cat),
            monotone=t(mono),
            total_bins=int(offsets[-1]),
            device=dev,
            efb=efb,
            bundle_bins=bundle_bins,
        )


def _is_sparse(data) -> bool:
    """True for any scipy.sparse matrix or array (scipy is imported only
    by whoever made one)."""
    return hasattr(data, "tocsr") and hasattr(data, "nnz")


def _is_dataframe(data) -> bool:
    """True only for a ``pandas.DataFrame`` (pandas imported by the
    caller)."""
    pd = sys.modules.get("pandas")
    return pd is not None and isinstance(data, pd.DataFrame)


def _df_has_category_columns(df) -> bool:
    import pandas as pd
    return any(isinstance(dt, pd.CategoricalDtype) for dt in df.dtypes)


def _require_pandas_mapping(df, pandas_categorical, what: str) -> None:
    """Raise when ``df`` carries category-dtype columns but no training
    mapping exists to code them against: coding against the frame's own
    level order would silently misalign with the training values."""
    if pandas_categorical is None and _df_has_category_columns(df):
        raise LightGBMError(
            f"{what} has category-dtype columns but no pandas_categorical "
            "mapping is available (the training data was not a pandas "
            "DataFrame with category columns)")


def _pandas_to_numpy(df, categorical_feature="auto", pandas_categorical=None):
    """A pandas DataFrame -> the float64 matrix the binner takes (the JAX
    package's ``_pandas_to_numpy``; reference ``_data_from_pandas``,
    ``python-package/lightgbm/basic.py:391``).

    ``category`` columns become their category codes (float, missing ->
    NaN) against a per-column category list: for training data
    (``pandas_categorical is None``) the lists come from the frame and are
    returned, to be stored on the Booster and in the model file, and the
    category columns join ``categorical_feature`` when it is ``"auto"``;
    for validation and prediction data the caller passes the stored lists,
    and a value outside them becomes NaN.

    Returns ``(arr, feature_names, categorical_feature, pandas_categorical)``.
    """
    import pandas as pd

    names = [str(c) for c in df.columns]
    cat_pos = [j for j, c in enumerate(df.columns)
               if isinstance(df.dtypes.iloc[j], pd.CategoricalDtype)]
    bad_cols = [names[j] for j in range(df.shape[1])
                if j not in cat_pos
                and not pd.api.types.is_numeric_dtype(df.dtypes.iloc[j])
                and not pd.api.types.is_bool_dtype(df.dtypes.iloc[j])]
    if bad_cols:
        raise ValueError(
            f"DataFrame column(s) {bad_cols} have a non-numeric (object/"
            "string/datetime) dtype; cast them to a numeric or category "
            "dtype first")
    if not cat_pos and not pandas_categorical:
        # all-numeric frame: one bulk conversion (the predict hot path)
        return (np.ascontiguousarray(df.to_numpy(dtype=np.float64)),
                names, categorical_feature, pandas_categorical)
    if pandas_categorical is None:
        pandas_categorical = [list(df.iloc[:, j].cat.categories)
                              for j in cat_pos]
    else:
        check(len(cat_pos) == len(pandas_categorical),
              "DataFrame categorical columns do not match the training "
              f"data ({len(cat_pos)} vs {len(pandas_categorical)})")

    arr = np.empty((len(df), df.shape[1]), dtype=np.float64)
    for j in range(df.shape[1]):
        col = df.iloc[:, j]
        if j in cat_pos:
            cats = pandas_categorical[cat_pos.index(j)]
            codes = col.cat.set_categories(cats).cat.codes.to_numpy()
            vals = codes.astype(np.float64)
            vals[codes < 0] = np.nan          # unseen/missing -> missing
        else:
            vals = col.to_numpy().astype(np.float64)
        arr[:, j] = vals

    if categorical_feature == "auto":
        categorical_feature = list(cat_pos) if cat_pos else "auto"
    return arr, names, categorical_feature, pandas_categorical


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
