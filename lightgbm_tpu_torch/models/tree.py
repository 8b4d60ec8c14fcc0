"""Decision tree model: flat arrays + traversal + serialization.

Re-design of the reference ``Tree`` (``include/LightGBM/tree.h:25``,
``src/io/tree.cpp``): same flat-array layout (split feature / threshold /
children with ``~leaf`` negative encoding / leaf values), same
``decision_type`` bit semantics (categorical, default-left, missing type) and
the same text-serialization grammar (``Tree::ToString``, ``tree.cpp:333``) so
models interoperate with the reference's model files.

Prediction here is vectorized over rows (numpy on host, ``lax.while_loop``
pointer-chasing on device) instead of the reference's per-row recursive
traversal (``tree.h:133``).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..io.bin import BinMapper, BinType, MissingType
from ..utils.common import K_ZERO_THRESHOLD

_CAT_MASK = 1        # decision_type bit 0 (tree.h kCategoricalMask)
_DEFAULT_LEFT_MASK = 2   # bit 1 (kDefaultLeftMask)


class Tree:
    """Host-side tree (arrays indexed by internal node / leaf)."""

    def __init__(self, num_leaves: int):
        m = max(1, num_leaves - 1)
        self.num_leaves = num_leaves
        self.split_feature: np.ndarray = np.zeros(m, np.int32)   # real feature idx
        self.split_feature_inner: np.ndarray = np.zeros(m, np.int32)
        self.threshold: np.ndarray = np.zeros(m, np.float64)     # real threshold
        self.threshold_bin: np.ndarray = np.zeros(m, np.int32)
        self.decision_type: np.ndarray = np.zeros(m, np.int8)
        self.split_gain: np.ndarray = np.zeros(m, np.float32)
        self.left_child: np.ndarray = np.full(m, -1, np.int32)
        self.right_child: np.ndarray = np.full(m, -1, np.int32)
        self.leaf_value: np.ndarray = np.zeros(num_leaves, np.float64)
        self.leaf_weight: np.ndarray = np.zeros(num_leaves, np.float64)
        self.leaf_count: np.ndarray = np.zeros(num_leaves, np.int64)
        self.internal_value: np.ndarray = np.zeros(m, np.float64)
        self.internal_weight: np.ndarray = np.zeros(m, np.float64)
        self.internal_count: np.ndarray = np.zeros(m, np.int64)
        # categorical split support: threshold indexes into cat bitset arrays
        self.cat_boundaries: List[int] = [0]
        self.cat_threshold: List[int] = []
        # BIN-space bitsets per cat node (for binned traversal); rebuilt from
        # the value bitsets via bin_cat_bitsets() for text-loaded models
        self.cat_bits_bin: dict = {}
        # text-loaded trees carry VALUE thresholds only; binned traversal
        # must rebuild threshold_bin first (bin_numeric_thresholds)
        self._has_bin_thresholds: bool = True
        self.shrinkage: float = 1.0
        # linear trees (reference tree.h:49-54): per-leaf linear models
        self.is_linear: bool = False
        self.leaf_const: np.ndarray = np.zeros(0, np.float64)     # [L]
        self.leaf_coeff: List[List[float]] = []                   # per leaf
        self.leaf_features: List[List[int]] = []                  # real ids

    # ------------------------------------------------------------------
    @property
    def num_internal(self) -> int:
        return self.num_leaves - 1

    def is_categorical_split(self, node: int) -> bool:
        return bool(self.decision_type[node] & _CAT_MASK)

    def default_left(self, node: int) -> bool:
        return bool(self.decision_type[node] & _DEFAULT_LEFT_MASK)

    def missing_type(self, node: int) -> int:
        return (int(self.decision_type[node]) >> 2) & 3

    # ------------------------------------------------------------------
    @classmethod
    def from_arrays(cls, arrays, dataset, learning_rate: float = 1.0) -> "Tree":
        """Build from device ``TreeArrays`` + the Dataset (for real feature
        indices and real-valued thresholds)."""
        nl = int(arrays.num_leaves)
        t = cls(nl)
        if nl <= 1:
            return t
        m = nl - 1
        sf_inner = np.asarray(arrays.split_feature[:m], np.int32)
        t.split_feature_inner = sf_inner
        t.split_feature = np.array([dataset.used_features[i] for i in sf_inner], np.int32)
        t.threshold_bin = np.asarray(arrays.threshold[:m], np.int32)
        t.split_gain = np.asarray(arrays.split_gain[:m], np.float32)
        t.left_child = np.asarray(arrays.left_child[:m], np.int32)
        t.right_child = np.asarray(arrays.right_child[:m], np.int32)
        t.leaf_value = np.asarray(arrays.leaf_value[:nl], np.float64) * learning_rate
        t.leaf_weight = np.asarray(arrays.leaf_weight[:nl], np.float64)
        t.leaf_count = np.asarray(arrays.leaf_count[:nl], np.int64)
        t.internal_value = np.asarray(arrays.internal_value[:m], np.float64)
        t.internal_count = np.asarray(arrays.internal_count[:m], np.int64)
        t.shrinkage = learning_rate

        is_cat = np.asarray(arrays.is_cat_split[:m], bool)
        dleft = np.asarray(arrays.default_left[:m], bool)
        cat_bits = np.asarray(arrays.cat_bits[:m], np.int32).view(np.uint32)
        t.threshold = np.zeros(m, np.float64)
        t.decision_type = np.zeros(m, np.int8)
        for j in range(m):
            mapper: BinMapper = dataset.bin_mappers[t.split_feature[j]]
            dt = 0
            if is_cat[j]:
                dt |= _CAT_MASK
                # bin bitset -> category-VALUE bitset (reference
                # Tree::SplitCategorical stores cat_threshold over raw values)
                words = cat_bits[j]
                bins_set = [bi for bi in range(32 * len(words))
                            if (words[bi // 32] >> (bi % 32)) & 1]
                t.cat_bits_bin[j] = words.copy()
                cats = sorted(int(mapper.bin_to_value(bi)) for bi in bins_set)
                t.threshold[j] = float(len(t.cat_boundaries) - 1)  # cat index
                word_cnt = (max(cats) // 32 + 1) if cats else 1
                bits = [0] * word_cnt
                for cat in cats:
                    bits[cat // 32] |= 1 << (cat % 32)
                t.cat_threshold.extend(bits)
                t.cat_boundaries.append(len(t.cat_threshold))
            else:
                if dleft[j]:
                    dt |= _DEFAULT_LEFT_MASK
                dt |= int(mapper.missing_type) << 2
                t.threshold[j] = mapper.bin_to_value(int(t.threshold_bin[j]))
            t.decision_type[j] = dt
        return t

    # ------------------------------------------------------------------
    def _decide(self, node: int, values: np.ndarray) -> np.ndarray:
        """Vectorized decision for raw feature values -> goes-left bool."""
        if self.is_categorical_split(node):
            ci = int(self.threshold[node])
            lo, hi = self.cat_boundaries[ci], self.cat_boundaries[ci + 1]
            words = np.array(self.cat_threshold[lo:hi], dtype=np.uint32)
            iv = np.where(np.isfinite(values) & (values >= 0), values, -1).astype(np.int64)
            wi = iv // 32
            in_range = (iv >= 0) & (wi < len(words))
            wi_safe = np.clip(wi, 0, max(0, len(words) - 1))
            bit = (words[wi_safe] >> (iv % 32).astype(np.uint32)) & 1
            return in_range & (bit == 1)
        mt = self.missing_type(node)
        th = self.threshold[node]
        dl = self.default_left(node)
        nan_mask = np.isnan(values)
        if mt == int(MissingType.NONE):
            values = np.where(nan_mask, 0.0, values)
            return values <= th
        if mt == int(MissingType.ZERO):
            is_miss = nan_mask | (np.abs(values) <= K_ZERO_THRESHOLD)
        else:
            is_miss = nan_mask
        base = np.where(nan_mask, 0.0, values) <= th
        return np.where(is_miss, dl, base)

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Raw-value batch prediction (reference ``Tree::Predict``)."""
        n = X.shape[0]
        if self.num_leaves <= 1 and not self.is_linear:
            return np.full(n, self.leaf_value[0] if len(self.leaf_value) else 0.0)
        leaf = self.predict_leaf_index(X)
        if not self.is_linear:
            return self.leaf_value[leaf]
        # linear leaves: const + coeff·x; NaN in any leaf feature falls back
        # to the constant leaf value (reference PredictionFunLinear,
        # tree.cpp:127-136)
        out = np.zeros(n, np.float64)
        for l in np.unique(leaf):
            sel = leaf == l
            feats = self.leaf_features[l] if l < len(self.leaf_features) else []
            if not feats:
                out[sel] = self.leaf_const[l] if len(self.leaf_const) > l else self.leaf_value[l]
                continue
            vals = X[np.ix_(sel, feats)]
            nan_found = np.isnan(vals).any(axis=1)
            lin = self.leaf_const[l] + np.nan_to_num(vals) @ np.asarray(
                self.leaf_coeff[l], np.float64)
            out[sel] = np.where(nan_found, self.leaf_value[l], lin)
        return out

    def bin_cat_bitsets(self, mappers) -> None:
        """Rebuild BIN-space bitsets from the value bitsets so binned
        traversal works for text-loaded models (inverse of the
        ``from_arrays`` bin->value mapping)."""
        for j in range(self.num_internal):
            if not self.is_categorical_split(j) or j in self.cat_bits_bin:
                continue
            mapper = mappers[self.split_feature[j]]
            ci = int(self.threshold[j])
            lo, hi = self.cat_boundaries[ci], self.cat_boundaries[ci + 1]
            words_vals = np.array(self.cat_threshold[lo:hi], np.uint32)
            nb = mapper.num_bin
            out = np.zeros((nb + 31) // 32, np.uint32)
            for bi in range(nb):
                v = int(mapper.bin_to_value(bi))
                if 0 <= v < 32 * len(words_vals) and \
                        (int(words_vals[v // 32]) >> (v % 32)) & 1:
                    out[bi // 32] |= np.uint32(1 << (bi % 32))
            self.cat_bits_bin[j] = out

    def bin_numeric_thresholds(self, mappers) -> None:
        """Rebuild BIN-space numeric thresholds from the value thresholds
        so binned traversal works for text-loaded models (the numeric
        analog of ``bin_cat_bitsets``; ``from_text`` leaves
        ``threshold_bin`` unset because the reference grammar stores only
        real values).  Exact for same-data continuation: model thresholds
        are bin upper bounds, and ``value_to_bin`` maps a bound back to
        its own bin."""
        if self._has_bin_thresholds:
            return
        by_feat: dict = {}
        for j in range(self.num_internal):
            if not self.is_categorical_split(j):
                by_feat.setdefault(int(self.split_feature[j]), []).append(j)
        for fi, nodes in by_feat.items():
            # one vectorized call per feature, not one per node: a warm
            # start from a big ensemble rebuilds ~leaves x trees thresholds
            bins = np.asarray(mappers[fi].value_to_bin(
                np.array([float(self.threshold[j]) for j in nodes])))
            for j, b in zip(nodes, bins):
                self.threshold_bin[j] = int(b)
        self._has_bin_thresholds = True

    def predict_binned(self, bins: np.ndarray, nan_bins: np.ndarray) -> np.ndarray:
        """Batch prediction over BINNED columns (inner feature space), using
        the grower's decision convention (``ops/grower.py`` partition step).
        Used for continued-training score warm-up where only the binned
        matrix is resident."""
        n = bins.shape[0]
        if self.num_leaves <= 1:
            return np.full(n, self.leaf_value[0] if len(self.leaf_value) else 0.0)
        out = np.zeros(n, np.float64)
        node = np.zeros(n, np.int64)
        active = np.ones(n, bool)
        idx = np.arange(n)
        while active.any():
            cur = node[active]
            rows = idx[active]
            goes_left = np.zeros(len(rows), bool)
            for j in np.unique(cur):
                sel = cur == j
                fi = int(self.split_feature_inner[j])
                col = bins[rows[sel], fi].astype(np.int64)
                thr = int(self.threshold_bin[j])
                if self.is_categorical_split(j):
                    words = self.cat_bits_bin.get(j)
                    if words is None:
                        goes_left[sel] = col == thr      # legacy one-hot
                    else:
                        wi = (col >> 5).astype(np.int64)
                        ok_w = wi < len(words)
                        w = words[np.clip(wi, 0, len(words) - 1)]
                        goes_left[sel] = ok_w & (
                            ((w >> (col % 32).astype(np.uint32)) & 1) == 1)
                else:
                    nb = int(nan_bins[fi])
                    is_miss = (col == nb) & (nb >= 0)
                    goes_left[sel] = np.where(is_miss, self.default_left(j),
                                              col <= thr)
            nxt = np.where(goes_left, self.left_child[cur], self.right_child[cur])
            node[active] = nxt
            done = nxt < 0
            out[rows[done]] = self.leaf_value[~nxt[done]]
            active[rows[done]] = False
        return out

    def predict_leaf_index(self, X: np.ndarray) -> np.ndarray:
        n = X.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n, np.int32)
        node = np.zeros(n, np.int64)
        active = np.ones(n, bool)
        idx = np.arange(n)
        leaf = np.zeros(n, np.int32)
        while active.any():
            cur = node[active]
            rows = idx[active]
            goes_left = np.zeros(len(rows), bool)
            for j in np.unique(cur):
                sel = cur == j
                goes_left[sel] = self._decide(int(j), X[rows[sel], self.split_feature[j]])
            nxt = np.where(goes_left, self.left_child[cur], self.right_child[cur])
            node[active] = nxt
            done = nxt < 0
            leaf[rows[done]] = ~nxt[done].astype(np.int32)
            active[rows[done]] = False
        return leaf

    # ------------------------------------------------------------------
    def shrink(self, rate: float) -> None:
        """Reference ``Tree::Shrinkage`` (``tree.h:187``)."""
        self.leaf_value *= rate
        self.internal_value *= rate
        self.shrinkage *= rate
        if self.is_linear:
            self.leaf_const = self.leaf_const * rate
            self.leaf_coeff = [[c * rate for c in cs] for cs in self.leaf_coeff]

    def add_bias(self, val: float) -> None:
        """Reference ``Tree::AddBias`` (``tree.h:212``)."""
        self.leaf_value += val
        self.internal_value += val
        if self.is_linear:
            self.leaf_const = self.leaf_const + val
        self.shrinkage = 1.0

    # ------------------------------------------------------------------
    def to_text(self, tree_index: int) -> str:
        """Serialize in the reference model-file grammar
        (``Tree::ToString``, ``src/io/tree.cpp:333``)."""
        m = self.num_internal
        lines = [f"Tree={tree_index}",
                 f"num_leaves={self.num_leaves}",
                 f"num_cat={len(self.cat_boundaries) - 1}"]

        def arr(name, a, fmt="{}"):
            lines.append(f"{name}=" + " ".join(fmt.format(v) for v in a))
        if m > 0 and self.num_leaves > 1:
            arr("split_feature", self.split_feature)
            arr("split_gain", self.split_gain, "{:g}")
            arr("threshold", self.threshold, "{:.17g}")
            arr("decision_type", self.decision_type)
            arr("left_child", self.left_child)
            arr("right_child", self.right_child)
            arr("leaf_value", self.leaf_value, "{:.17g}")
            arr("leaf_weight", self.leaf_weight, "{:g}")
            arr("leaf_count", self.leaf_count)
            arr("internal_value", self.internal_value, "{:g}")
            arr("internal_weight", self.internal_weight, "{:g}")
            arr("internal_count", self.internal_count)
            if len(self.cat_boundaries) > 1:
                arr("cat_boundaries", self.cat_boundaries)
                arr("cat_threshold", self.cat_threshold)
        else:
            lines.append("leaf_value=" + "{:.17g}".format(
                self.leaf_value[0] if len(self.leaf_value) else 0.0))
        if not self.is_linear:
            # ALWAYS write is_linear: the reference's text parser
            # (tree.cpp:694) only assigns is_linear_ when the key is present
            # and otherwise leaves the member uninitialized, so a file
            # without it makes reference builds treat random trees as empty
            # linear models (predicting 0); the reference's own writer emits
            # it unconditionally (Tree::ToString, tree.cpp:375)
            lines.append("is_linear=0")
        else:
            # reference linear-tree grammar (Tree::ToString, tree.cpp:375-399)
            lines.append("is_linear=1")
            arr("leaf_const", self.leaf_const, "{:.17g}")
            arr("num_features", [len(f) for f in self.leaf_features])
            lines.append("leaf_features="
                         + " ".join(" ".join(str(f) for f in fs)
                                    for fs in self.leaf_features if fs))
            lines.append("leaf_coeff="
                         + " ".join(" ".join("{:.17g}".format(c) for c in cs)
                                    for cs in self.leaf_coeff if cs))
        lines.append(f"shrinkage={self.shrinkage:g}")
        lines.append("")
        return "\n".join(lines)

    @classmethod
    def from_text(cls, block: str) -> "Tree":
        """Parse one ``Tree=N`` block of a model file (``tree.cpp`` load ctor)."""
        kv = {}
        for line in block.strip().splitlines():
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k.strip()] = v.strip()
        nl = int(kv.get("num_leaves", 1))
        t = cls(nl)
        t.shrinkage = float(kv.get("shrinkage", 1.0))

        def parse_linear(t):
            if int(kv.get("is_linear", "0")) == 0:
                return
            t.is_linear = True
            n_leaves = max(1, t.num_leaves)
            t.leaf_const = (np.array([float(x) for x in kv["leaf_const"].split()])
                            if "leaf_const" in kv else np.zeros(n_leaves))
            counts = ([int(x) for x in kv["num_features"].split()]
                      if "num_features" in kv else [0] * n_leaves)
            feats_flat = ([int(x) for x in kv.get("leaf_features", "").split()])
            coefs_flat = ([float(x) for x in kv.get("leaf_coeff", "").split()])
            t.leaf_features, t.leaf_coeff, o = [], [], 0
            for c in counts:
                t.leaf_features.append(feats_flat[o:o + c])
                t.leaf_coeff.append(coefs_flat[o:o + c])
                o += c

        if nl <= 1:
            if "leaf_value" in kv:
                t.leaf_value = np.array([float(x) for x in kv["leaf_value"].split()], np.float64)
            parse_linear(t)
            return t

        def get(name, dtype, default=None):
            if name not in kv:
                return default
            return np.array([dtype(x) for x in kv[name].split()])
        t.split_feature = get("split_feature", int).astype(np.int32)
        t.split_feature_inner = t.split_feature.copy()
        # the grammar stores real-valued thresholds only; bin-space ones
        # are rebuilt on demand (bin_numeric_thresholds) against a Dataset
        t._has_bin_thresholds = False
        sg = get("split_gain", float)
        t.split_gain = sg.astype(np.float32) if sg is not None else np.zeros(nl - 1, np.float32)
        t.threshold = get("threshold", float).astype(np.float64)
        t.decision_type = get("decision_type", int, np.zeros(nl - 1)).astype(np.int8)
        t.left_child = get("left_child", int).astype(np.int32)
        t.right_child = get("right_child", int).astype(np.int32)
        t.leaf_value = get("leaf_value", float).astype(np.float64)
        lw = get("leaf_weight", float)
        t.leaf_weight = lw.astype(np.float64) if lw is not None else np.zeros(nl)
        lc = get("leaf_count", int)
        t.leaf_count = lc.astype(np.int64) if lc is not None else np.zeros(nl, np.int64)
        iv = get("internal_value", float)
        t.internal_value = iv.astype(np.float64) if iv is not None else np.zeros(nl - 1)
        ic = get("internal_count", int)
        t.internal_count = ic.astype(np.int64) if ic is not None else np.zeros(nl - 1, np.int64)
        if "cat_boundaries" in kv:
            t.cat_boundaries = [int(x) for x in kv["cat_boundaries"].split()]
            t.cat_threshold = [int(x) for x in kv["cat_threshold"].split()]
        parse_linear(t)
        return t

    def to_json(self) -> dict:
        """Structural dump (reference ``Tree::ToJSON``, ``tree.cpp:409``)."""
        def node_json(i):
            if i < 0:
                leaf = ~i
                d = {"leaf_index": int(leaf),
                     "leaf_value": float(self.leaf_value[leaf]),
                     "leaf_weight": float(self.leaf_weight[leaf]),
                     "leaf_count": int(self.leaf_count[leaf])}
                if self.is_linear:
                    d["leaf_const"] = (float(self.leaf_const[leaf])
                                       if len(self.leaf_const) > leaf else 0.0)
                    d["leaf_features"] = list(self.leaf_features[leaf]) \
                        if leaf < len(self.leaf_features) else []
                    d["leaf_coeff"] = list(self.leaf_coeff[leaf]) \
                        if leaf < len(self.leaf_coeff) else []
                return d
            return {
                "split_index": int(i),
                "split_feature": int(self.split_feature[i]),
                "split_gain": float(self.split_gain[i]),
                "threshold": float(self.threshold[i]),
                "decision_type": "==" if self.is_categorical_split(i) else "<=",
                "default_left": self.default_left(i),
                "missing_type": ["None", "Zero", "NaN"][min(2, self.missing_type(i))],
                "internal_value": float(self.internal_value[i]),
                "internal_count": int(self.internal_count[i]),
                "left_child": node_json(int(self.left_child[i])),
                "right_child": node_json(int(self.right_child[i])),
            }
        return {"num_leaves": int(self.num_leaves), "num_cat": len(self.cat_boundaries) - 1,
                "shrinkage": self.shrinkage, "is_linear": int(self.is_linear),
                "tree_structure": node_json(0) if self.num_leaves > 1 else
                {"leaf_value": float(self.leaf_value[0]) if len(self.leaf_value) else 0.0}}
