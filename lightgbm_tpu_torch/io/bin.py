"""Feature binning: value -> bin mapping.

TPU-native re-design of the reference ``BinMapper`` (``include/LightGBM/bin.h:61``,
``src/io/bin.cpp``).  Semantics preserved:

- numeric bins are (greedy) equal-frequency over a row sample, distinct-value
  aligned, with ``min_data_in_bin`` merging and a dedicated zero bin;
- missing handling modes None / Zero / NaN (``bin.h:26``): NaN gets its own
  trailing bin when ``use_missing``; ``zero_as_missing`` folds zeros+NaN into
  the zero bin;
- categorical features map category -> bin by descending frequency;
- forced bin upper bounds supported (``forcedbins_filename``).

Mechanics replaced: no 4-bit packing / sparse bin classes — the TPU build
stores one dense ``uint8``/``uint16`` matrix (bins) in HBM and vectorizes
``value -> bin`` with ``np.searchsorted`` instead of a per-value binary search
(``bin.h:464``).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.log import Log, check
from ..utils.common import K_ZERO_THRESHOLD


class MissingType(enum.IntEnum):
    """Reference ``MissingType`` (``bin.h:26``)."""
    NONE = 0
    ZERO = 1
    NAN = 2


class BinType(enum.IntEnum):
    NUMERICAL = 0
    CATEGORICAL = 1


def _greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                     max_bin: int, total_cnt: int, min_data_in_bin: int) -> List[float]:
    """Greedy equal-frequency bin boundary search (reference
    ``BinMapper::FindBin`` inner algorithm, ``src/io/bin.cpp``).

    Returns ascending upper bounds; last bound is +inf.
    """
    num_distinct = len(distinct_values)
    bin_upper: List[float] = []
    if num_distinct == 0:
        return [np.inf]
    if num_distinct <= max_bin:
        # one bin per distinct value, merging values until min_data_in_bin met
        cur_cnt = 0
        for i in range(num_distinct - 1):
            cur_cnt += int(counts[i])
            if cur_cnt >= min_data_in_bin:
                bin_upper.append((distinct_values[i] + distinct_values[i + 1]) / 2.0)
                cur_cnt = 0
        bin_upper.append(np.inf)
        return bin_upper

    max_bin = max(1, max_bin)
    mean_bin_size = total_cnt / max_bin
    # values with very large counts become their own bin; remaining budget
    # spread equal-frequency over the rest
    is_big = counts >= mean_bin_size
    rest_cnt = total_cnt - int(counts[is_big].sum())
    rest_bins = max_bin - int(is_big.sum())
    if rest_bins > 0:
        mean_bin_size = rest_cnt / rest_bins
    lower = float(distinct_values[0])
    cur_cnt = 0
    for i in range(num_distinct - 1):
        if not is_big[i]:
            rest_cnt -= int(counts[i])
        cur_cnt += int(counts[i])
        # finish current bin if: value is big, bin is full, or next value is big
        if is_big[i] or cur_cnt >= mean_bin_size or \
           (is_big[i + 1] and cur_cnt >= max(1.0, mean_bin_size * 0.5)):
            bin_upper.append((distinct_values[i] + distinct_values[i + 1]) / 2.0)
            cur_cnt = 0
            if not is_big[i] and rest_bins > 1:
                rest_bins -= 1
                if rest_bins > 0:
                    mean_bin_size = rest_cnt / rest_bins
        if len(bin_upper) >= max_bin - 1:
            break
    bin_upper.append(np.inf)
    return bin_upper


@dataclass
class BinMapper:
    """Per-feature value -> bin mapping (reference ``bin.h:61``)."""

    num_bin: int = 1
    bin_type: BinType = BinType.NUMERICAL
    missing_type: MissingType = MissingType.NONE
    bin_upper_bound: np.ndarray = field(default_factory=lambda: np.array([np.inf]))
    categorical_2_bin: Dict[int, int] = field(default_factory=dict)
    bin_2_categorical: List[int] = field(default_factory=list)
    default_bin: int = 0          # bin containing value 0 (sparse/most-common bin)
    most_freq_bin: int = 0
    min_val: float = 0.0
    max_val: float = 0.0
    sparse_rate: float = 0.0

    @property
    def is_trivial(self) -> bool:
        return self.num_bin <= 1

    # ------------------------------------------------------------------
    @classmethod
    def find_bin(cls, values: np.ndarray, total_sample_cnt: int, max_bin: int,
                 min_data_in_bin: int, min_split_data: int, pre_filter: bool,
                 bin_type: BinType = BinType.NUMERICAL,
                 use_missing: bool = True, zero_as_missing: bool = False,
                 forced_upper_bounds: Optional[Sequence[float]] = None) -> "BinMapper":
        """Construct from a sample of one feature's raw values.

        ``values`` are the sampled values (may contain NaN); zeros may be
        omitted from the sample, in which case ``total_sample_cnt`` exceeds
        ``len(values)`` and the difference counts as zeros (the reference's
        sparse sampling contract, ``bin.cpp FindBin``).
        """
        m = cls()
        m.bin_type = bin_type
        values = np.asarray(values, dtype=np.float64)
        na_cnt = int(np.isnan(values).sum())
        vals = values[~np.isnan(values)]
        zero_cnt = total_sample_cnt - len(vals) - na_cnt + int(
            (np.abs(vals) <= K_ZERO_THRESHOLD).sum())

        if zero_as_missing:
            m.missing_type = MissingType.ZERO
        elif not use_missing:
            m.missing_type = MissingType.NONE
            # NaN folded into zero when missing handling is off (bin.cpp)
            vals = np.where(np.isnan(vals), 0.0, vals)
        elif na_cnt > 0:
            m.missing_type = MissingType.NAN
        else:
            m.missing_type = MissingType.NONE

        if bin_type == BinType.CATEGORICAL:
            m._find_bin_categorical(vals, total_sample_cnt, max_bin, min_data_in_bin)
        else:
            m._find_bin_numerical(vals, zero_cnt, total_sample_cnt, na_cnt, max_bin,
                                  min_data_in_bin, use_missing, zero_as_missing,
                                  forced_upper_bounds)

        # trivial-feature pre-filter (reference feature_pre_filter, dataset_loader.cpp)
        if pre_filter and m.num_bin <= 1:
            m.num_bin = 1
        if len(vals):
            m.min_val, m.max_val = float(vals.min()), float(vals.max())
        m.sparse_rate = zero_cnt / max(1, total_sample_cnt)
        return m

    def _find_bin_numerical(self, vals, zero_cnt, total_cnt, na_cnt, max_bin,
                            min_data_in_bin, use_missing, zero_as_missing,
                            forced_upper_bounds) -> None:
        # distinct values with counts, zero injected with its sampled count
        nonzero = vals[np.abs(vals) > K_ZERO_THRESHOLD]
        uniq, counts = np.unique(nonzero, return_counts=True)
        if zero_cnt > 0:
            pos = int(np.searchsorted(uniq, 0.0))
            uniq = np.insert(uniq, pos, 0.0)
            counts = np.insert(counts, pos, zero_cnt)

        n_avail = max_bin
        if use_missing and self.missing_type == MissingType.NAN:
            n_avail -= 1  # reserve trailing NaN bin
        if zero_as_missing:
            n_avail = max(2, n_avail - 2)   # reserve the +-eps boundaries

        if forced_upper_bounds:
            bounds = sorted(set(float(b) for b in forced_upper_bounds))
            if not bounds or bounds[-1] != np.inf:
                bounds = bounds + [np.inf]
            # refine forced bounds with greedy bins inside each forced segment
            ub = self._refine_forced(uniq, counts, bounds, n_avail, total_cnt, min_data_in_bin)
        else:
            ub = _greedy_find_bin(uniq, counts, n_avail, total_cnt, min_data_in_bin)

        if zero_as_missing:
            # reference FindBinWithZeroAsOneBin (bin.cpp): the zero bin is
            # EXACTLY (-kZeroThreshold, +kZeroThreshold] — force both
            # boundaries and drop any greedy boundary inside, so no real
            # value can share the bin that training and prediction route by
            # the split's default direction.  (A merged bin silently sent
            # its real-valued rows down the missing path: round-4 fix.)
            K = K_ZERO_THRESHOLD
            ub = [b for b in ub if not (-K < b < K)]
            ub = sorted(set(ub + [-K, K]))
        self.bin_upper_bound = np.asarray(ub, dtype=np.float64)
        self.num_bin = len(ub)
        if use_missing and self.missing_type == MissingType.NAN:
            self.num_bin += 1  # trailing NaN bin
        self.default_bin = int(np.searchsorted(self.bin_upper_bound, 0.0, side="left"))
        # most frequent bin from sample counts
        if len(uniq):
            bins = np.searchsorted(self.bin_upper_bound, uniq, side="left")
            bc = np.bincount(bins, weights=counts, minlength=self.num_bin)
            self.most_freq_bin = int(np.argmax(bc))

    @staticmethod
    def _refine_forced(uniq, counts, forced, n_avail, total_cnt, min_data_in_bin):
        ub: List[float] = []
        lo = -np.inf
        remaining = n_avail - len(forced)
        for hi in forced:
            seg = (uniq > lo) & (uniq <= hi)
            if remaining > 0 and seg.sum() > 1:
                take = max(1, int(remaining * seg.sum() / max(1, len(uniq))))
                inner = _greedy_find_bin(uniq[seg], counts[seg], take + 1,
                                         int(counts[seg].sum()), min_data_in_bin)
                ub.extend(b for b in inner[:-1] if lo < b < hi)
            if hi != np.inf:
                ub.append(hi)
            lo = hi
        ub.append(np.inf)
        return sorted(set(ub))

    def _find_bin_categorical(self, vals, total_cnt, max_bin, min_data_in_bin) -> None:
        ivals = vals.astype(np.int64)
        neg = ivals < 0
        if neg.any():
            Log.warning("Met negative value in categorical features, will convert it to NaN")
            ivals = ivals[~neg]
        uniq, counts = np.unique(ivals, return_counts=True)
        order = np.argsort(-counts, kind="stable")
        uniq, counts = uniq[order], counts[order]
        # drop ultra-rare categories beyond the bin budget; keep 99% mass
        # (reference cut at cumulative 99% of sample, bin.cpp categorical path)
        keep = min(len(uniq), max_bin - 1 if len(uniq) > max_bin - 1 else len(uniq))
        cum = np.cumsum(counts)
        mass_keep = int(np.searchsorted(cum, 0.99 * cum[-1])) + 1
        keep = min(keep, max(1, mass_keep))
        uniq, counts = uniq[:keep], counts[:keep]
        # bin 0 reserved for unseen/other + NaN
        self.categorical_2_bin = {int(v): i + 1 for i, v in enumerate(uniq)}
        self.bin_2_categorical = [int(v) for v in uniq]
        self.num_bin = keep + 1
        self.most_freq_bin = 1 if keep else 0
        self.default_bin = 0
        self.missing_type = MissingType.NAN  # NaN/unseen -> bin 0

    # ------------------------------------------------------------------
    def value_to_bin(self, values: np.ndarray) -> np.ndarray:
        """Vectorized value -> bin (reference ``BinMapper::ValueToBin``,
        ``bin.h:464-502``)."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BinType.CATEGORICAL:
            out = np.zeros(len(values), dtype=np.int32)
            if self.categorical_2_bin:
                cats = np.array(self.bin_2_categorical, dtype=np.float64)
                # match category values exactly; unseen/NaN -> 0
                idx = np.searchsorted(np.sort(cats), values)
                sorted_cats = np.sort(cats)
                rank_of_sorted = np.argsort(cats)
                valid = (idx < len(cats)) & ~np.isnan(values)
                safe_idx = np.clip(idx, 0, len(cats) - 1)
                exact = valid & (sorted_cats[safe_idx] == values)
                out[exact] = rank_of_sorted[safe_idx[exact]] + 1
            return out

        nan_mask = np.isnan(values)
        if self.missing_type == MissingType.ZERO:
            values = np.where(nan_mask, 0.0, values)
            nan_mask = np.zeros_like(nan_mask)
        elif self.missing_type == MissingType.NONE:
            values = np.where(nan_mask, 0.0, values)
            nan_mask = np.zeros_like(nan_mask)
        bins = np.searchsorted(self.bin_upper_bound, values, side="left").astype(np.int32)
        if self.missing_type == MissingType.NAN:
            bins = np.where(nan_mask, self.num_bin - 1, bins)
        return np.clip(bins, 0, self.num_bin - 1)

    def bin_to_value(self, b: int) -> float:
        """Representative value of a bin (used for threshold real-value
        reporting, reference ``BinMapper::BinToValue``)."""
        if self.bin_type == BinType.CATEGORICAL:
            if 1 <= b < self.num_bin:
                return float(self.bin_2_categorical[b - 1])
            return 0.0
        if b >= len(self.bin_upper_bound):
            return float(self.max_val)
        return float(self.bin_upper_bound[b])

    def to_state(self) -> dict:
        return {
            "num_bin": self.num_bin,
            "bin_type": int(self.bin_type),
            "missing_type": int(self.missing_type),
            "bin_upper_bound": self.bin_upper_bound.tolist(),
            "bin_2_categorical": list(self.bin_2_categorical),
            "default_bin": self.default_bin,
            "most_freq_bin": self.most_freq_bin,
            "min_val": self.min_val,
            "max_val": self.max_val,
            "sparse_rate": self.sparse_rate,
        }

    @classmethod
    def from_state(cls, st: dict) -> "BinMapper":
        m = cls()
        m.num_bin = int(st["num_bin"])
        m.bin_type = BinType(st["bin_type"])
        m.missing_type = MissingType(st["missing_type"])
        m.bin_upper_bound = np.asarray(st["bin_upper_bound"], dtype=np.float64)
        m.bin_2_categorical = [int(v) for v in st.get("bin_2_categorical", [])]
        m.categorical_2_bin = {v: i + 1 for i, v in enumerate(m.bin_2_categorical)}
        m.default_bin = int(st["default_bin"])
        m.most_freq_bin = int(st["most_freq_bin"])
        m.min_val = float(st.get("min_val", 0.0))
        m.max_val = float(st.get("max_val", 0.0))
        m.sparse_rate = float(st.get("sparse_rate", 0.0))
        return m
