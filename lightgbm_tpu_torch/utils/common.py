"""Small shared helpers (the analog of ``utils/common.h`` — only the pieces
that survive the move to JAX/numpy; string parsing lives in ``io.loader``)."""
from __future__ import annotations

import numpy as np

# Machine epsilon / sentinel values mirroring the reference's meta.h constants.
K_EPSILON = 1e-15
K_ZERO_THRESHOLD = 1e-35
K_MIN_SCORE = -np.inf
K_MAX_SCORE = np.inf


def round_int(x: float) -> int:
    """Round-half-away-from-zero used by min_data_in_leaf count estimation
    (reference ``Common::RoundInt``, used at ``feature_histogram.hpp:869``)."""
    return int(x + 0.5) if x >= 0 else -int(-x + 0.5)


def softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    m = np.max(x, axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / np.sum(e, axis=axis, keepdims=True)


def arg_max_at_k(values: np.ndarray, k: int) -> np.ndarray:
    """Indices of the top-k values (reference ``ArrayArgs::ArgMaxAtK``)."""
    if k >= len(values):
        return np.argsort(-values, kind="stable")
    part = np.argpartition(-values, k)[:k]
    return part[np.argsort(-values[part], kind="stable")]


def construct_bitset(vals, n_bits: int | None = None) -> np.ndarray:
    """Pack a list of non-negative ints into a uint32 bitset (reference
    ``Common::ConstructBitset`` — used for categorical split thresholds)."""
    vals = np.asarray(vals, dtype=np.int64)
    size = int(vals.max()) // 32 + 1 if len(vals) else 1
    if n_bits is not None:
        size = max(size, (n_bits + 31) // 32)
    out = np.zeros(size, dtype=np.uint32)
    for v in vals:
        out[v // 32] |= np.uint32(1) << np.uint32(v % 32)
    return out


def find_in_bitset(bitset: np.ndarray, val: int) -> bool:
    """Reference ``Common::FindInBitset``."""
    i = val // 32
    if val < 0 or i >= len(bitset):
        return False
    return bool((int(bitset[i]) >> (val % 32)) & 1)
