"""Host-side deterministic RNG for dataset sampling.

A copy of the ``Random`` class of the JAX package's ``utils/random_gen.py``
(bin-construction row sampling must draw the same rows in both packages, or
the bin mappers differ).  The per-iteration device keys of that module are
not ported: on the main path nothing draws them (only bagging,
``feature_fraction``, ``feature_fraction_bynode`` and ``extra_trees`` do),
and those options raise ``NotPortedError`` in this package.
"""
from __future__ import annotations

import numpy as np


class Random:
    """Host-side deterministic RNG (next_short/next_int/sample contract of
    the reference's ``Random`` class, ``utils/random.h``)."""

    def __init__(self, seed: int = 0) -> None:
        self._state = np.uint32(seed if seed >= 0 else 0)

    def next_short(self, lo: int, hi: int) -> int:
        return lo + self._rand16() % (hi - lo)

    def next_int(self, lo: int, hi: int) -> int:
        r = (np.uint32(self._rand16()) << np.uint32(16)) | np.uint32(self._rand16())
        return int(lo + r % np.uint32(hi - lo))

    def next_float(self) -> float:
        return self._rand16() / 65536.0

    def _rand16(self) -> int:
        # LCG constants as in C++ minstd-style generators; value truncated to 16 bits.
        self._state = np.uint32((int(self._state) * 214013 + 2531011) & 0xFFFFFFFF)
        return int((int(self._state) >> 16) & 0x7FFF)

    def sample(self, total: int, k: int) -> np.ndarray:
        """Reservoir-free sorted sampling of k indices out of total (matches the
        reference contract of Random::Sample: sorted unique indices)."""
        if k >= total:
            return np.arange(total, dtype=np.int64)
        rng = np.random.default_rng(int(self._state))
        idx = rng.choice(total, size=k, replace=False)
        idx.sort()
        return idx.astype(np.int64)
