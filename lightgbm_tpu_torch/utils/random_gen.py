"""Deterministic RNG: the host LCG and the counter-based device draws.

``Random`` is a copy of the JAX package's host-side LCG (bin-construction
row sampling and DART's drop draws must match in both packages).

The device draws reproduce ``jax.random`` bit for bit as torch ops on any
device: the threefry2x32 keys of ``jax.random.key``, ``fold_in``,
``key_for_iteration`` and ``uniform`` in float32, as jax 0.9.0 computes them
with ``jax_threefry_partitionable=True`` (the source is jax's
``_src/prng.py``: ``threefry_seed``, ``_threefry_fold_in``,
``_threefry_random_bits_partitionable``).  A key is an int64 tensor whose
last dimension holds the two uint32 words; uint32 arithmetic is emulated in
int64 with ``& 0xFFFFFFFF``, since torch's uint32 ops are partial on CUDA.
Every function takes a batch of keys (``[..., 2]``), so the frontier's 2k
child searches draw in one set of ops.  Bagging, GOSS, ``feature_fraction_
bynode`` and ``extra_trees`` draw from them.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
# threefry2x32's rotation schedule (two groups of four, alternating) and
# its key-schedule parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


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


# --------------------------------------------------------------------------
# counter-based device draws (jax.random's threefry2x32)
# --------------------------------------------------------------------------

def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 with 20 rounds on uint32 values held in int64 tensors
    (broadcasting): returns the two output words."""
    k3 = k1 ^ k2 ^ _PARITY
    ks = (k1, k2, k3)
    x0 = (x0 + k1) & _M32
    x1 = (x1 + k2) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(np.uint32(seed))``'s two words, ``(0, seed)``."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a batch: ``key [..., 2]`` and ``data``
    (an int or an int tensor broadcasting against ``key[..., 0]``) ->
    keys ``[..., 2]``."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    k1, k2 = key[..., 0], key[..., 1]
    k1, k2, d = torch.broadcast_tensors(k1, k2, d)
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def key_for_iteration(seed: int, iteration: int, salt: int = 0,
                      device=None) -> torch.Tensor:
    """Per-iteration key (the JAX package's ``key_for_iteration``):
    ``fold_in(key(seed), iteration)``, then ``fold_in(., salt)`` when
    ``salt`` is nonzero."""
    key = fold_in(prng_key(seed, device), int(iteration))
    if salt:
        key = fold_in(key, int(salt))
    return key


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` in float32 for every key of a
    batch: ``key [..., 2]`` -> ``[..., n]`` in [0, 1)."""
    dev = key.device
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    k1 = key[..., 0:1]
    k2 = key[..., 1:2]
    # the partitionable counter: (iota >> 32, iota & 0xffffffff)
    b0, b1 = threefry2x32(k1, k2, iota >> 32, iota & _M32)
    bits = b0 ^ b1
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp(f - 1.0, min=0.0)
