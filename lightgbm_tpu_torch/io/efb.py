"""Exclusive Feature Bundling: the bundle search only.

A copy of ``find_bundles`` from the JAX package's ``io/efb.py``.  The port
does not bundle yet; ``io/dataset.py`` runs this search to detect data on
which the JAX package WOULD bundle, and refuses it with ``NotPortedError``
so that both packages always train on the same per-feature columns.
"""
from __future__ import annotations

from typing import List

import numpy as np

_POPCOUNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                          axis=1).sum(axis=1).astype(np.int64)

MAX_BUNDLE_BINS = 4096
# bundles tried per feature before giving up (the reference samples 100
# random groups, dataset.cpp:136-144; an oldest-first scan with early exit
# finds the block-mate bundle deterministically for one-hot-style data,
# where random sampling degrades once bundles outnumber the sample)
_MAX_SEARCH_BUNDLES = 512


def find_bundles(sample_bins: np.ndarray, num_bins: np.ndarray,
                 can_bundle: np.ndarray) -> List[List[int]]:
    """Greedy conflict-bounded bundling over a row sample.

    Args:
      sample_bins: ``[S, F]`` binned sample rows.
      num_bins: ``[F]`` bins per feature.
      can_bundle: ``[F]`` bool — numeric, default_bin == 0.

    Returns a list of bundles (lists of feature indices); singletons included.
    Mirrors the reference ``FindGroups`` (dataset.cpp:99-180): features are
    visited most-populated first, conflicts are capped at sample_cnt/10000
    total per bundle and half the feature's own non-default count.
    """
    s, f = sample_bins.shape
    nz = sample_bins != 0                                       # [S, F]
    nz_cnt = nz.sum(axis=0)
    budget = s // 10000
    order = np.argsort(-nz_cnt, kind="stable")

    packed = np.packbits(nz.T, axis=1)                          # [F, ceil(S/8)]
    bundles: List[List[int]] = []
    b_masks: List[np.ndarray] = []
    b_bins: List[int] = []
    b_conflicts: List[int] = []
    for fi in order:
        fi = int(fi)
        extra = int(num_bins[fi]) - 1
        placed = False
        if can_bundle[fi]:
            searched = 0
            for gid in range(len(bundles)):
                if b_bins[gid] + extra > MAX_BUNDLE_BINS:
                    continue
                searched += 1
                if searched > _MAX_SEARCH_BUNDLES:
                    break
                rest = budget - b_conflicts[gid]
                cnt = int(_POPCOUNT[np.bitwise_and(
                    b_masks[gid], packed[fi])].sum())
                if cnt <= rest and cnt <= int(nz_cnt[fi]) // 2:
                    bundles[gid].append(fi)
                    b_masks[gid] |= packed[fi]
                    b_bins[gid] += extra
                    b_conflicts[gid] += cnt
                    placed = True
                    break
        if not placed:
            bundles.append([fi])
            if can_bundle[fi]:
                b_masks.append(packed[fi].copy())
                b_bins.append(1 + extra)
                b_conflicts.append(0)
            else:
                # not bundleable: poison so nothing joins this bundle
                b_masks.append(np.full_like(packed[fi], 255))
                b_bins.append(MAX_BUNDLE_BINS + 1)
                b_conflicts.append(budget + 1)
    return bundles
