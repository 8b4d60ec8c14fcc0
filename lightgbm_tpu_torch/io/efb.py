"""Exclusive Feature Bundling (EFB): a copy of the JAX package's
``io/efb.py`` (reference ``FindGroups``, ``src/io/dataset.cpp:60-180``).

Sparse features that are (almost) never non-default together share one
dense bin column: bundle value ``off_f + bin_f - 1`` means "feature f is at
non-default bin ``bin_f``", 0 means every member is at its default bin.  An
unbundled feature is a singleton bundle with ``off = 1``, where the
encoding is the identity, so one mapping covers every column:

    feature bin  = col - off + 1   if off <= col < off + (nb - 1)  else  0
    hist[f, 1:]  = bundle_hist[off : off + nb - 1]
    hist[f, 0]   = bundle_total - hist[f, 1:].sum()

Only numerical features whose default bin is 0 are bundled; a bundle is at
most ``MAX_BUNDLE_BINS`` = 4,096 bins wide, and the columns are ``uint16``
when any bundle is wider than 256 bins.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

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


def bundle_layout(bundles: List[List[int]], num_bins: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-feature (bundle_id, offset) and per-bundle width arrays."""
    f_total = int(num_bins.shape[0])
    feat_bundle = np.zeros(f_total, np.int32)
    feat_off = np.zeros(f_total, np.int32)
    widths = np.zeros(len(bundles), np.int32)
    for gid, grp in enumerate(bundles):
        off = 1
        for fi in grp:
            feat_bundle[fi] = gid
            feat_off[fi] = off
            off += int(num_bins[fi]) - 1
        widths[gid] = off
    return feat_bundle, feat_off, widths


def build_bundle_matrix(bins: np.ndarray, bundles: List[List[int]],
                        feat_off: np.ndarray, widths: np.ndarray
                        ) -> np.ndarray:
    """Pack a per-feature bin matrix ``[N, F]`` into ``[N, n_bundles]``.

    Conflicting rows (two members non-default — within the tolerated budget)
    resolve last-writer-wins, like the reference's bundle push order."""
    n = bins.shape[0]
    dtype = np.uint8 if int(widths.max(initial=1)) <= 256 else np.uint16
    out = np.zeros((n, len(bundles)), dtype=dtype)
    for gid, grp in enumerate(bundles):
        if len(grp) == 1:
            out[:, gid] = bins[:, grp[0]].astype(dtype)
            continue
        col = np.zeros(n, dtype=np.int32)
        for fi in grp:
            b = bins[:, fi].astype(np.int32)
            nzm = b != 0
            col[nzm] = int(feat_off[fi]) + b[nzm] - 1
        out[:, gid] = col.astype(dtype)
    return out


def decode_bundle_column(col, off, nb):
    """Feature bin from a bundle-column value: ``col - off + 1`` inside the
    feature's range ``[off, off + nb - 1)``, else the default bin 0.

    The single inverse of ``build_bundle_matrix``'s encoding — shared by the
    grower's split decision, binned prediction, and host-side unbundling.
    Written with arithmetic (no ``where``) so it serves numpy arrays and
    torch tensors alike.
    """
    in_range = (col >= off) & (col < off + nb - 1)
    return in_range * (col - off + 1)
