"""DART: Dropouts meet Multiple Additive Regression Trees
(reference ``src/boosting/dart.hpp``), a port of the JAX package's
``models/dart.py``.

Per iteration: a random subset of existing trees is "dropped" (score
contributions subtracted), the new tree is fit against the reduced scores,
and both the new tree and the dropped trees are re-weighted
(``DroppingTrees`` ``dart.hpp:97``, ``Normalize`` ``:158``).  The drops are
drawn by the host ``Random``; dropped-tree score deltas are recomputed by
binned traversal of the device trees the booster keeps.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..ops.predict import predict_leaf_binned
from ..utils.random_gen import Random
from .gbdt import GBDT


class DART(GBDT):
    def init_train(self, train_data):
        super().init_train(train_data)
        self._device_trees = []
        self._tree_depths = []
        self._tree_weights = []
        self._rng = Random(self.config.drop_seed)
        self.shrinkage_rate = 1.0        # DART applies lr via normalization

    def _shift_scores(self, mi: int, k: int, scale: float) -> None:
        """Add ``scale`` x model ``mi``'s leaf values to class ``k``'s train
        and valid scores."""
        tree, depth = self._device_trees[mi], self._tree_depths[mi]
        vals = tree.leaf_value * scale
        nan_bins = self._dd.nan_bins
        self._train_score[k] += vals[predict_leaf_binned(
            tree, self._dd.bins, nan_bins, depth=depth, efb=self._dd.efb)]
        for vi, vset in enumerate(self.valid_sets):
            leaf = predict_leaf_binned(
                tree, vset.device_data(self.device).bins, nan_bins,
                depth=depth, efb=self._dd.efb)
            self._valid_scores[vi][k] += vals[leaf]

    def train_one_iter(self):
        cfg = self.config
        K = self.num_tree_per_iteration
        n_iters_done = len(self.models) // max(1, K)

        # --- choose drop set (dart.hpp:97) ---
        drop_iters: List[int] = []
        if n_iters_done > 0 and self._rng.next_float() >= cfg.skip_drop:
            if cfg.uniform_drop:
                drop_prob = 1.0 / max(1, n_iters_done)
                for i in range(n_iters_done):
                    if self._rng.next_float() < max(drop_prob, cfg.drop_rate):
                        drop_iters.append(i)
            else:
                for i in range(n_iters_done):
                    if self._rng.next_float() < cfg.drop_rate:
                        drop_iters.append(i)
            if cfg.max_drop > 0 and len(drop_iters) > cfg.max_drop:
                sel = np.random.default_rng(self._rng.next_int(0, 1 << 30)).choice(
                    len(drop_iters), cfg.max_drop, replace=False)
                drop_iters = [drop_iters[i] for i in sorted(sel)]

        # --- subtract dropped trees from scores ---
        for it in drop_iters:
            for k in range(K):
                self._shift_scores(it * K + k, k,
                                   -self._tree_weights[it * K + k])

        n_before = len(self.models)
        stop = super().train_one_iter()

        # --- normalize (dart.hpp:158) ---
        k_drop = len(drop_iters)
        lr = cfg.learning_rate
        if cfg.xgboost_dart_mode:
            new_scale = lr / (1.0 + lr)                 # xgboost mode
            old_factor = 1.0 / (1.0 + lr)
        else:
            new_scale = lr / (k_drop + 1.0) if k_drop > 0 else lr
            old_factor = k_drop / (k_drop + 1.0) if k_drop > 0 else 1.0

        # the new trees were added with weight 1.0 (shrinkage_rate == 1):
        # scale them to new_scale
        for mi in range(n_before, len(self.models)):
            self.models[mi].shrink(new_scale)
            self._tree_weights[mi] = new_scale
            self._shift_scores(mi, mi - n_before, new_scale - 1.0)

        # re-add dropped trees with reduced weight
        for it in drop_iters:
            for k in range(K):
                mi = it * K + k
                new_w = self._tree_weights[mi] * old_factor
                self.models[mi].shrink(old_factor)
                self._tree_weights[mi] = new_w
                self._shift_scores(mi, k, new_w)
        return stop
