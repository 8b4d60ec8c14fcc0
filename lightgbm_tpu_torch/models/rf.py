"""Random Forest mode (reference ``src/boosting/rf.hpp``), a port of the
JAX package's ``models/rf.py``: bagging required, no shrinkage, gradients
always computed at the initial score, predictions the average over trees
(``average_output``, which the model text carries)."""
from __future__ import annotations

from ..utils.log import check
from .gbdt import GBDT


class RF(GBDT):
    average_output = True

    def init_train(self, train_data):
        cfg = self.config
        check(cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0,
              "Random forest requires bagging_freq > 0 and bagging_fraction < 1.0")
        super().init_train(train_data)
        self.shrinkage_rate = 1.0        # no shrinkage (rf.hpp:48)
        # the scores grow in place: keep the initial ones apart
        self._init_score_const = self._train_score.clone()

    def _compute_gradients(self, score):
        # gradients at the constant init score (rf.hpp:82 Boosting override)
        return super()._compute_gradients(self._init_score_const)

    def eval_current(self):
        # metrics see averaged scores
        n_iters = max(1, self.iter_)
        saved_t, saved_v = self._train_score, self._valid_scores
        try:
            self._train_score = self._train_score / n_iters
            self._valid_scores = [s / n_iters for s in self._valid_scores]
            return super().eval_current()
        finally:
            self._train_score, self._valid_scores = saved_t, saved_v
