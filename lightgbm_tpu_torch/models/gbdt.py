"""GBDT: the boosting engine.

Port of the JAX package's ``models/gbdt.py`` for the main path: binary
objective, boost-from-average, one tree per iteration grown by the frontier
grower, device-resident train/valid scores updated by binned traversal
(``_train_one_iter_fast``, without bagging compaction), host ``Tree``
objects materialized lazily from a pending list, and prediction through the
host tree loop or the stacked device ensemble.

Not ported yet (raise ``NotPortedError``): other boosting types and tree
learners, bagging and feature sampling, linear trees, CEGB, interaction
constraints, forced splits, feature_contri, monotone constraints, custom
objectives, prediction early stopping, SHAP and refit.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..device import NotPortedError, resolve_device
from ..io.dataset import Dataset
from ..metric import create_metrics
from ..objective import ObjectiveFunction, create_objective
from ..ops.grower import GrowerConfig, grow_tree
from ..ops.predict import predict_leaf_binned, tree_depth
from ..ops.split import SplitParams
from ..utils.log import Log, check
from .tree import Tree


def check_ported(cfg: Config) -> None:
    """Raise ``NotPortedError`` for any training parameter whose path the
    port does not have yet (no silent fallback to another path)."""
    bad = []
    if cfg.boosting != "gbdt":
        bad.append(f"boosting={cfg.boosting}")
    if cfg.tree_learner != "serial":
        bad.append(f"tree_learner={cfg.tree_learner}")
    if cfg.tree_grower == "serial":
        bad.append("tree_grower=serial")
    if cfg.bagging_freq > 0 and (cfg.bagging_fraction < 1.0
                                 or cfg.pos_bagging_fraction < 1.0
                                 or cfg.neg_bagging_fraction < 1.0):
        bad.append("bagging")
    if cfg.feature_fraction < 1.0:
        bad.append("feature_fraction < 1")
    if cfg.feature_fraction_bynode < 1.0:
        bad.append("feature_fraction_bynode < 1")
    if cfg.extra_trees:
        bad.append("extra_trees")
    if cfg.linear_tree:
        bad.append("linear_tree")
    if any(v != 0 for v in cfg.monotone_constraints):
        bad.append("monotone_constraints")
    if cfg.interaction_constraints:
        bad.append("interaction_constraints")
    if cfg.forcedsplits_filename:
        bad.append("forcedsplits_filename")
    if cfg.feature_contri:
        bad.append("feature_contri")
    if (cfg.cegb_penalty_split > 0 or cfg.cegb_penalty_feature_lazy
            or cfg.cegb_penalty_feature_coupled):
        bad.append("CEGB")
    if cfg.objective not in ("binary",):
        bad.append(f"objective={cfg.objective}")
    if bad:
        raise NotPortedError("not ported yet: " + ", ".join(bad))


class GBDT:
    """Gradient Boosting Decision Tree engine (reference ``gbdt.h:35``)."""

    def __init__(self, config: Config, train_data: Optional[Dataset] = None,
                 objective: Optional[ObjectiveFunction] = None,
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        self.train_data: Optional[Dataset] = None
        self.objective = objective
        self._models: List[Tree] = []
        # deferred host trees: (numpy TreeArrays, shrinkage, bias, iter)
        # materialized into Tree objects when `models` is read
        self._pending: List[tuple] = []
        self._stop_flag = False
        self._empty_by_iter: Dict[int, int] = {}
        self.valid_sets: List[Dataset] = []
        self.valid_names: List[str] = []
        self.valid_metrics: List[list] = []
        self.iter_ = 0
        self.num_class = config.num_class
        self.num_tree_per_iteration = 1
        self.max_feature_idx = 0
        self.init_scores: List[float] = []
        self.shrinkage_rate = config.learning_rate
        self._train_score = None       # [K, N] device
        self._valid_scores: List[torch.Tensor] = []
        self.train_data_name = "training"
        if train_data is not None:
            self.init_train(train_data)

    # ------------------------------------------------------------------
    @property
    def models(self) -> List[Tree]:
        self._drain_pending()
        return self._models

    @models.setter
    def models(self, value: List[Tree]) -> None:
        self._pending.clear()
        self._models = value

    def _drain_pending(self, keep: int = 0) -> None:
        """Materialize pending host trees (oldest first), leaving at most
        ``keep`` pending."""
        while len(self._pending) > keep:
            host, shrink, bias, it = self._pending.pop(0)
            nl = int(host.num_leaves)
            tree = Tree.from_arrays(host, self.train_data, learning_rate=1.0)
            tree.shrink(shrink)
            if bias:
                if nl > 1:
                    tree.add_bias(bias)
                else:
                    tree.leaf_value = np.full_like(tree.leaf_value, bias)
            self._models.append(tree)
            if nl <= 1:
                # when ALL trees of an iteration are split-less, report stop
                # on the next update (as the JAX package does)
                cnt = self._empty_by_iter.get(it, 0) + 1
                self._empty_by_iter[it] = cnt
                if cnt >= self.num_tree_per_iteration:
                    self._stop_flag = True

    # ------------------------------------------------------------------
    def init_train(self, train_data: Dataset) -> None:
        cfg = self.config
        check_ported(cfg)
        self.train_data = train_data
        if self.objective is None:
            self.objective = create_objective(cfg)
        self.objective.init(train_data.metadata, train_data.num_data)
        self.num_tree_per_iteration = self.objective.num_model_per_iteration
        self.max_feature_idx = train_data.num_total_features - 1
        self.train_metrics = create_metrics(cfg)
        for m in self.train_metrics:
            m.init(train_data.metadata, train_data.num_data)
        self._dd = train_data.device_data(self.device)
        md = train_data.metadata
        self._label_dev = (torch.as_tensor(md.label).to(self.device)
                           if md.label is not None else None)
        self._weight_dev = (torch.as_tensor(md.weight).to(self.device)
                            if md.weight is not None else None)
        K = self.num_tree_per_iteration
        n = train_data.num_data

        # boost from average / init_score (gbdt.cpp:338-368)
        init = np.zeros((K, n), dtype=np.float32)
        self.init_scores = [0.0] * K
        if md.init_score is not None:
            init += md.init_score.reshape(-1, n).astype(np.float32)
        elif cfg.boost_from_average:
            for k in range(K):
                s = self.objective.boost_from_score(k)
                self.init_scores[k] = s
                init[k] += s
        self._train_score = torch.as_tensor(init).to(self.device)
        self._grower_cfg = self._make_grower_cfg()

    def _make_grower_cfg(self) -> GrowerConfig:
        cfg = self.config
        max_bin = int(max((self.train_data.num_bin(i)
                           for i in range(self.train_data.num_features)), default=2))
        # the JAX package's histogram width: bins rounded up to a multiple of
        # 4, capped at max_bin + 1 (the same B keeps the trees identical)
        max_bin = max(4, min(cfg.max_bin + 1, -(-max_bin // 4) * 4))
        sp = SplitParams(
            lambda_l1=cfg.lambda_l1, lambda_l2=cfg.lambda_l2,
            min_data_in_leaf=cfg.min_data_in_leaf,
            min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
            min_gain_to_split=cfg.min_gain_to_split,
            max_delta_step=cfg.max_delta_step,
            path_smooth=cfg.path_smooth,
            cat_smooth=cfg.cat_smooth, cat_l2=cfg.cat_l2,
            max_cat_to_onehot=cfg.max_cat_to_onehot,
            max_cat_threshold=cfg.max_cat_threshold,
            min_data_per_group=cfg.min_data_per_group)
        return GrowerConfig(
            num_leaves=cfg.num_leaves, max_depth=cfg.max_depth, max_bin=max_bin,
            split=sp, feature_fraction_bynode=cfg.feature_fraction_bynode,
            extra_trees=cfg.extra_trees,
            has_monotone=any(v != 0 for v in cfg.monotone_constraints),
            cegb_split_penalty=cfg.cegb_tradeoff * cfg.cegb_penalty_split,
            grower_mode=cfg.tree_grower,
            frontier_k=cfg.frontier_k,
            frontier_block_rows=cfg.frontier_block_rows)

    def add_valid_data(self, valid_data: Dataset, name: str) -> None:
        check(valid_data.reference is self.train_data or
              valid_data.bin_mappers is self.train_data.bin_mappers,
              "validation set must be constructed with reference=train_set")
        self.valid_sets.append(valid_data)
        self.valid_names.append(name)
        metrics = create_metrics(self.config)
        for m in metrics:
            m.init(valid_data.metadata, valid_data.num_data)
        self.valid_metrics.append(metrics)
        K = self.num_tree_per_iteration
        n = valid_data.num_data
        init = np.zeros((K, n), dtype=np.float32)
        md_init = valid_data.metadata.init_score
        if md_init is not None:
            init += md_init.reshape(-1, n).astype(np.float32)
        else:
            for k in range(K):
                init[k] += self.init_scores[k]
        self._valid_scores.append(torch.as_tensor(init).to(self.device))

    # ------------------------------------------------------------------
    def train_one_iter(self) -> bool:
        """One boosting iteration (reference ``GBDT::TrainOneIter``,
        ``gbdt.cpp:369``).  Returns True if training should stop (no splits)."""
        if self._stop_flag:
            Log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            return True
        n = self.train_data.num_data
        g, h = self._compute_gradients(self._train_score)
        row_weight = torch.ones(n, dtype=torch.float32, device=self.device)
        fmask = torch.ones(self.train_data.num_features, dtype=torch.float32,
                           device=self.device)
        return self._train_one_iter_fast(g, h, row_weight, fmask, self.iter_,
                                         self.num_tree_per_iteration)

    def _train_one_iter_fast(self, g, h, row_weight, fmask, it: int,
                             K: int) -> bool:
        """Device-resident iteration: grow, then update train and valid
        scores on the device; the host ``Tree`` is built lazily."""
        dd = self._dd
        for k in range(K):
            tree, node_assign, host = grow_tree(
                dd.bins, g[k], h[k], row_weight, fmask, dd.num_bins,
                dd.nan_bins, self._grower_cfg)
            bias = (self.init_scores[k]
                    if it == 0 and self.init_scores[k] != 0.0 else 0.0)
            self._pending.append((host, self.shrinkage_rate, bias, it))
            nl = int(host.num_leaves)
            if nl > 1:
                delta = tree.leaf_value * self.shrinkage_rate
                self._train_score[k] += delta[node_assign]
                depth = tree_depth(host.left_child, host.right_child, nl)
                for vi, vset in enumerate(self.valid_sets):
                    vleaf = predict_leaf_binned(
                        tree, vset.device_data(self.device).bins, dd.nan_bins,
                        depth=depth)
                    self._valid_scores[vi][k] += delta[vleaf]
        self.iter_ += 1
        # one iteration stays pending, so the stop check is one iteration
        # late exactly as in the JAX package (at most K extra constant trees)
        self._drain_pending(keep=K)
        return self._stop_flag

    def _compute_gradients(self, score):
        g, h = self.objective.get_gradients(score[0], self._label_dev,
                                            self._weight_dev)
        return g[None, :], h[None, :]

    # ------------------------------------------------------------------
    def eval_current(self) -> List[Tuple[str, str, float, bool]]:
        """Evaluate all metrics on train (if enabled) + valid sets.
        Returns (dataset_name, metric_name, value, higher_better)."""
        out = []
        if self.config.is_provide_training_metric and self.train_metrics:
            s = self._train_score.cpu().numpy().astype(np.float64)[0]
            for m in self.train_metrics:
                for name, val, hib in m.eval(s, self.objective):
                    out.append((self.train_data_name, name, val, hib))
        for vi in range(len(self.valid_sets)):
            s = self._valid_scores[vi].cpu().numpy().astype(np.float64)[0]
            for m in self.valid_metrics[vi]:
                for name, val, hib in m.eval(s, self.objective):
                    out.append((self.valid_names[vi], name, val, hib))
        return out

    # ------------------------------------------------------------------
    # row*tree volume above which the stacked device traversal is used
    # (overridable via config.pred_device)
    _DEVICE_PREDICT_MIN_WORK = 2_000_000

    def predict_raw(self, X: np.ndarray, num_iteration: int = -1,
                    start_iteration: int = 0) -> np.ndarray:
        """Raw scores [N] (reference ``GBDT::PredictRaw``)."""
        if self.config.pred_early_stop:
            raise NotPortedError("pred_early_stop is not ported yet")
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        K = self.num_tree_per_iteration
        n_iters = len(self.models) // K
        if num_iteration is not None and num_iteration > 0:
            n_iters = min(n_iters, num_iteration)
        models = self.models[start_iteration * K:(start_iteration + n_iters) * K]
        mode = getattr(self.config, "pred_device", "auto")
        use_device = models and mode != "host" and (
            mode == "device"
            or X.shape[0] * len(models) >= self._DEVICE_PREDICT_MIN_WORK)
        if use_device:
            out = self._predict_raw_device(models, start_iteration, X)
        else:
            out = np.zeros((X.shape[0], K))
            for ti, t in enumerate(models):
                out[:, ti % K] += t.predict(X)
        return out[:, 0] if K == 1 else out

    def _predict_raw_device(self, models, start_iteration: int,
                            X: np.ndarray) -> np.ndarray:
        from ..ops.ensemble import predict_raw_ensemble, stack_trees
        key = (start_iteration, len(models), len(self.models))
        cache = getattr(self, "_ens_cache", None)
        if cache is None or cache[0] != key:
            self._ens_cache = (key, stack_trees(models, self.device))
        ens = self._ens_cache[1]
        K = self.num_tree_per_iteration
        out = np.zeros((X.shape[0], K))
        step = 1 << 22                      # bound device residency of X
        for s in range(0, X.shape[0], step):
            chunk = torch.as_tensor(X[s:s + step], dtype=torch.float32).to(
                self.device)
            out[s:s + step] = predict_raw_ensemble(ens, chunk, K).cpu().numpy(
                ).astype(np.float64).T
        return out

    def predict(self, X: np.ndarray, num_iteration: int = -1,
                start_iteration: int = 0, raw_score: bool = False) -> np.ndarray:
        raw = self.predict_raw(X, num_iteration, start_iteration)
        if raw_score or self.objective is None:
            return raw
        return np.asarray(self.objective.convert_output(raw))

    def predict_leaf_index(self, X: np.ndarray, num_iteration: int = -1) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        K = self.num_tree_per_iteration
        n_iters = len(self.models) // K
        if num_iteration is not None and num_iteration > 0:
            n_iters = min(n_iters, num_iteration)
        out = np.zeros((X.shape[0], n_iters * K), np.int32)
        for i in range(n_iters * K):
            out[:, i] = self.models[i].predict_leaf_index(X)
        return out

    # ------------------------------------------------------------------
    @property
    def num_trees(self) -> int:
        return len(self.models)

    def feature_importance(self, importance_type: str = "split",
                           iteration: int = -1) -> np.ndarray:
        """split/gain importance (reference ``GBDT::FeatureImportance``,
        ``gbdt.cpp:606``)."""
        n_feat = self.max_feature_idx + 1
        imp = np.zeros(n_feat)
        models = self.models
        if iteration is not None and iteration > 0:
            models = models[:iteration * self.num_tree_per_iteration]
        for tree in models:
            for j in range(tree.num_internal):
                if tree.num_leaves > 1 and tree.split_gain[j] > 0:
                    f = tree.split_feature[j]
                    if importance_type == "split":
                        imp[f] += 1
                    else:
                        imp[f] += tree.split_gain[j]
        return imp
