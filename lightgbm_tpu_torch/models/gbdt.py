"""GBDT: the boosting engine.

Port of the JAX package's ``models/gbdt.py`` for the serial learner: every
objective (the ranking ones with query groups), categorical features, u16
bin matrices and EFB bundle matrices, ``num_class`` trees an iteration,
boost-from-average, bagging (the masked bag, and the compacted bag of ``cap`` rows when
bagging keeps under 80% of them), per-tree feature sampling, the per-node
draws keyed by ``random_gen.key_for_iteration`` (``feature_fraction_bynode``,
``extra_trees``), monotone constraints (basic, intermediate, advanced),
interaction constraints, forced splits, CEGB, ``feature_contri``, linear
trees (``ops/linear.py``), device-resident train/valid scores updated
by binned traversal (``_train_one_iter_fast``), the synchronous per-tree
path (``_train_one_iter_sync``: leaf renewal for L1-style objectives, the
model-level CEGB state, linear leaves), host ``Tree`` objects
materialized lazily from a pending list, and prediction through the host
tree loop (with margin-based early stopping) or the stacked device
ensemble.  The observability plane as in the JAX package: per-iteration
and per-tree telemetry (``obs_telemetry``), the numeric sentinels
(``obs_health_check_iters``; on the fast path launched on the device and
copied behind a CUDA event, judged when the tree is drained), the
``/metrics``//``/healthz`` server (``obs_health_port``), the flight
recorder, and the ``train.grow_tree`` cost record.  Custom gradients (``train_one_iter(grad, hess)``, objective
``none``), continued training from a model (``continue_from``), ``refit``,
``rollback_one_iter`` and TreeSHAP contributions (``predict_contrib``,
``ops/shap.py``) as in the JAX package.  ``goss.py``, ``dart.py`` and
``rf.py`` derive from it.  ``ops/grower.grow_tree`` picks the frontier or
the sequential grower per tree.

Not ported yet (raise ``NotPortedError``): the other tree learners.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..device import NotPortedError, resolve_device
from ..io.dataset import Dataset, _is_sparse as _is_sparse_mat
from ..metric import create_metrics
from ..objective import ObjectiveFunction, create_objective
from ..ops import onehot_variants
from ..io.bin import BinType
from ..ops.grower import GrowerConfig, TreeArrays, grow_tree
from ..obs import TrainTelemetry
from ..obs import costs as obs_costs
from ..obs import health as obs_health
from ..ops import histogram
from ..ops.histogram import take_rows
from ..ops.predict import predict_leaf_binned, tree_depth
from ..ops.split import SplitParams
from ..utils.log import LightGBMError, Log, check
from ..utils.random_gen import key_for_iteration, uniform
from ..utils.timer import global_timer
from .tree import Tree

# rows of a densified block when predicting scipy.sparse input
_SPARSE_PREDICT_BLOCK = 65536


def _blockwise_sparse(X, fn):
    """Apply ``fn`` (a dense-matrix predict) over densified row blocks of a
    scipy.sparse matrix and concatenate the results."""
    X = X.tocsr()
    if X.shape[0] == 0:
        return fn(np.zeros((0, X.shape[1]), np.float64))
    outs = [fn(np.asarray(X[s:s + _SPARSE_PREDICT_BLOCK].toarray(), np.float64))
            for s in range(0, X.shape[0], _SPARSE_PREDICT_BLOCK)]
    return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)


def host_scores(score: torch.Tensor) -> np.ndarray:
    """A ``[K, N]`` device score tensor as float64 numpy."""
    return score.cpu().numpy().astype(np.float64)


def kernel_backend(device: torch.device) -> str:
    """Where the histograms of a model on ``device`` run: ``"cuda"`` (the
    hand-written kernels, the card standing for the JAX package's TPU) or
    ``"cpu"``.  The port's counterpart of ``jax.default_backend()`` in the
    JAX package's histogram dispatch."""
    return "cuda" if device.type == "cuda" else "cpu"


def check_ported(cfg: Config) -> None:
    """Raise ``NotPortedError`` for any training parameter whose path the
    port does not have yet (no silent fallback to another path): the
    data-, feature- and voting-parallel tree learners."""
    if cfg.tree_learner != "serial":
        raise NotPortedError(
            f"not ported yet: tree_learner={cfg.tree_learner}")


def bag_mask_from_uniform(cfg: Config, u: torch.Tensor,
                          label: torch.Tensor) -> torch.Tensor:
    """Bernoulli bagging mask from a per-row uniform draw (the JAX
    package's ``bag_mask_from_uniform``; reference gbdt.cpp:182-262)."""
    if cfg.pos_bagging_fraction < 1.0 or cfg.neg_bagging_fraction < 1.0:
        frac = torch.where(label > 0,
                           torch.full_like(u, cfg.pos_bagging_fraction),
                           torch.full_like(u, cfg.neg_bagging_fraction))
    else:
        frac = cfg.bagging_fraction
    return (u < frac).to(torch.float32)


class GBDT:
    """Gradient Boosting Decision Tree engine (reference ``gbdt.h:35``)."""

    # a loaded model sets this from its text; RF sets it for itself
    average_output = False

    def __init__(self, config: Config, train_data: Optional[Dataset] = None,
                 objective: Optional[ObjectiveFunction] = None,
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        self.train_data: Optional[Dataset] = None
        self.objective = objective
        # telemetry hook (obs_telemetry): None keeps the off path at one
        # attribute check per iteration
        self._obs = (TrainTelemetry(config, device=self.device)
                     if config.obs_telemetry else None)
        # live health plane: numeric sentinels every N rounds + the
        # /metrics and /healthz server (obs_health_port, or the
        # LGBM_OBS_HEALTH_PORT environment variable)
        self._health_every = int(config.obs_health_check_iters or 0)
        server = obs_health.maybe_start(config.obs_health_port)
        self._health_enabled = bool(server is not None or self._health_every)
        if self._health_enabled and os.environ.get("LGBM_FLIGHT_DIR"):
            # a supervised run: arm the flight recorder so a divergence or
            # a kill leaves forensics even when obs_telemetry is off
            from ..obs import flight as obs_flight
            obs_flight.install()
        self._grow_cost_recorded = False
        self._models: List[Tree] = []
        # deferred host trees: (numpy TreeArrays, shrinkage, bias, iter,
        # sentinels or None) materialized into Tree objects when `models`
        # is read
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
        # per model: the device tree (unshrunk leaf values), its depth and
        # its current scale (DART re-weights models through these)
        self._device_trees: List = []
        self._tree_depths: List[int] = []
        self._tree_weights: List[float] = []
        self._bag_mask = None
        self._bag_sub = None
        # the scores before the last iteration (rollback_one_iter)
        self._prev_scores = None
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
            host, shrink, bias, it, health = self._pending.pop(0)
            if health is not None:
                # the sentinels' copy rode behind the tree's: by now it has
                # landed, so judging them adds no device sync
                self._run_numeric_check(it, health)
            nl = int(host.num_leaves)
            if self._obs is not None:
                self._obs.tree_event(it, num_leaves=nl, split_gains=[
                    float(v) for v in host.split_gain[:max(0, nl - 1)]])
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
        if self.objective is not None:
            self.objective.init(train_data.metadata, train_data.num_data)
            self.num_tree_per_iteration = self.objective.num_model_per_iteration
        else:
            # objective "none": the caller's gradients, num_class trees
            self.num_tree_per_iteration = max(1, cfg.num_class)
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
        elif cfg.boost_from_average and self.objective is not None:
            for k in range(K):
                s = self.objective.boost_from_score(k)
                self.init_scores[k] = s
                init[k] += s
        self._train_score = torch.as_tensor(init).to(self.device)
        self._grower_cfg = self._make_grower_cfg()
        # the categorical flags, for the grower only when a feature is one
        self._is_cat = (self._dd.is_categorical
                        if bool(self._dd.is_categorical.any()) else None)
        # the feature-gating inputs of every tree (the JAX package builds
        # them once for its compiled grow program)
        self._inter = self._interaction_sets()
        self._forced = self._forced_splits()
        self._contri = self._feature_contri_vec()
        self._cegb_coupled, self._cegb_lazy = self._cegb_vectors()
        # the model-level CEGB state: the features this model has used
        # (coupled penalty), the rows x features it has paid for (lazy)
        f = train_data.num_features
        self._cegb_feat_used = (np.zeros(f, bool)
                                if self._cegb_coupled is not None else None)
        self._cegb_used_data = (
            torch.zeros(n, f, dtype=torch.bool, device=self.device)
            if self._cegb_lazy is not None else None)
        # raw values on the device per dataset (linear trees)
        self._raw_cache = {}

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
        # the categorical features that take the sorted many-category scan
        # (num_bin > max_cat_to_onehot, feature_histogram.hpp:316)
        ds = self.train_data
        sorted_cat = tuple(
            i for i, r in enumerate(ds.used_features)
            if ds.bin_mappers[r].bin_type == BinType.CATEGORICAL
            and ds.num_bin(i) > cfg.max_cat_to_onehot)
        # the kernels' width: the widest EFB bundle when bundling is on
        kernel_bins = self._dd.bundle_bins or max_bin
        # histogram kernels, as the JAX package picks them by its backend
        # (lightgbm_tpu/models/gbdt.py:264-292): on the card (the TPU's
        # counterpart) force_row_wise takes the one-hot kernels with the
        # variant resolved against the kernel width -- 'auto' by the
        # election (cached per card and width), before the first tree.
        # Everything else takes the atomic method, the counterpart of the
        # JAX package's scatter, and ignores hist_variant: the default and
        # force_col_wise everywhere, and force_row_wise on the CPU, where
        # the JAX package sums exactly in float32 (its XLA one-hot and
        # scatter fallbacks) and the port's plain atomic version sums
        # exactly in float64 and rounds once
        if cfg.force_row_wise and kernel_backend(self.device) == "cuda":
            hist_method = "onehot"
            if cfg.hist_variant == "auto":
                hist_variant = onehot_variants.pick_variant(
                    kernel_bins, self.train_data.num_features,
                    device=self.device)
            else:
                hist_variant = onehot_variants.resolve(cfg.hist_variant,
                                                       kernel_bins)
        else:
            hist_method, hist_variant = "atomic", "base"
        return GrowerConfig(
            num_leaves=cfg.num_leaves, max_depth=cfg.max_depth, max_bin=max_bin,
            split=sp, bundle_bins=self._dd.bundle_bins, sorted_cat=sorted_cat,
            feature_fraction_bynode=cfg.feature_fraction_bynode,
            extra_trees=cfg.extra_trees, extra_seed=cfg.extra_seed,
            has_monotone=any(v != 0 for v in cfg.monotone_constraints),
            monotone_mode=cfg.monotone_constraints_method,
            monotone_penalty=cfg.monotone_penalty,
            cegb_split_penalty=cfg.cegb_tradeoff * cfg.cegb_penalty_split,
            grower_mode=cfg.tree_grower,
            frontier_k=cfg.frontier_k,
            frontier_block_rows=cfg.frontier_block_rows,
            hist_method=hist_method, hist_variant=hist_variant,
            trace_device=cfg.obs_trace_device)

    # ------------------------------------------------------------------
    # feature-gating state: interaction constraints, forced splits, CEGB,
    # feature_contri (the JAX package's helpers, same checks and messages)
    def _interaction_sets(self) -> Optional[torch.Tensor]:
        """``[C, F_inner]`` 0/1 matrix of the interaction-constraint groups
        over inner feature ids, or None (``col_sampler.hpp:74``)."""
        groups = self.config.interaction_constraints
        if not groups:
            return None
        used = list(self.train_data.used_features)
        real2inner = {r: i for i, r in enumerate(used)}
        mat = np.zeros((len(groups), len(used)), np.float32)
        for c, grp in enumerate(groups):
            for real in grp:
                if real in real2inner:
                    mat[c, real2inner[real]] = 1.0
        return torch.as_tensor(mat).to(self.device)

    def _forced_splits(self) -> tuple:
        """``forcedsplits_filename`` as the grower's BFS tuple of (side,
        inner_feature, threshold_bin, parent_forced_idx); the grower
        resolves the target leaf ids as the splits land."""
        fname = self.config.forcedsplits_filename
        if not fname:
            return ()
        with open(fname) as fh:
            root = json.load(fh)
        ds = self.train_data
        real2inner = {r: i for i, r in enumerate(ds.used_features)}
        out = []
        queue = [(root, 0, -1)]
        while queue and len(out) < self.config.num_leaves - 1:
            node, side, par = queue.pop(0)
            if not node:
                continue
            real_f = int(node["feature"])
            if real_f not in real2inner:
                Log.warning("forced split on unused feature %d ignored", real_f)
                continue
            mapper = ds.bin_mappers[real_f]
            thr_bin = int(np.asarray(
                mapper.value_to_bin(np.array([float(node["threshold"])])))[0])
            idx = len(out)
            out.append((side, real2inner[real_f], thr_bin, par))
            if node.get("left"):
                queue.append((node["left"], 0, idx))
            if node.get("right"):
                queue.append((node["right"], 1, idx))
        return tuple(out)

    def _feature_contri_vec(self) -> Optional[torch.Tensor]:
        """``[F_inner]`` per-feature gain multipliers (reference
        feature_contri -> FeatureMetainfo::penalty), or None."""
        fc = self.config.feature_contri
        if not fc:
            return None
        if len(fc) != self.train_data.num_total_features:
            raise LightGBMError(
                "feature_contri should be the same size as feature number")
        return torch.as_tensor(
            np.asarray([fc[r] for r in self.train_data.used_features],
                       np.float32)).to(self.device)

    def _cegb_vectors(self):
        """``(coupled [F_inner] | None, lazy [F_inner] | None)``, each
        multiplied by ``cegb_tradeoff``."""
        cfg = self.config

        def vec(pen):
            if not pen:
                return None
            if len(pen) < self.train_data.num_total_features:
                raise LightGBMError("cegb_penalty_feature_* should be the "
                                    "same size as feature number")
            return torch.as_tensor(np.asarray(
                [cfg.cegb_tradeoff * pen[r]
                 for r in self.train_data.used_features],
                np.float32)).to(self.device)
        return (vec(cfg.cegb_penalty_feature_coupled),
                vec(cfg.cegb_penalty_feature_lazy))

    def _cegb_state(self):
        """``(coupled, used_data)`` for the next tree: the coupled
        penalties zeroed for features this model has used, and the
        ``[N, F]`` rows x features it has paid for."""
        coupled = self._cegb_coupled
        if coupled is not None:
            coupled = torch.where(
                torch.as_tensor(self._cegb_feat_used).to(self.device),
                torch.zeros_like(coupled), coupled)
        return coupled, self._cegb_used_data

    def _cegb_update(self, host, node_assign, bag_mask) -> None:
        """Fold one finished tree into the model-level CEGB state: a row
        paid for the features on its root-to-leaf path."""
        nl = int(host.num_leaves)
        if nl <= 1:
            return
        if self._cegb_feat_used is not None:
            feats = np.asarray(host.split_feature[:nl - 1], np.int64)
            self._cegb_feat_used[feats[feats >= 0]] = True
        if self._cegb_used_data is not None:
            path = np.zeros((self._grower_cfg.num_leaves,
                             self.train_data.num_features), bool)
            stack = [(0, [])]
            while stack:
                node, fs = stack.pop()
                if node < 0:               # ~leaf_id
                    path[~node, fs] = True
                    continue
                if host.split_feature[node] < 0:
                    continue
                fs2 = fs + [int(host.split_feature[node])]
                stack.append((int(host.left_child[node]), fs2))
                stack.append((int(host.right_child[node]), fs2))
            paid = torch.as_tensor(path).to(self.device)[node_assign]
            if bag_mask is not None:
                paid = paid & (bag_mask > 0)[:, None]
            self._cegb_used_data |= paid

    # ------------------------------------------------------------------
    # linear trees (linear_tree=true; reference LinearTreeLearner)
    def _raw_of(self, ds: Dataset) -> torch.Tensor:
        """``ds``'s raw values on the model's device, cached per dataset."""
        cache = self._raw_cache
        if id(ds) not in cache:
            if ds.raw_data is None:
                raise LightGBMError(
                    "linear_tree=true requires the Dataset to keep raw "
                    "values; pass linear_tree in the Dataset params")
            cache[id(ds)] = (ds, torch.as_tensor(ds.raw_data).to(self.device))
        return cache[id(ds)][1]

    def _branch_features(self, tree: Tree) -> list:
        """Per leaf, the sorted numerical real feature ids on its root
        path (linear_tree_learner.cpp:195-215)."""
        mappers = self.train_data.bin_mappers
        paths = [[] for _ in range(tree.num_leaves)]
        stack = [(0, [])]
        while stack:
            node, fs = stack.pop()
            if node < 0:
                paths[~node] = sorted({
                    f for f in fs
                    if mappers[f].bin_type != BinType.CATEGORICAL})
                continue
            fs2 = fs + [int(tree.split_feature[node])]
            stack.append((int(tree.left_child[node]), fs2))
            stack.append((int(tree.right_child[node]), fs2))
        return paths

    def _fit_linear_tree(self, tree: Tree, node_assign, g, h, row_weight,
                         is_first_tree: bool):
        """Fit the leaves' linear models into ``tree`` and return the
        device tensors of the score update, or None when constants suffice
        (the first tree, linear_tree_learner.cpp:175-181)."""
        from ..ops.linear import fit_leaf_linear
        nl = tree.num_leaves
        tree.is_linear = True
        if is_first_tree:
            tree.leaf_const = np.asarray(tree.leaf_value, np.float64).copy()
            tree.leaf_coeff = [[] for _ in range(nl)]
            tree.leaf_features = [[] for _ in range(nl)]
            return None
        paths = self._branch_features(tree)
        L = self._grower_cfg.num_leaves
        k_raw = max(1, max((len(p) for p in paths), default=1))
        K = 1 << (k_raw - 1).bit_length()         # the JAX package's padding
        feat_mat = np.full((L, K), -1, np.int64)
        for i, p in enumerate(paths):
            feat_mat[i, :len(p)] = p
        feat_dev = torch.as_tensor(feat_mat).to(self.device)
        coeffs, consts, oks = fit_leaf_linear(
            self._raw_of(self.train_data), g, h, node_assign, row_weight,
            feat_dev, self.config.linear_lambda)
        coeffs = coeffs.float().cpu().numpy().astype(np.float64)
        consts = consts.float().cpu().numpy().astype(np.float64)
        oks = oks.cpu().numpy()
        leaf_value = np.asarray(tree.leaf_value, np.float64)
        tree.leaf_const = np.where(oks[:nl], consts[:nl], leaf_value[:nl])
        tree.leaf_coeff, tree.leaf_features = [], []
        for i in range(nl):
            cs, fs = [], []
            if oks[i]:
                for jx, f in enumerate(paths[i]):
                    c = coeffs[i, jx]
                    if abs(c) > 1e-35:            # kZeroThreshold prune
                        cs.append(float(c))
                        fs.append(int(f))
            tree.leaf_coeff.append(cs)
            tree.leaf_features.append(fs)
        # device views of the score update: a failed leaf is a constant
        coeff_dev = torch.as_tensor(np.where(oks[:, None], coeffs, 0.0),
                                    dtype=torch.float32).to(self.device)
        const = np.zeros(L, np.float32)
        const[:nl] = tree.leaf_const
        return coeff_dev, torch.as_tensor(const).to(self.device), feat_dev

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
    # bagging (gbdt.cpp:182-262); subclasses (GOSS) override
    def _bagging_weights(self, iteration: int, grad, hess):
        cfg = self.config
        need = cfg.bagging_freq > 0 and (cfg.bagging_fraction < 1.0 or
                                         cfg.pos_bagging_fraction < 1.0 or
                                         cfg.neg_bagging_fraction < 1.0)
        if not need:
            return None, grad, hess
        # a run continued from a model mid-period has no bag yet: it draws
        # the period's bag (the reference re-bags a run's first iteration)
        if iteration % cfg.bagging_freq == 0 or self._bag_mask is None:
            key = key_for_iteration(cfg.bagging_seed,
                                    iteration // cfg.bagging_freq)
            u = uniform(key.to(self.device), self.train_data.num_data)
            self._bag_mask = bag_mask_from_uniform(cfg, u, self._label_dev)
        mask = self._bag_mask
        return mask, grad * mask, hess * mask

    # -- bagging subset (reference CopySubrow, gbdt.cpp:256): when bagging
    # drops a material fraction of rows, the survivors are compacted into
    # a buffer of ``cap`` rows, so every grower pass costs O(cap), not
    # O(N).  The mask still decides membership: the compaction is exact
    # while the bag's count is at most cap, which carries a >6-sigma
    # margin over the Bernoulli mean (the JAX package's rule).
    _BAG_SUBSET_MAX_FRACTION = 0.8

    def _bag_subset_capacity(self) -> Optional[int]:
        cfg = self.config
        n = self.train_data.num_data
        if (cfg.bagging_freq <= 0 or not (0.0 < cfg.bagging_fraction
                                          < self._BAG_SUBSET_MAX_FRACTION)
                or cfg.pos_bagging_fraction < 1.0
                or cfg.neg_bagging_fraction < 1.0
                or type(self)._bagging_weights is not GBDT._bagging_weights):
            return None
        return self._capacity_with_margin(n * cfg.bagging_fraction, n)

    @staticmethod
    def _capacity_with_margin(expected_k: float, n: int) -> Optional[int]:
        """Bag buffer capacity: expected count + a >6-sigma Bernoulli
        margin, rounded up to 1024; None when it would not beat full width."""
        cap = int(expected_k + max(64.0, 6.0 * float(np.sqrt(max(1.0, expected_k)))))
        cap = -(-cap // 1024) * 1024
        return cap if cap < n else None

    def _bag_subset_refresh(self, iteration: int) -> bool:
        """True when the bag membership changed this iteration (subclasses
        that re-bag every iteration override)."""
        return iteration % self.config.bagging_freq == 0

    def _bag_compact(self, mask: torch.Tensor, cap: int):
        """``(row_ids [cap], row_weight [cap], bins [cap, F])`` of the bag:
        the in-bag rows in order, then padding slots that repeat row
        ``n - 1`` with weight 0.  The rank of each slot is one
        ``searchsorted`` on the running count (no host read)."""
        n = self.train_data.num_data
        cs = torch.cumsum((mask > 0).to(torch.int64), 0)
        targets = torch.arange(1, cap + 1, dtype=torch.int64,
                               device=mask.device)
        row_ids = torch.clamp(torch.searchsorted(cs, targets, right=False),
                              max=n - 1)
        filled = targets <= cs[-1]
        rw = torch.where(filled, mask[row_ids], torch.zeros_like(mask[:1]))
        return row_ids, rw, take_rows(self._dd.bins, row_ids)

    def _feature_mask(self, iteration: int) -> torch.Tensor:
        cfg = self.config
        f = self.train_data.num_features
        if cfg.feature_fraction >= 1.0:
            return torch.ones(f, dtype=torch.float32, device=self.device)
        # per-tree column sampling (ColSampler::ResetByTree, col_sampler.hpp:74)
        rng = np.random.default_rng(cfg.feature_fraction_seed + iteration)
        k = max(1, int(round(cfg.feature_fraction * f)))
        mask = np.zeros(f, np.float32)
        mask[rng.choice(f, size=k, replace=False)] = 1.0
        return torch.as_tensor(mask).to(self.device)

    def _grow(self, bins, g, h, row_weight, fmask, it: int, k: int,
              cegb_coupled=None, cegb_used=None):
        """One tree (``ops/grower.grow_tree``: the frontier, or the
        sequential grower for what needs the split order); the per-node
        draws are keyed by ``key_for_iteration(seed, it, salt=k + 1)``
        (computed on the host: the growers draw their per-node streams
        there and ship them)."""
        gcfg = self._grower_cfg
        key = (key_for_iteration(self.config.seed, it, salt=k + 1)
               if gcfg.feature_fraction_bynode < 1.0 or gcfg.extra_trees
               else None)
        dd = self._dd
        record = self._obs is not None and not self._grow_cost_recorded
        if record:
            bytes0 = sum(histogram.hist_bytes.values())
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.device)
        out = grow_tree(bins, g, h, row_weight, fmask, dd.num_bins,
                        dd.nan_bins, gcfg, key=key, monotone=dd.monotone,
                        is_categorical=self._is_cat, efb=dd.efb,
                        interaction_sets=self._inter,
                        cegb_coupled=cegb_coupled, cegb_lazy=self._cegb_lazy,
                        cegb_used_data=cegb_used, forced=self._forced,
                        feature_contri=self._contri)
        if record:
            self._ledger_grow_cost(
                sum(histogram.hist_bytes.values()) - bytes0, bins)
        return out

    def _ledger_grow_cost(self, nbytes: int, bins) -> None:
        """Record ``train.grow_tree`` in the obs cost ledger once a fit,
        from the first tree: the bytes its histogram calls read and wrote
        (``histogram.hist_bytes``, the kernels' byte rule; no flops, the
        atomic path does no tensor-core work) and, on the card, the
        allocator's peak over the tree.  The telemetry loop joins each
        iteration's grow seconds against it."""
        self._grow_cost_recorded = True
        memory = ({"peak_bytes": torch.cuda.max_memory_allocated(self.device)}
                  if self.device.type == "cuda" else None)
        obs_costs.get_ledger().record(
            "train.grow_tree", cost={"bytes_accessed": nbytes},
            memory=memory, chip=obs_costs.current_chip(self.device),
            rows=int(bins.shape[0]), features=int(bins.shape[1]))

    # ------------------------------------------------------------------
    def train_one_iter(self, grad: Optional[np.ndarray] = None,
                       hess: Optional[np.ndarray] = None) -> bool:
        """One boosting iteration (reference ``GBDT::TrainOneIter``,
        ``gbdt.cpp:369``).  Returns True if training should stop (no splits).
        ``grad``/``hess`` (host arrays of ``K * N`` values, class-major)
        replace the objective's gradients; they are copied to the model's
        device once."""
        if self._stop_flag:
            Log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            return True
        n = self.train_data.num_data
        it = self.iter_
        K = self.num_tree_per_iteration
        obs = self._obs
        if obs is not None:
            obs.phase_mark()
            # the global_timer scopes below nest under this span (the
            # timer->tracer bridge)
            obs.tracer.begin("train/iteration", step=it)
        with global_timer.scope("GBDT::gradients"):
            if grad is None or hess is None:
                g, h = self._compute_gradients(self._train_score)
            else:
                g, h = (torch.as_tensor(
                    np.asarray(a, np.float32).reshape(K, n)).to(self.device)
                    for a in (grad, hess))
        bag_mask, g, h = self._bagging_weights(it, g, h)
        row_weight = (bag_mask if bag_mask is not None else
                      torch.ones(n, dtype=torch.float32, device=self.device))
        fmask = self._feature_mask(it)
        # the scores are updated in place: the rollback history is a copy
        self._prev_scores = (self._train_score.clone(),
                             [v.clone() for v in self._valid_scores])
        if ((self.objective is not None
             and self.objective.need_renew_tree_output())
                or self.config.linear_tree or self._cegb_coupled is not None
                or self._cegb_lazy is not None):
            return self._train_one_iter_sync(g, h, row_weight, fmask, it, K,
                                             bag_mask)
        return self._train_one_iter_fast(g, h, row_weight, fmask, it, K,
                                         bag_mask=bag_mask)

    def _add_tree_to_scores(self, k: int, tree, node_assign, depth: int,
                            scale: float) -> None:
        """Add ``scale`` x the tree's leaf values to the train scores (rows
        at ``node_assign``) and to every valid set's (binned traversal)."""
        delta = tree.leaf_value * scale
        self._train_score[k] += delta[node_assign]
        for vi, vset in enumerate(self.valid_sets):
            vleaf = predict_leaf_binned(
                tree, vset.device_data(self.device).bins, self._dd.nan_bins,
                depth=depth, efb=self._dd.efb)
            self._valid_scores[vi][k] += delta[vleaf]

    def _add_linear_tree_to_scores(self, k: int, tree, node_assign,
                                   depth: int, linear_dev) -> None:
        """Add the shrunk linear leaf outputs of a tree to the train scores
        (at ``node_assign``) and to every valid set's (its leaves by binned
        traversal, its raw values for the linear models)."""
        from ..ops.linear import linear_leaf_delta
        coeff_dev, const_dev, feat_dev = linear_dev
        rate = self.shrinkage_rate
        self._train_score[k] += linear_leaf_delta(
            self._raw_of(self.train_data), node_assign, coeff_dev,
            const_dev, feat_dev, tree.leaf_value) * rate
        for vi, vset in enumerate(self.valid_sets):
            vleaf = predict_leaf_binned(
                tree, vset.device_data(self.device).bins, self._dd.nan_bins,
                depth=depth, efb=self._dd.efb)
            self._valid_scores[vi][k] += linear_leaf_delta(
                self._raw_of(vset), vleaf, coeff_dev, const_dev, feat_dev,
                tree.leaf_value) * rate

    def _train_one_iter_fast(self, g, h, row_weight, fmask, it: int,
                             K: int, bag_mask=None) -> bool:
        """Device-resident iteration: grow, then update train and valid
        scores on the device; the host ``Tree`` is built lazily.  With a
        compacted bag the tree grows over its ``cap`` rows and the full
        training set is routed through it by one binned traversal."""
        dd = self._dd
        cap = self._bag_subset_capacity() if bag_mask is not None else None
        if cap is not None:
            if self._bag_subset_refresh(it) or self._bag_sub is None:
                self._bag_sub = self._bag_compact(bag_mask, cap)
            bag_rows, bag_rw, bag_bins = self._bag_sub
        for k in range(K):
            with global_timer.scope("GBDT::grow_tree"):
                if cap is not None:
                    tree, _, host = self._grow(bag_bins, g[k][bag_rows],
                                               h[k][bag_rows], bag_rw, fmask,
                                               it, k)
                else:
                    tree, node_assign, host = self._grow(
                        dd.bins, g[k], h[k], row_weight, fmask, it, k)
            # sentinel reductions: launched now, copied behind an event,
            # judged when the tree is drained (no new device sync)
            health = (self._health_launch(g[k], h[k], tree.leaf_value)
                      if self._health_due(it, k) else None)
            bias = (self.init_scores[k]
                    if it == 0 and self.init_scores[k] != 0.0 else 0.0)
            self._pending.append((host, self.shrinkage_rate, bias, it,
                                  health))
            nl = int(host.num_leaves)
            depth = tree_depth(host.left_child, host.right_child, nl)
            with global_timer.scope("GBDT::update_score"):
                if nl > 1:
                    if cap is not None:
                        node_assign = predict_leaf_binned(
                            tree, dd.bins, dd.nan_bins, depth=depth,
                            efb=dd.efb)
                    self._add_tree_to_scores(k, tree, node_assign, depth,
                                             self.shrinkage_rate)
            self._device_trees.append(tree)
            self._tree_depths.append(depth)
            self._tree_weights.append(self.shrinkage_rate)
        self.iter_ += 1
        if self._obs is not None:
            # the iteration event here, the per-tree events from
            # _drain_pending: telemetry adds no device sync
            self._obs.tracer.end("train/iteration")
            self._obs.iteration_event(it, trees=K)
        elif self._health_enabled:
            obs_health.set_status(stage="train", iteration=it)
        # one iteration stays pending, so the stop check is one iteration
        # late exactly as in the JAX package (at most K extra constant trees)
        self._drain_pending(keep=K)
        return self._stop_flag

    def _train_one_iter_sync(self, g, h, row_weight, fmask, it: int,
                             K: int, bag_mask=None) -> bool:
        """The synchronous per-tree path (the JAX package's slow path of
        ``train_one_iter``): each tree comes to the host before the next
        grows.  It serves objectives that renew leaf outputs
        (``RenewTreeOutput``, serial_tree_learner.cpp:684: the leaves are
        re-fit to percentiles of the residuals), the model-level CEGB state
        (coupled and lazy penalties: each tree updates what the model has
        paid for) and linear trees (each leaf's linear model is fit on the
        raw values and updates the scores).  Masked bag, no compaction."""
        dd = self._dd
        cfg = self.config
        should_stop = True
        obs = self._obs
        for k in range(K):
            with global_timer.scope("GBDT::grow_tree"):
                cegb_coupled, cegb_used = self._cegb_state()
                tree, node_assign, host = self._grow(dd.bins, g[k], h[k],
                                                     row_weight, fmask, it, k,
                                                     cegb_coupled, cegb_used)
            if self._health_due(it, k):
                # this path already syncs a tree: judge in line
                self._run_numeric_check(it, (self._health_stats(
                    g[k], h[k], tree.leaf_value), None))
            self._cegb_update(host, node_assign, bag_mask)
            nl = int(host.num_leaves)
            if obs is not None:
                obs.tree_event(it, num_leaves=nl, split_gains=[
                    float(v) for v in host.split_gain[:max(0, nl - 1)]])
            if nl > 1:
                should_stop = False
            t = Tree.from_arrays(host, self.train_data, learning_rate=1.0)
            if (nl > 1 and self.objective is not None
                    and self.objective.need_renew_tree_output()):
                new_vals = self.objective.renew_leaf_values(
                    node_assign.cpu().numpy(),
                    self._train_score[k].cpu().numpy().astype(np.float64),
                    t.leaf_value.copy(), nl)
                t.leaf_value = np.asarray(new_vals, np.float64)
                tree = tree._replace(leaf_value=torch.as_tensor(
                    t.leaf_value.astype(np.float32)).to(self.device))
            linear_dev = None
            if cfg.linear_tree and nl > 1:
                linear_dev = self._fit_linear_tree(
                    t, node_assign, g[k], h[k], row_weight,
                    is_first_tree=(it == 0))
            elif cfg.linear_tree:
                t.is_linear = True
                t.leaf_const = np.asarray(t.leaf_value, np.float64).copy()
                t.leaf_coeff = [[] for _ in range(max(1, nl))]
                t.leaf_features = [[] for _ in range(max(1, nl))]
            t.shrink(self.shrinkage_rate)
            # the first tree carries the boost-from-average bias; a
            # split-less first tree becomes a constant tree holding it
            if it == 0 and self.init_scores[k] != 0.0:
                if nl > 1:
                    t.add_bias(self.init_scores[k])
                else:
                    t.leaf_value = np.full_like(t.leaf_value,
                                                self.init_scores[k])
                    if t.is_linear:
                        t.leaf_const = np.asarray(t.leaf_value,
                                                  np.float64).copy()
            depth = tree_depth(host.left_child, host.right_child, nl)
            with global_timer.scope("GBDT::update_score"):
                if linear_dev is not None:
                    self._add_linear_tree_to_scores(k, tree, node_assign,
                                                    depth, linear_dev)
                elif nl > 1:
                    self._add_tree_to_scores(k, tree, node_assign, depth,
                                             self.shrinkage_rate)
            self.models.append(t)
            self._device_trees.append(tree)
            self._tree_depths.append(depth)
            self._tree_weights.append(self.shrinkage_rate)
        self.iter_ += 1
        if obs is not None:
            obs.tracer.end("train/iteration")
            obs.iteration_event(it, trees=K)
        elif self._health_enabled:
            obs_health.set_status(stage="train", iteration=it)
        if should_stop:
            Log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
        return should_stop

    # ------------------------------------------------------------------
    # numeric health sentinels (obs_health_check_iters): small device-side
    # isfinite/max-abs reductions over gradients, hessians and leaf values
    @staticmethod
    def _health_stats(g, h, leaf) -> torch.Tensor:
        """``[3, 2]`` float32 on the arrays' device: for the gradients, the
        hessians and the leaf values, the finite fraction and the largest
        ``|x|`` over the finite entries (the JAX package's
        ``_health_stats_fn``)."""
        def s(x):
            xf = x.to(torch.float32).reshape(-1)
            finite = torch.isfinite(xf)
            return torch.stack([finite.to(torch.float32).mean(),
                                torch.where(finite, xf.abs(), 0.0).max()])
        return torch.stack([s(g), s(h), s(leaf)])

    @staticmethod
    def _health_launch(g, h, leaf) -> tuple:
        """The sentinels launched on the device and, on a CUDA device,
        copied without blocking into pinned host memory behind an event:
        ``(stats, event or None)``, judged by ``_run_numeric_check``."""
        stats = GBDT._health_stats(g, h, leaf)
        if stats.device.type != "cuda":
            return stats, None
        out = torch.empty(stats.shape, dtype=torch.float32, pin_memory=True)
        out.copy_(stats, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return out, done

    def _health_due(self, it: int, k: int) -> bool:
        """Sample one tree (k==0) every ``obs_health_check_iters`` rounds."""
        return bool(self._health_every and k == 0
                    and it % self._health_every == 0)

    def _run_numeric_check(self, it: int, health: tuple) -> None:
        """Judge the sentinel scalars (after their copy's event); raises
        ``DivergenceError`` on NaN/Inf (with a flight dump) through
        ``obs.health.check_numeric``."""
        stats, done = health
        if done is not None:
            done.synchronize()
        (g0, g1), (h0, h1), (l0, l1) = stats.tolist()
        obs_health.check_numeric(
            {"grad": {"finite_frac": g0, "max_abs": g1},
             "hess": {"finite_frac": h0, "max_abs": h1},
             "leaf_value": {"finite_frac": l0, "max_abs": l1}},
            iteration=it, kind="train",
            log=self._obs.log if self._obs is not None else None)

    def _compute_gradients(self, score):
        if self.objective is None:
            raise LightGBMError("objective is None; provide custom grad/hess")
        if self.num_tree_per_iteration > 1:
            return self.objective.get_gradients_multi(
                score, self._label_dev, self._weight_dev)
        g, h = self.objective.get_gradients(score[0], self._label_dev,
                                            self._weight_dev)
        return g[None, :], h[None, :]

    # ------------------------------------------------------------------
    def eval_current(self) -> List[Tuple[str, str, float, bool]]:
        """Evaluate all metrics on train (if enabled) + valid sets.
        Returns (dataset_name, metric_name, value, higher_better)."""
        out = []
        K = self.num_tree_per_iteration

        def host(score):
            s = score.cpu().numpy().astype(np.float64)
            return s[0] if K == 1 else s        # [K, N] for multiclass

        if self.config.is_provide_training_metric and self.train_metrics:
            s = host(self._train_score)
            for m in self.train_metrics:
                for name, val, hib in m.eval(s, self.objective):
                    out.append((self.train_data_name, name, val, hib))
        for vi in range(len(self.valid_sets)):
            s = host(self._valid_scores[vi])
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
        """Raw scores [N] or [N, K] (reference ``GBDT::PredictRaw``); a
        model with ``average_output`` (RF) averages over its iterations.
        ``pred_early_stop`` with a binary or multiclass objective takes
        the host tree loop with margin-based early stopping."""
        if _is_sparse_mat(X):
            return _blockwise_sparse(
                X, lambda d: self.predict_raw(d, num_iteration, start_iteration))
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        K = self.num_tree_per_iteration
        n_iters = len(self.models) // K
        if num_iteration is not None and num_iteration > 0:
            n_iters = min(n_iters, num_iteration)
        models = self.models[start_iteration * K:(start_iteration + n_iters) * K]
        mode = getattr(self.config, "pred_device", "auto")
        early_stop = (self.config.pred_early_stop
                      and self.objective is not None
                      and getattr(self.objective, "name", "") in
                      ("binary", "multiclass", "multiclassova"))
        use_device = models and not early_stop and mode != "host" and (
            mode == "device"
            or X.shape[0] * len(models) >= self._DEVICE_PREDICT_MIN_WORK)
        if use_device:
            out = self._predict_raw_device(models, start_iteration, X)
        elif early_stop:
            out = self._predict_raw_early_stop(models, X, K)
        else:
            out = np.zeros((X.shape[0], K))
            for ti, t in enumerate(models):
                out[:, ti % K] += t.predict(X)
        if self.average_output:
            out = out / max(1, n_iters)
        return out[:, 0] if K == 1 else out

    def _predict_raw_early_stop(self, models, X: np.ndarray, K: int):
        """Margin-based per-row prediction early termination (reference
        ``prediction_early_stop.cpp``): every ``pred_early_stop_freq``
        iterations, rows whose margin -- ``2 * |score|`` for binary, top1
        minus top2 for multiclass -- exceeds ``pred_early_stop_margin``
        stop accumulating further trees."""
        cfg = self.config
        # the check period is a whole number of iterations: freezing a row
        # mid-iteration would leave unequal per-class tree counts
        freq = max(1, cfg.pred_early_stop_freq) * K
        thresh = cfg.pred_early_stop_margin
        n = X.shape[0]
        out = np.zeros((n, K))
        active = np.ones(n, bool)
        for ti, t in enumerate(models):
            out[active, ti % K] += t.predict(X[active])
            if (ti + 1) % freq == 0 and ti + 1 < len(models):
                if K == 1:
                    margin = 2.0 * np.abs(out[:, 0])
                else:
                    part = np.partition(out, K - 2, axis=1)
                    margin = part[:, K - 1] - part[:, K - 2]
                active &= margin <= thresh
                if not active.any():
                    break
        return out

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
        if self.num_tree_per_iteration > 1:
            return np.asarray(self.objective.convert_output(raw.T)).T
        return np.asarray(self.objective.convert_output(raw))

    def predict_contrib(self, X: np.ndarray, num_iteration: int = -1,
                        start_iteration: int = 0, sparse: bool = False,
                        sparse_format: Optional[str] = None):
        """TreeSHAP feature contributions (reference ``GBDT::PredictContrib``
        via ``Tree::TreeSHAP``, ``tree.cpp:887``): per row, per class,
        ``[num_features + 1]`` with the bias (expected value) last.
        ``sparse=True`` returns scipy matrices (one, or a list of K for
        multiclass) in ``sparse_format`` (csr or csc), built block by
        block."""
        from ..ops.shap import expected_value, tree_shap
        if any(getattr(t, "is_linear", False) for t in self.models):
            raise LightGBMError(
                "pred_contrib (TreeSHAP) is not supported for linear trees")
        if sparse:
            return self._predict_contrib_sparse(X, num_iteration,
                                                start_iteration,
                                                sparse_format)
        if _is_sparse_mat(X):
            return _blockwise_sparse(
                X, lambda d: self.predict_contrib(d, num_iteration,
                                                  start_iteration))
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        n, F = X.shape
        K = self.num_tree_per_iteration
        n_iters = len(self.models) // K
        if num_iteration is not None and num_iteration > 0:
            n_iters = min(n_iters, num_iteration)
        out = np.zeros((n, K, F + 1))
        for i in range(start_iteration, start_iteration + n_iters):
            for k in range(K):
                ti = i * K + k
                if ti < len(self.models):
                    t = self.models[ti]
                    out[:, k, :F] += tree_shap(t, X)
                    out[:, k, F] += expected_value(t)
        return out[:, 0, :] if K == 1 else out.reshape(n, K * (F + 1))

    def _predict_contrib_sparse(self, X, num_iteration: int,
                                start_iteration: int,
                                sparse_format: Optional[str] = None):
        """Blockwise sparse TreeSHAP: CSR per block, stacked; a block's row
        count is capped by its elements, so the dense scratch stays bounded
        on wide input."""
        import scipy.sparse as sp
        K = self.num_tree_per_iteration
        Xc = X.tocsr() if _is_sparse_mat(X) else np.asarray(X, np.float64)
        n, F = Xc.shape
        block = max(1, min(_SPARSE_PREDICT_BLOCK,
                           (64 << 20) // max(1, (F + 1) * K)))
        blocks: List[list] = [[] for _ in range(K)]
        for s in range(0, max(n, 1), block):
            xb = Xc[s:s + block]
            if _is_sparse_mat(xb):
                xb = np.asarray(xb.toarray(), np.float64)
            dense = self.predict_contrib(xb, num_iteration, start_iteration)
            if K == 1:
                blocks[0].append(sp.csr_matrix(dense))
            else:
                F1 = dense.shape[1] // K
                for k in range(K):
                    blocks[k].append(
                        sp.csr_matrix(dense[:, k * F1:(k + 1) * F1]))
        # the input's format (csr or csc) is the output's
        fmt = sparse_format or (getattr(X, "format", "csr")
                                if _is_sparse_mat(X) else "csr")
        fmt = fmt if fmt in ("csr", "csc") else "csr"
        mats = [sp.vstack(b, format=fmt) if len(b) > 1
                else (b[0] if fmt == "csr" else b[0].tocsc())
                for b in blocks]
        return mats[0] if K == 1 else mats

    def predict_leaf_index(self, X: np.ndarray, num_iteration: int = -1) -> np.ndarray:
        if _is_sparse_mat(X):
            return _blockwise_sparse(
                X, lambda d: self.predict_leaf_index(d, num_iteration))
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
    def continue_from(self, prev: "GBDT") -> None:
        """Continued training from an existing model (reference CLI
        ``input_model`` / Python ``init_model``, ``boosting.cpp:35-60``):
        adopt the previous ensemble and warm the train and valid scores
        with its predictions over the binned data.

        The warm replays the float32 score updates of a single run on the
        device: each tree's unshrunk float32 leaf values are recovered from
        its host values (``(value - bias) / shrinkage``, exact for values
        that a float32 leaf times the shrinkage made) and added in tree
        order to this model's starting scores at the leaves of the binned
        traversal (``predict_leaf_binned``), as training added them.  So a
        run continued from a model of the same data and parameters sees the
        scores, and grows the trees, of one run.  The first iteration's
        trees carry the boost-from-average bias, which the starting scores
        already hold.  (The JAX package sums the host values in float64 on
        the host and rounds once, within float32 rounding of this.)  A
        model with linear trees warms as the JAX package does
        (``_warm_linear``)."""
        import copy
        check(prev.num_tree_per_iteration == self.num_tree_per_iteration,
              "init_model has a different number of tree per iteration")
        self.models = [copy.deepcopy(t) for t in prev.models]
        self._tree_weights = (list(prev._tree_weights)
                              or [1.0] * len(self.models))
        self._device_trees = []
        self._tree_depths = []
        self._ens_cache = None
        K = self.num_tree_per_iteration
        self.iter_ = len(self.models) // K
        self._prev_scores = None
        if any(getattr(t, "is_linear", False) for t in self.models):
            self._warm_linear()
            return
        ds = self.train_data
        sets = self._score_sets()
        for i, t in enumerate(self.models):
            k = i % K
            bias = self.init_scores[k] if i < K else 0.0
            # a tree that took the bias prints shrinkage 1 (Tree.add_bias)
            rate = (self.shrinkage_rate if bias and t.shrinkage == 1.0
                    else t.shrinkage)
            unshrunk = ((t.leaf_value - bias) / rate).astype(np.float32)
            tree, depth = ((None, 0) if t.num_leaves <= 1
                           else self._binned_tree(t, ds))
            for leaf_of, score in sets:
                delta = torch.as_tensor(unshrunk).to(score.device) * rate
                score[k] += (delta[0] if tree is None
                             else delta[leaf_of(tree, depth)])
        self._prev_scores = None

    def _score_sets(self):
        """``(leaf_of, scores)`` of the training set and of each valid
        set: ``leaf_of(tree, depth)`` gives the leaf of each row by the
        binned traversal, on the scores' device."""
        dd = self._dd

        def leaves(bins):
            return lambda tree, depth: predict_leaf_binned(
                tree, bins, dd.nan_bins, depth=depth, efb=dd.efb)
        return [(leaves(dd.bins), self._train_score)] + [
            (leaves(v.device_data(self.device).bins), self._valid_scores[i])
            for i, v in enumerate(self.valid_sets)]

    def _warm_linear(self) -> None:
        """Warm the scores from a model holding linear trees, as the JAX
        package's ``continue_from`` does: from zero (the first trees carry
        the bias), each tree's host prediction summed in float64 and
        rounded once -- a linear tree's on the dataset's raw values (the
        binned midpoints would move the linear leaves), any other tree's
        leaf values at its binned traversal."""
        K = self.num_tree_per_iteration
        sets = [(self.train_data, self._train_score)] + [
            (v, self._valid_scores[i]) for i, v in enumerate(self.valid_sets)]
        for ds, score in sets:
            if ds.raw_data is None:
                raise LightGBMError(
                    "continued training from a linear-tree model requires "
                    "the Dataset to keep raw values (pass linear_tree=true)")
            raw = np.asarray(ds.raw_data, np.float64)
            bins = ds.device_data(self.device).bins
            s = np.zeros((K, ds.num_data), np.float64)
            for i, t in enumerate(self.models):
                if t.is_linear:
                    s[i % K] += t.predict(raw)
                elif t.num_leaves <= 1:
                    s[i % K] += t.leaf_value[0]
                else:
                    tree, depth = self._binned_tree(t, self.train_data)
                    leaf = predict_leaf_binned(tree, bins, self._dd.nan_bins,
                                               depth=depth, efb=self._dd.efb)
                    s[i % K] += t.leaf_value[leaf.cpu().numpy()]
            score.copy_(torch.as_tensor(s.astype(np.float32)))

    def _binned_tree(self, t: Tree, ds: Dataset):
        """A host tree as the device ``TreeArrays`` that
        ``predict_leaf_binned`` reads (inner features, bin thresholds, bin
        bitsets), and its depth.  A text-loaded tree names real features
        and value thresholds: they map to ``ds``'s inner features and
        bins."""
        if len(t.cat_boundaries) > 1:
            t.bin_cat_bitsets(ds.bin_mappers)
        t.bin_numeric_thresholds(ds.bin_mappers)
        m = t.num_leaves - 1
        inner = np.array([ds.real_to_inner[int(f)] for f in t.split_feature[:m]],
                         np.int32)
        words = max((len(w) for w in t.cat_bits_bin.values()), default=1)
        cat = np.zeros((m, words), np.int32)
        for j, w in t.cat_bits_bin.items():
            cat[j, :len(w)] = np.asarray(w, np.uint32).view(np.int32)

        def dev(a):
            return torch.as_tensor(np.asarray(a)).to(self.device)
        zeros = dev(np.zeros(m, np.float32))
        tree = TreeArrays(
            split_feature=dev(inner), threshold=dev(t.threshold_bin[:m].astype(np.int32)),
            default_left=dev(np.array([t.default_left(j) for j in range(m)])),
            is_cat_split=dev(np.array([t.is_categorical_split(j)
                                       for j in range(m)])),
            cat_bits=dev(cat), split_gain=zeros,
            left_child=dev(t.left_child[:m].astype(np.int32)),
            right_child=dev(t.right_child[:m].astype(np.int32)),
            leaf_value=dev(np.zeros(m + 1, np.float32)), leaf_count=zeros,
            leaf_weight=zeros, internal_value=zeros, internal_count=zeros,
            num_leaves=dev(np.int32(m + 1)))
        return tree, tree_depth(t.left_child, t.right_child, m + 1)

    # ------------------------------------------------------------------
    def refit(self, X: np.ndarray, y: np.ndarray, decay_rate: float = 0.9) -> None:
        """Refit the existing tree structures on new data (reference
        ``GBDT::RefitTree`` (``gbdt.cpp:285``) + ``FitByExistingTree``
        (``serial_tree_learner.cpp:211-250``)): per iteration, gradients at
        the progressive score are re-aggregated per leaf and
        ``new = output*shrinkage``, ``leaf = decay*old + (1-decay)*new``.
        The gradients run on the model's device, the sums on the host."""
        from ..io.dataset import Metadata
        if any(getattr(t, "is_linear", False) for t in self.models):
            raise LightGBMError(
                "refit is not supported for linear-tree models yet")
        cfg = self.config
        X = np.asarray(X, np.float64)
        n = X.shape[0]
        obj = self.objective
        if obj is None:
            obj = create_objective(cfg)
        if obj is None:
            raise LightGBMError("cannot refit without an objective")
        md = Metadata(n)
        md.set_field("label", y)
        obj.init(md, n)
        K = self.num_tree_per_iteration
        n_iters = len(self.models) // K
        label_dev = torch.as_tensor(md.label).to(self.device)
        score = np.zeros((K, n), np.float32)
        leaf_idx = [t.predict_leaf_index(X) for t in self.models]
        lam1, lam2, mds = cfg.lambda_l1, cfg.lambda_l2, cfg.max_delta_step

        def out_of(sg, sh):
            thr = np.sign(sg) * np.maximum(np.abs(sg) - lam1, 0.0)
            o = -thr / (sh + lam2 + 1e-35)
            if mds > 0:
                o = np.clip(o, -mds, mds)
            return o

        for it in range(n_iters):
            sc = torch.as_tensor(score).to(self.device)
            if K > 1:
                g, h = obj.get_gradients_multi(sc, label_dev, None)
            else:
                g0, h0 = obj.get_gradients(sc[0], label_dev, None)
                g, h = g0[None, :], h0[None, :]
            g, h = host_scores(g), host_scores(h)
            for k in range(K):
                t = self.models[it * K + k]
                lp = leaf_idx[it * K + k]
                nl = t.num_leaves
                sg = np.bincount(lp, weights=g[k], minlength=nl)[:nl]
                sh = np.bincount(lp, weights=h[k], minlength=nl)[:nl] + 1e-15
                new_out = out_of(sg, sh) * t.shrinkage
                t.leaf_value = (decay_rate * t.leaf_value
                                + (1.0 - decay_rate) * new_out)
                score[k] += t.leaf_value[lp].astype(np.float32)
        self._device_trees = []            # host trees changed; drop caches
        self._ens_cache = None

    # ------------------------------------------------------------------
    def rollback_one_iter(self) -> None:
        """Reference ``GBDT::RollbackOneIter`` (``gbdt.cpp:454``): undo the
        last iteration's trees and restore the scores copied before it (a
        one-step history)."""
        if self.iter_ <= 0:
            return
        if self._prev_scores is None:
            raise LightGBMError("rollback history exhausted (only one step kept)")
        K = self.num_tree_per_iteration
        if len(self._pending) >= K:
            # the last iteration's host trees are still pending
            del self._pending[-K:]
        else:
            self._models = self.models[:-K]
        self._device_trees = self._device_trees[:-K]
        self._tree_depths = self._tree_depths[:-K]
        self._tree_weights = self._tree_weights[:-K]
        self._ens_cache = None
        self.iter_ -= 1
        # the rolled-back iteration's empty-tree accounting must not leak
        # into a retrain of the same iteration (or pin _stop_flag)
        self._empty_by_iter.pop(self.iter_, None)
        self._stop_flag = False
        self._train_score, self._valid_scores = self._prev_scores
        self._prev_scores = None

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
