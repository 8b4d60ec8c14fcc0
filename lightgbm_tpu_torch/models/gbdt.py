"""GBDT: the boosting engine.

Port of the JAX package's ``models/gbdt.py`` for the frontier grower: every
objective (the ranking ones with query groups), categorical features, u16
bin matrices and EFB bundle matrices, ``num_class`` trees an iteration,
boost-from-average, bagging (the masked bag, and the compacted bag of ``cap`` rows when
bagging keeps under 80% of them), per-tree feature sampling, the per-node
draws keyed by ``random_gen.key_for_iteration`` (``feature_fraction_bynode``,
``extra_trees``), monotone-basic, device-resident train/valid scores updated
by binned traversal (``_train_one_iter_fast``), the synchronous per-tree
path with leaf renewal for L1-style objectives, host ``Tree`` objects
materialized lazily from a pending list, and prediction through the host
tree loop or the stacked device ensemble.  Custom gradients
(``train_one_iter(grad, hess)``, objective ``none``), continued training
from a model (``continue_from``), ``refit``, ``rollback_one_iter`` and
TreeSHAP contributions (``predict_contrib``, ``ops/shap.py``) as in the
JAX package.  ``goss.py``, ``dart.py`` and ``rf.py`` derive from it.

Not ported yet (raise ``NotPortedError``): other tree learners, the serial
grower and what only it serves (monotone intermediate/advanced, CEGB,
interaction constraints, forced splits, linear trees, and so refit and
continued training of a linear-tree model), feature_contri and
prediction early stopping.
"""
from __future__ import annotations

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
from ..ops.histogram import take_rows
from ..ops.predict import predict_leaf_binned, tree_depth
from ..ops.split import SplitParams
from ..utils.log import LightGBMError, Log, check
from ..utils.random_gen import key_for_iteration, uniform
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
    port does not have yet (no silent fallback to another path); the
    objective factory refuses a custom objective."""
    bad = []
    if cfg.tree_learner != "serial":
        bad.append(f"tree_learner={cfg.tree_learner}")
    if cfg.tree_grower == "serial":
        bad.append("tree_grower=serial")
    if cfg.linear_tree:
        bad.append("linear_tree")
    if (any(v != 0 for v in cfg.monotone_constraints)
            and cfg.monotone_constraints_method != "basic"):
        bad.append("monotone_constraints_method="
                   + cfg.monotone_constraints_method)
    if cfg.interaction_constraints:
        bad.append("interaction_constraints")
    if cfg.forcedsplits_filename:
        bad.append("forcedsplits_filename")
    if cfg.feature_contri:
        bad.append("feature_contri")
    if (cfg.cegb_penalty_split > 0 or cfg.cegb_penalty_feature_lazy
            or cfg.cegb_penalty_feature_coupled):
        bad.append("CEGB")
    if bad:
        raise NotPortedError("not ported yet: " + ", ".join(bad))


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
            hist_method=hist_method, hist_variant=hist_variant)

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
        if iteration % cfg.bagging_freq == 0:
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

    def _grow(self, bins, g, h, row_weight, fmask, it: int, k: int):
        """One tree by the frontier grower; the per-node draws are keyed by
        ``key_for_iteration(seed, it, salt=k + 1)`` (computed on the host:
        the frontier draws its per-node streams there and ships them)."""
        gcfg = self._grower_cfg
        key = (key_for_iteration(self.config.seed, it, salt=k + 1)
               if gcfg.feature_fraction_bynode < 1.0 or gcfg.extra_trees
               else None)
        dd = self._dd
        return grow_tree(bins, g, h, row_weight, fmask, dd.num_bins,
                         dd.nan_bins, gcfg, key=key, monotone=dd.monotone,
                         is_categorical=self._is_cat, efb=dd.efb)

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
        if grad is None or hess is None:
            g, h = self._compute_gradients(self._train_score)
        else:
            g, h = (torch.as_tensor(np.asarray(a, np.float32).reshape(K, n)
                                    ).to(self.device) for a in (grad, hess))
        bag_mask, g, h = self._bagging_weights(it, g, h)
        row_weight = (bag_mask if bag_mask is not None else
                      torch.ones(n, dtype=torch.float32, device=self.device))
        fmask = self._feature_mask(it)
        # the scores are updated in place: the rollback history is a copy
        self._prev_scores = (self._train_score.clone(),
                             [v.clone() for v in self._valid_scores])
        if (self.objective is not None
                and self.objective.need_renew_tree_output()):
            return self._train_one_iter_renew(g, h, row_weight, fmask, it, K)
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
            if cap is not None:
                tree, _, host = self._grow(bag_bins, g[k][bag_rows],
                                           h[k][bag_rows], bag_rw, fmask,
                                           it, k)
            else:
                tree, node_assign, host = self._grow(dd.bins, g[k], h[k],
                                                     row_weight, fmask, it, k)
            bias = (self.init_scores[k]
                    if it == 0 and self.init_scores[k] != 0.0 else 0.0)
            self._pending.append((host, self.shrinkage_rate, bias, it))
            nl = int(host.num_leaves)
            depth = tree_depth(host.left_child, host.right_child, nl)
            if nl > 1:
                if cap is not None:
                    node_assign = predict_leaf_binned(tree, dd.bins,
                                                      dd.nan_bins, depth=depth,
                                                      efb=dd.efb)
                self._add_tree_to_scores(k, tree, node_assign, depth,
                                         self.shrinkage_rate)
            self._device_trees.append(tree)
            self._tree_depths.append(depth)
            self._tree_weights.append(self.shrinkage_rate)
        self.iter_ += 1
        # one iteration stays pending, so the stop check is one iteration
        # late exactly as in the JAX package (at most K extra constant trees)
        self._drain_pending(keep=K)
        return self._stop_flag

    def _train_one_iter_renew(self, g, h, row_weight, fmask, it: int,
                              K: int) -> bool:
        """The synchronous per-tree path (the JAX package's slow path of
        ``train_one_iter``) for objectives that renew leaf outputs
        (``RenewTreeOutput``, serial_tree_learner.cpp:684): each tree comes
        to the host, its leaves are re-fit to percentiles of the residuals,
        and the renewed values update the scores.  Masked bag, no
        compaction."""
        dd = self._dd
        should_stop = True
        for k in range(K):
            tree, node_assign, host = self._grow(dd.bins, g[k], h[k],
                                                 row_weight, fmask, it, k)
            nl = int(host.num_leaves)
            if nl > 1:
                should_stop = False
            t = Tree.from_arrays(host, self.train_data, learning_rate=1.0)
            if nl > 1:
                new_vals = self.objective.renew_leaf_values(
                    node_assign.cpu().numpy(),
                    self._train_score[k].cpu().numpy().astype(np.float64),
                    t.leaf_value.copy(), nl)
                t.leaf_value = np.asarray(new_vals, np.float64)
                tree = tree._replace(leaf_value=torch.as_tensor(
                    t.leaf_value.astype(np.float32)).to(self.device))
            t.shrink(self.shrinkage_rate)
            # the first tree carries the boost-from-average bias; a
            # split-less first tree becomes a constant tree holding it
            if it == 0 and self.init_scores[k] != 0.0:
                if nl > 1:
                    t.add_bias(self.init_scores[k])
                else:
                    t.leaf_value = np.full_like(t.leaf_value,
                                                self.init_scores[k])
            depth = tree_depth(host.left_child, host.right_child, nl)
            if nl > 1:
                self._add_tree_to_scores(k, tree, node_assign, depth,
                                         self.shrinkage_rate)
            self.models.append(t)
            self._device_trees.append(tree)
            self._tree_depths.append(depth)
            self._tree_weights.append(self.shrinkage_rate)
        self.iter_ += 1
        if should_stop:
            Log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
        return should_stop

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
        model with ``average_output`` (RF) averages over its iterations."""
        if self.config.pred_early_stop:
            raise NotPortedError("pred_early_stop is not ported yet")
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
        use_device = models and mode != "host" and (
            mode == "device"
            or X.shape[0] * len(models) >= self._DEVICE_PREDICT_MIN_WORK)
        if use_device:
            out = self._predict_raw_device(models, start_iteration, X)
        else:
            out = np.zeros((X.shape[0], K))
            for ti, t in enumerate(models):
                out[:, ti % K] += t.predict(X)
        if self.average_output:
            out = out / max(1, n_iters)
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
        the host and rounds once, within float32 rounding of this.)"""
        import copy
        check(prev.num_tree_per_iteration == self.num_tree_per_iteration,
              "init_model has a different number of tree per iteration")
        if any(getattr(t, "is_linear", False) for t in prev.models):
            raise NotPortedError("continued training from a linear-tree "
                                 "model is not ported yet")
        self.models = [copy.deepcopy(t) for t in prev.models]
        self._tree_weights = (list(prev._tree_weights)
                              or [1.0] * len(self.models))
        self._device_trees = []
        self._tree_depths = []
        self._ens_cache = None
        K = self.num_tree_per_iteration
        self.iter_ = len(self.models) // K
        ds = self.train_data
        dd = self._dd
        sets = [(dd.bins, self._train_score)] + [
            (v.device_data(self.device).bins, self._valid_scores[i])
            for i, v in enumerate(self.valid_sets)]
        for i, t in enumerate(self.models):
            k = i % K
            bias = self.init_scores[k] if i < K else 0.0
            # a tree that took the bias prints shrinkage 1 (Tree.add_bias)
            rate = (self.shrinkage_rate if bias and t.shrinkage == 1.0
                    else t.shrinkage)
            unshrunk = ((t.leaf_value - bias) / rate).astype(np.float32)
            delta = torch.as_tensor(unshrunk).to(self.device) * rate
            if t.num_leaves <= 1:
                for _, score in sets:
                    score[k] += delta[0]
                continue
            tree, depth = self._binned_tree(t, ds)
            for bins, score in sets:
                leaf = predict_leaf_binned(tree, bins, dd.nan_bins,
                                           depth=depth, efb=dd.efb)
                score[k] += delta[leaf]
        self._prev_scores = None

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
            raise NotPortedError("refit of a linear-tree model is not "
                                 "ported yet")
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
