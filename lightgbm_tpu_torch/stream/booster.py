"""Streaming boosting engines: GBDT/GOSS over a host-resident bin matrix.

Port of the JAX package's ``stream/booster.py``.  ``StreamGBDT`` keeps the
training loop's per-row state on the HOST — raw scores ``[K, N]`` float32
(CPU tensors), gradients and hessians, bagging masks, leaf assignments —
and drives ``StreamTreeGrower`` for tree growth, so the only device
residents are the streamed row blocks (bounded by the
``max_bin_matrix_bytes`` budget), the ``[L, F, B, 3]`` histogram store and
the per-feature metadata.  Gradients are computed a row block at a time on
the device from the host scores (``stream_gradients``), the objective's
elementwise math row for row as the in-memory engine runs it; the bagging
and GOSS draws are the in-memory engine's, over the global row order, on
the device (the port's threefry, ``utils/random_gen.py``).

Scope (checked loudly at construction): single-process serial training,
elementwise or leaf-renewing objectives and custom gradients, bagging (with
pos/neg fractions) and GOSS, categorical features, basic monotone
constraints, feature_fraction (by tree and by node), extra_trees,
feature_contri and max_depth.  Refused: linear trees, CEGB, interaction
constraints, forced splits, the intermediate and advanced monotone
methods, ranking objectives (query-coupled gradients), DART and RF.
Distributed streaming waits for the distributed slice, as does every
``tree_learner`` other than serial (``NotPortedError``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..io.dataset import Dataset
from ..metric import create_metrics
from ..models.gbdt import GBDT, bag_mask_from_uniform, check_ported
from ..models.goss import goss_mask_from_importance
from ..models.tree import Tree
from ..objective import create_objective
from ..obs import health as obs_health
from ..ops.grower import TreeArrays
from ..ops.predict import predict_leaf_binned, tree_depth
from ..utils.log import LightGBMError, Log, check
from ..utils.random_gen import key_for_iteration, uniform
from ..utils.timer import global_timer
from .grower import StreamTreeGrower, make_shards
from .pipeline import PipelineStats


def stream_gradients(objective, score: torch.Tensor, label, weight,
                     block_rows: int, device):
    """Per-block objective gradients from host-resident scores: ``score``
    is a host ``[K, n]`` float32 tensor, ``label``/``weight`` host arrays
    (or None); each block runs on ``device``.  Returns host ``(g, h)``
    ``[K, n]`` float32 numpy."""
    if objective is None:
        raise LightGBMError("objective is None; provide custom grad/hess")
    K, n = score.shape
    g = np.empty((K, n), np.float32)
    h = np.empty((K, n), np.float32)

    def dev(a, s, e):
        return None if a is None else torch.as_tensor(a[s:e]).to(device)
    for s in range(0, n, block_rows):
        e = min(s + block_rows, n)
        sc = score[:, s:e].to(device)
        lab, w = dev(label, s, e), dev(weight, s, e)
        if K > 1:
            gg, hh = objective.get_gradients_multi(sc, lab, w)
        else:
            gg, hh = objective.get_gradients(sc[0], lab, w)
            gg, hh = gg[None, :], hh[None, :]
        g[:, s:e] = gg.cpu().numpy()
        h[:, s:e] = hh.cpu().numpy()
    return g, h


def stream_bag_mask(cfg: Config, iteration: int, n: int, label,
                    device) -> np.ndarray:
    """Host bagging mask over the global row order: the in-memory engine's
    draw (``key_for_iteration(bagging_seed, it // bagging_freq)``,
    ``bag_mask_from_uniform``) on ``device``."""
    key = key_for_iteration(cfg.bagging_seed, iteration // cfg.bagging_freq)
    u = uniform(key.to(device), n)
    lab = torch.as_tensor(label).to(device) if label is not None else None
    return bag_mask_from_uniform(cfg, u, lab).cpu().numpy()


def stream_goss_sample(cfg: Config, iteration: int, g: np.ndarray,
                       h: np.ndarray, device):
    """``(mask, amplify)`` host arrays of the in-memory GOSS draw over the
    global row order: the importance ``sum_k |g h|``, the exact top
    ``top_rate`` rows and the seeded tail draw, on ``device``."""
    n = g.shape[1]
    imp = torch.sum(torch.abs(torch.as_tensor(g).to(device)
                              * torch.as_tensor(h).to(device)), dim=0)
    key = key_for_iteration(cfg.bagging_seed, iteration).to(device)
    mask, amplify = goss_mask_from_importance(
        cfg, imp, uniform(key, n), max(1, int(cfg.top_rate * n)))
    return mask.cpu().numpy(), amplify.cpu().numpy()


def _finite_stats(a) -> dict:
    """Host-side sentinel stats (the streaming twin of the device
    reductions in ``GBDT._health_stats``)."""
    a = np.asarray(a, np.float32).ravel()
    finite = np.isfinite(a)
    mx = float(np.abs(a[finite]).max()) if finite.any() else 0.0
    return {"finite_frac": float(finite.mean()), "max_abs": mx}


class StreamGBDT(GBDT):
    """Out-of-core GBDT engine (see module docstring)."""

    # ------------------------------------------------------------------
    def init_train(self, train_data: Dataset) -> None:
        cfg = self.config
        check_ported(cfg)
        self.train_data = train_data
        plan = train_data.stream_plan()
        check(plan is not None,
              "StreamGBDT needs a Dataset whose stream_plan() streams "
              "(set max_bin_matrix_bytes/stream_rows)")
        self._plan = plan
        self._check_supported(cfg)
        if self.objective is None:
            self.objective = create_objective(cfg)
        if self.objective is not None:
            if getattr(self.objective, "is_ranking", False):
                raise LightGBMError(
                    "out-of-core streaming does not support ranking "
                    "objectives (query-coupled gradients cannot be computed "
                    "per row block)")
            self.objective.init(train_data.metadata, train_data.num_data)
            self.num_tree_per_iteration = \
                self.objective.num_model_per_iteration
        else:
            self.num_tree_per_iteration = max(1, cfg.num_class)
        self.max_feature_idx = train_data.num_total_features - 1
        self.train_metrics = create_metrics(cfg)
        for m in self.train_metrics:
            m.init(train_data.metadata, train_data.num_data)

        # feature metadata WITHOUT bins: the matrix stays in host RAM
        self._dd = train_data.device_meta(self.device)
        md = train_data.metadata
        self._label_np = md.label
        self._weight_np = md.weight
        K = self.num_tree_per_iteration
        n = train_data.num_data
        # boost from average / init_score (host scores)
        init = np.zeros((K, n), dtype=np.float32)
        self.init_scores = [0.0] * K
        if md.init_score is not None:
            init += md.init_score.reshape(-1, n).astype(np.float32)
        elif cfg.boost_from_average and self.objective is not None:
            for k in range(K):
                s = self.objective.boost_from_score(k)
                self.init_scores[k] = s
                init[k] += s
        self._train_score = torch.as_tensor(init)
        self._grower_cfg = self._make_grower_cfg()
        self._contri = self._feature_contri_vec()

        self.stream_stats = PipelineStats()
        self._matrix = train_data.host_bin_matrix(plan)
        meta = {k: getattr(self._dd, k).cpu().numpy() for k in
                ("num_bins", "default_bins", "nan_bins", "is_categorical",
                 "monotone")}
        self._stream_grower = StreamTreeGrower(
            make_shards([self._matrix], plan.prefetch, self.stream_stats,
                        self.device),
            meta, self._grower_cfg, feature_contri=self._contri,
            device=self.device)
        self._valid_stream = {}
        self._bag_mask_np = None
        Log.info(
            "out-of-core streaming: %.1f MB bin matrix vs %s budget -> "
            "%d blocks of %d rows (prefetch %d, ~%.1f MB device-resident)",
            plan.total_bytes / 1e6,
            ("%.1f MB" % (plan.budget_bytes / 1e6) if plan.budget_bytes
             else "stream_rows"),
            plan.num_blocks, plan.block_rows, plan.prefetch,
            (plan.prefetch + 1) * self._matrix.block_nbytes / 1e6)

    @staticmethod
    def _check_supported(cfg: Config) -> None:
        bad = []
        if cfg.linear_tree:
            bad.append("linear_tree")
        if cfg.interaction_constraints:
            bad.append("interaction_constraints")
        if cfg.forcedsplits_filename:
            bad.append("forcedsplits_filename")
        if (cfg.cegb_tradeoff * cfg.cegb_penalty_split > 0
                or cfg.cegb_penalty_feature_lazy
                or cfg.cegb_penalty_feature_coupled):
            bad.append("cegb penalties")
        if (any(v != 0 for v in cfg.monotone_constraints)
                and cfg.monotone_constraints_method != "basic"):
            bad.append("monotone_constraints_method="
                       + cfg.monotone_constraints_method)
        if bad:
            raise LightGBMError(
                "out-of-core streaming does not support: " + ", ".join(bad))

    # ------------------------------------------------------------------
    def add_valid_data(self, valid_data: Dataset, name: str) -> None:
        super().add_valid_data(valid_data, name)
        # the scores live on the host, as the training set's do
        self._valid_scores[-1] = self._valid_scores[-1].cpu()

    def _score_sets(self):
        """The streamed counterpart of ``GBDT._score_sets``: the training
        set's leaves a block at a time, each valid set's streamed or
        device-resident as its own plan says; host scores."""
        return [(self._stream_leaf(self._matrix), self._train_score)] + [
            (lambda t, d, vi=vi: self._valid_leaf(vi, t, d),
             self._valid_scores[vi]) for vi in range(len(self.valid_sets))]

    # ------------------------------------------------------------------
    def _stream_leaf(self, matrix):
        """``(tree, depth) -> leaf [n]`` (CPU int64) of a host matrix's
        rows, one block on the device at a time."""
        def leaf(tree, depth):
            out = torch.empty(matrix.num_data, dtype=torch.int64)
            for b in range(matrix.num_blocks):
                sl = matrix.block_slice(b)
                blk = torch.as_tensor(matrix.block(b)).to(self.device)
                out[sl] = predict_leaf_binned(
                    tree, blk, self._dd.nan_bins, depth=depth).cpu()
            return out
        return leaf

    def _valid_leaf(self, vi: int, tree, depth: int) -> torch.Tensor:
        """Leaf index (CPU) of every row of valid set ``vi``: streamed a
        block at a time when the valid set is itself over budget,
        device-resident otherwise."""
        if vi not in self._valid_stream:
            vset = self.valid_sets[vi]
            vplan = vset.stream_plan()
            self._valid_stream[vi] = (
                self._stream_leaf(vset.host_bin_matrix(vplan)) if vplan
                else (lambda t, d, b=vset.device_data(self.device).bins:
                      predict_leaf_binned(t, b, self._dd.nan_bins,
                                          depth=d).cpu()))
        return self._valid_stream[vi](tree, depth)

    # ------------------------------------------------------------------
    def _stream_row_sample(self, iteration: int, g, h):
        """Bagging mask + masked gradients, host-side; the draw is the
        in-memory engine's (``stream_bag_mask``)."""
        cfg = self.config
        need = cfg.bagging_freq > 0 and (cfg.bagging_fraction < 1.0 or
                                         cfg.pos_bagging_fraction < 1.0 or
                                         cfg.neg_bagging_fraction < 1.0)
        if not need:
            return None, g, h
        # a run continued mid-period has no bag yet: it draws the period's
        if iteration % cfg.bagging_freq == 0 or self._bag_mask_np is None:
            self._bag_mask_np = stream_bag_mask(
                cfg, iteration, self.train_data.num_data, self._label_np,
                self.device)
        mask = self._bag_mask_np
        return mask, g * mask[None, :], h * mask[None, :]

    # ------------------------------------------------------------------
    def train_one_iter(self, grad: Optional[np.ndarray] = None,
                       hess: Optional[np.ndarray] = None) -> bool:
        cfg = self.config
        K = self.num_tree_per_iteration
        n = self.train_data.num_data
        it = self.iter_
        if self._stop_flag:
            Log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            return True
        obs = self._obs
        if obs is not None:
            obs.phase_mark()
            obs.tracer.begin("train/iteration", step=it)
        with global_timer.scope("StreamGBDT::gradients"):
            if grad is None or hess is None:
                g, h = stream_gradients(self.objective, self._train_score,
                                        self._label_np, self._weight_np,
                                        self._plan.block_rows, self.device)
            else:
                g = np.asarray(grad, np.float32).reshape(K, n)
                h = np.asarray(hess, np.float32).reshape(K, n)
        mask, g, h = self._stream_row_sample(it, g, h)
        rw = mask if mask is not None else np.ones(n, np.float32)
        fmask = self._feature_mask(it).cpu().numpy()
        gcfg = self._grower_cfg
        self._prev_scores = (self._train_score.clone(),
                             [v.clone() for v in self._valid_scores])

        should_stop = True
        for k in range(K):
            key = (key_for_iteration(cfg.seed, it, salt=k + 1)
                   if gcfg.feature_fraction_bynode < 1.0 or gcfg.extra_trees
                   else None)
            with global_timer.scope("StreamGBDT::grow_tree"):
                host, node_assign = self._stream_grower.grow(
                    g[k], h[k], rw, fmask, key)
            nl = int(host.num_leaves)
            if self._health_due(it, k):
                # the streamed gradients and leaves are host numpy already
                obs_health.check_numeric(
                    {"grad": _finite_stats(g[k]),
                     "hess": _finite_stats(h[k]),
                     "leaf_value": _finite_stats(host.leaf_value)},
                    iteration=it, kind="stream",
                    log=obs.log if obs is not None else None)
            if nl > 1:
                should_stop = False
            if obs is not None:
                obs.tree_event(it, num_leaves=nl, split_gains=[
                    float(v) for v in host.split_gain[:max(0, nl - 1)]])
            tree = Tree.from_arrays(host, self.train_data, learning_rate=1.0)
            # leaf renewal for L1-style objectives: the host state is what
            # the renewal reads (per-row leaf ids and scores)
            if (self.objective is not None
                    and self.objective.need_renew_tree_output() and nl > 1):
                new_vals = self.objective.renew_leaf_values(
                    node_assign, self._train_score[k].numpy().astype(
                        np.float64), tree.leaf_value.copy(), nl)
                tree.leaf_value = np.asarray(new_vals, np.float64)
                host = host._replace(
                    leaf_value=tree.leaf_value.astype(np.float32))
            tree.shrink(self.shrinkage_rate)
            if it == 0 and self.init_scores[k] != 0.0:
                if nl > 1:
                    tree.add_bias(self.init_scores[k])
                else:
                    tree.leaf_value = np.full_like(tree.leaf_value,
                                                   self.init_scores[k])
            with global_timer.scope("StreamGBDT::update_score"):
                if nl > 1:
                    delta = (torch.as_tensor(host.leaf_value)
                             * self.shrinkage_rate)
                    self._train_score[k] += delta[torch.as_tensor(
                        node_assign, dtype=torch.int64)]
                    if self.valid_sets:
                        depth = tree_depth(host.left_child,
                                           host.right_child, nl)
                        tdev = TreeArrays(*[torch.as_tensor(a).to(
                            self.device) for a in host])
                        for vi in range(len(self.valid_sets)):
                            self._valid_scores[vi][k] += delta[
                                self._valid_leaf(vi, tdev, depth)]
            self.models.append(tree)
            self._tree_weights.append(self.shrinkage_rate)
        self.iter_ += 1
        if obs is not None:
            obs.tracer.end("train/iteration")
            obs.iteration_event(it, trees=K)
        elif self._health_enabled:
            obs_health.set_status(stage="stream", iteration=it)
        if should_stop:
            Log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            self._stop_flag = True
        return should_stop


class StreamGOSS(StreamGBDT):
    """GOSS sampling over the streaming engine: the in-memory GOSS's
    top-rate cut and tail draw with the same keying, so the sampled rows
    match."""

    def _stream_row_sample(self, iteration: int, g, h):
        cfg = self.config
        if cfg.top_rate + cfg.other_rate >= 1.0:
            return None, g, h
        mask, amplify = stream_goss_sample(cfg, iteration, g, h, self.device)
        amplify = amplify[None, :]
        return mask, g * amplify, h * amplify
