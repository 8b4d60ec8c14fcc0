"""Multi-process end-to-end training: the Dask-package analog.

Port of the JAX package's ``parallel/trainer.py`` (its in-memory branch;
reference ``python-package/lightgbm/dask.py``): each rank holds a
partition of the rows, ``init_distributed``/``set_network`` wires the
ranks, and every rank runs the same loop with collective histogram merges
and assembles the same model.  Ingest is ``io.distributed.
distributed_dataset`` (pooled-sample binning, identical mappers); an
iteration is ``make_dp_train_step``'s data-parallel step over the ranks'
row blocks, padded to the largest rank's rows (pad rows weigh 0).

As in the JAX package (``src/boosting/gbdt.cpp:228-262`` bagging on the
shared row partition, ``src/objective/rank_objective.hpp:25-67`` rank-local
queries, ``src/boosting/gbdt.cpp:517-575`` synced validation metrics):

- **bagging** (pos/neg fractions too): the Bernoulli mask is drawn from the
  iteration key over the GLOBAL row order, so a multi-process run grows the
  trees of a single process over the concatenated rows;
- **GOSS**: the top-rate cut is a global top-k over every rank's |g*h|
  (one all-gather of the importance an iteration);
- **feature_fraction**: the per-tree mask comes from the seeded numpy
  stream, identical on every rank;
- **lambdarank / rank_xendcg**: queries are rank-local, and so are their
  gradients;
- **EFB**: the bundle layout is planned from the pooled sample, the step
  trains in bundle space, validation traverses unbundled columns;
- **validation metrics**: additive metrics pool (sum, count); AUC pools the
  raw (score, label) pairs exactly; NDCG@k / MAP@k pool per-query means
  weighted by the local query counts.  Early stopping follows the first
  metric, the same on every rank.

A rank whose bin matrix would stream (``Dataset.stream_plan``) raises
``NotPortedError``: the streamed per-rank branch is A21b.
"""
from __future__ import annotations

import hashlib
import json
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..device import NotPortedError, resolve_device
from ..io.distributed import distributed_dataset
from ..utils.log import Log, LightGBMError, check
from ..utils.random_gen import key_for_iteration, uniform
from .data_parallel import make_dp_train_step
from .mesh import default_mesh


def train_distributed(params, data, label, num_boost_round: Optional[int] = None,
                      weight=None, group=None, valid_data=None,
                      valid_group=None,
                      early_stopping_rounds: Optional[int] = None,
                      evals_result: Optional[dict] = None,
                      feature_name=None, categorical_feature=None,
                      device=None):
    """Train over every rank's local partition and return a ``Booster``
    (the same on every rank).

    ``data``/``label``/``weight``/``group`` are THIS rank's rows (and
    rank-local queries); ``valid_data`` an optional ``(X_local, y_local)``
    validation shard with ``valid_group`` its local query sizes.  Needs
    ``parallel.mesh.init_distributed`` to have run; a single process
    trains with the ordinary engine.  ``device=None`` is the card."""
    from ..io.dataset import (_df_has_category_columns, _is_dataframe,
                              _pandas_to_numpy, _require_pandas_mapping)
    dev = resolve_device(device)
    mesh = default_mesh()
    cfg = Config.from_params(dict(params or {}))
    rounds = (num_boost_round if num_boost_round is not None
              else cfg.num_iterations)

    pandas_categorical = None
    valid_is_df = valid_data is not None and _is_dataframe(valid_data[0])
    valid_has_cats = valid_is_df and _df_has_category_columns(valid_data[0])
    if _is_dataframe(data):
        # category-dtype columns become training codes, as in
        # Dataset.construct; the lists ride to the returned Booster
        data, df_names, cat_spec, pandas_categorical = _pandas_to_numpy(
            data, categorical_feature if categorical_feature is not None
            else "auto", None)
        feature_name = feature_name or df_names
        categorical_feature = None if cat_spec == "auto" else cat_spec
    if mesh.size > 1:
        # shards whose category dtypes differ would code the same value
        # differently on different ranks: compare a digest of the lists.
        # The no-mapping guard's predicate rides in the digest, so it
        # raises on every rank or none (a rank-local raise would leave the
        # others blocked in the next collective)
        valid_would_raise = pandas_categorical is None and valid_has_cats
        digest = hashlib.sha256(
            json.dumps([pandas_categorical, valid_would_raise], default=str)
            .encode()).digest()[:8]
        mine = np.frombuffer(digest, dtype=np.int64)
        if not (mesh.gather_np(mine) == mine[None, :]).all():
            raise LightGBMError(
                "pandas categorical levels differ across processes: every "
                "rank must see identical category dtypes (same levels, same "
                "order). Cast columns to a shared CategoricalDtype before "
                "sharding.")
    if valid_is_df:
        _require_pandas_mapping(valid_data[0], pandas_categorical,
                                "validation DataFrame")
        valid_data = (_pandas_to_numpy(valid_data[0], "auto",
                                       pandas_categorical)[0],
                      valid_data[1])

    ds = distributed_dataset(data, cfg, label=label, weight=weight,
                             group=group,
                             categorical_feature=categorical_feature,
                             feature_names=feature_name, mesh=mesh)
    if mesh.size == 1:
        from ..basic import Dataset
        from ..engine import train as _train
        wrapper = Dataset(None, params=dict(params or {}))
        wrapper._inner = ds
        wrapper.pandas_categorical = pandas_categorical
        valid_sets = None
        if valid_data is not None:
            valid_sets = [Dataset(valid_data[0], label=valid_data[1],
                                  group=valid_group, reference=wrapper,
                                  params=dict(params or {}))]
        return _train(dict(params or {}), wrapper, num_boost_round=rounds,
                      valid_sets=valid_sets,
                      early_stopping_rounds=early_stopping_rounds,
                      evals_result=evals_result, device=dev)

    from ..models.gbdt import GBDT
    from ..models.tree import Tree
    from ..objective import create_objective
    from ..ops.grower import _pad_rows
    from ..ops.histogram import movable_bins
    from ..ops.predict import predict_leaf_binned, tree_depth

    objective = create_objective(cfg)
    check(objective is not None,
          "train_distributed requires a built-in objective")
    K = objective.num_model_per_iteration
    is_ranking = getattr(objective, "is_ranking", False)
    check(cfg.boosting in ("gbdt", "goss"),
          "train_distributed supports boosting=gbdt/goss")
    check(cfg.feature_fraction_bynode >= 1.0,
          "train_distributed does not support feature_fraction_bynode")
    check(not cfg.is_unbalance and cfg.scale_pos_weight == 1.0,
          "train_distributed does not support is_unbalance/"
          "scale_pos_weight (class stats would be per-shard, not global)")
    if is_ranking:
        check(group is not None,
              "ranking objectives need rank-local `group` sizes")

    # --- the ranks' row geometry -------------------------------------
    n_local = ds.num_data
    n_locals = mesh.gather_np(np.array([n_local], np.int64)).reshape(-1)
    n_global = int(n_locals.sum())
    my_off = int(n_locals[:mesh.rank].sum())
    label_np = np.asarray(ds.metadata.label, np.float32)
    w_np = (np.asarray(ds.metadata.weight, np.float32)
            if ds.metadata.weight is not None
            else np.ones(n_local, np.float32))

    # --- GLOBAL boost-from-average: only the weighted label sums cross
    # the ranks, then the objective's own formula applies
    inits = [0.0] * K
    if cfg.boost_from_average and not is_ranking:
        if cfg.objective == "regression":
            sums = mesh.gather_np(np.array(
                [float((w_np.astype(np.float64) * label_np).sum()),
                 float(w_np.sum())], np.float64))
            inits = [float(sums[:, 0].sum()) / max(float(sums[:, 1].sum()),
                                                   1e-12)]
        elif cfg.objective in ("binary", "multiclass", "multiclassova"):
            # class-frequency objectives: pool the per-class weighted
            # counts, then feed a C-point weighted surrogate through the
            # objective's own formula (exact: it depends only on the
            # class frequencies)
            C = max(2, cfg.num_class)
            local = np.bincount(label_np.astype(np.int64), weights=w_np,
                                minlength=C).astype(np.float64)
            pooled = mesh.gather_np(local).reshape(-1, C).sum(axis=0)
            from ..io.dataset import Metadata
            surrogate = Metadata(C)
            surrogate.set_field("label", np.arange(C, dtype=np.float64))
            surrogate.set_field("weight", np.maximum(pooled, 1e-12))
            obj2 = create_objective(cfg)
            obj2.init(surrogate, C)
            inits = [obj2.boost_from_score(k) for k in range(K)]
        else:
            Log.warning("train_distributed: boost_from_average for "
                        "objective %s is not pooled globally; starting "
                        "from 0", cfg.objective)

    objective.init(ds.metadata, n_local)     # local stats for gradients

    if ds.stream_plan() is not None:
        raise NotPortedError(
            "not ported yet (A21b): train_distributed over a rank whose bin "
            "matrix streams out of core")

    # --- equal row blocks (pad rows weigh 0) ---------------------------
    per_proc = int(n_locals.max())
    pad = per_proc - n_local

    def on_dev(a):
        return _pad_rows(torch.as_tensor(a).to(dev), per_proc)

    label_d = on_dev(label_np)
    rw_d = on_dev(np.ones(n_local, np.float32))
    w_d = on_dev(w_np)
    # each padded position's TRUE global row: bagging and GOSS draw per-row
    # uniforms over the unpadded global order, so the masks are those of a
    # single process over the concatenated rows (pad rows point at row 0
    # and weigh 0)
    gidx_d = on_dev(my_off + np.arange(n_local, dtype=np.int64))

    tmp = GBDT(cfg, device=dev)
    tmp.train_data = ds
    tmp._dd = dd = ds.device_data(dev)
    gcfg = tmp._make_grower_cfg()
    bins_d = _pad_rows(movable_bins(dd.bins), per_proc).contiguous().view(
        dd.bins.dtype)
    meta = dict(num_bins=dd.num_bins, nan_bins=dd.nan_bins,
                monotone=dd.monotone,
                is_categorical=(dd.is_categorical
                                if bool(dd.is_categorical.any()) else None))
    step = make_dp_train_step(gcfg, meta, None, cfg.learning_rate, mesh,
                              num_class=K, external_grads=True, efb=dd.efb)
    score = torch.tensor(inits, dtype=torch.float32, device=dev)[:, None] \
        .expand(K, per_proc).contiguous()

    # --- gradients: this rank's rows (rank objectives' queries are
    # rank-local by the reference's contract) ---------------------------
    def compute_grads(score):
        if is_ranking:
            g, h = objective.get_gradients(
                score[0, :n_local], label_d[:n_local],
                w_d[:n_local] if ds.metadata.weight is not None else None)
            return _pad_rows(g, per_proc)[None], \
                _pad_rows(h, per_proc)[None]
        if K == 1:
            g, h = objective.get_gradients(score[0], label_d, w_d)
            return g[None], h[None]
        return objective.get_gradients_multi(score, label_d, w_d)

    # --- row sampling: bagging (the seeded global Bernoulli draw) or GOSS
    # (a global top-k over |g*h|) -----------------------------------------
    use_bagging = (cfg.boosting == "gbdt" and cfg.bagging_freq > 0
                   and (cfg.bagging_fraction < 1.0
                        or cfg.pos_bagging_fraction < 1.0
                        or cfg.neg_bagging_fraction < 1.0))
    use_goss = (cfg.boosting == "goss"
                and cfg.top_rate + cfg.other_rate < 1.0)
    bag = {}

    def sample(it, g, h):
        """(row_weight, g, h) of this iteration after bagging/GOSS."""
        if use_bagging:
            from ..models.gbdt import bag_mask_from_uniform
            if it % cfg.bagging_freq == 0:
                key = key_for_iteration(cfg.bagging_seed,
                                        it // cfg.bagging_freq)
                u = uniform(key.to(dev), n_global)[gidx_d]
                bag["mask"] = bag_mask_from_uniform(cfg, u, label_d)
            m = bag["mask"]
            return rw_d * m, g * m, h * m
        if use_goss:
            from ..models.goss import goss_mask_from_importance
            imp = torch.sum(torch.abs(g * h), dim=0) * (rw_d > 0)
            key = key_for_iteration(cfg.bagging_seed, it)
            u = uniform(key.to(dev), n_global)
            # every rank selects over the global padded row order
            imp_all = mesh.all_gather(imp).reshape(-1)
            gidx_all = mesh.all_gather(gidx_d).reshape(-1)
            mask, amplify = goss_mask_from_importance(
                cfg, imp_all, u[gidx_all], max(1, int(cfg.top_rate
                                                      * n_global)))
            mine = slice(mesh.rank * per_proc, (mesh.rank + 1) * per_proc)
            return mask[mine] * rw_d, g * amplify[mine], h * amplify[mine]
        return rw_d, g, h

    # --- this rank's validation shard, binned with the SHARED mappers
    vbins = None
    metrics = []
    check(valid_data is not None or not early_stopping_rounds,
          "early_stopping_rounds requires valid_data")
    if valid_data is not None:
        from ..io.dataset import Dataset as InnerDataset
        vds = InnerDataset.from_data(valid_data[0], cfg,
                                     label=valid_data[1], reference=ds)
        if valid_group is not None:
            vds.metadata.set_field("group", valid_group)
        vbins = torch.as_tensor(vds.unbundled_bins()).to(dev)
        vlabel = np.asarray(vds.metadata.label, np.float64)
        vscore = np.tile(np.asarray(inits, np.float64)[:, None],
                         (1, vds.num_data))
        metrics = _pooled_metrics(cfg, objective, vds, vlabel, mesh)

    trees = []
    completed = rounds
    ev_state = _EvalState(metrics, rounds)
    for it in range(rounds):
        key = key_for_iteration(cfg.seed, it, salt=1)
        g, h = compute_grads(score)
        rw_it, g, h = sample(it, g, h)
        fmask = tmp._feature_mask(it)
        if K == 1:
            score1, tree_arrays = step(bins_d, g[0], h[0], score[0], rw_it,
                                       fmask, key)
            score = score1[None]
        else:
            score, tree_arrays = step(bins_d, g, h, score, rw_it, fmask, key)
        host = [a.cpu().numpy() for a in tree_arrays]
        for k in range(K):
            hk = type(tree_arrays)(*[a if K == 1 else a[k] for a in host])
            t = Tree.from_arrays(hk, ds, learning_rate=1.0)
            t.shrink(cfg.learning_rate)
            # valid scores start AT the init, so they take the shrunk,
            # unbiased leaf values (the bias is the model file's)
            vals_unbiased = np.asarray(t.leaf_value, np.float64).copy()
            nl = int(hk.num_leaves)
            if it == 0 and inits[k] != 0.0:
                if nl > 1:
                    t.add_bias(inits[k])
                else:
                    t.leaf_value = np.full_like(t.leaf_value, inits[k])
            trees.append(t)
            if vbins is not None and nl > 1:
                ta = type(tree_arrays)(*[torch.as_tensor(a).to(dev)
                                         for a in hk])
                leaf = predict_leaf_binned(
                    ta, vbins, dd.nan_bins,
                    depth=tree_depth(hk.left_child, hk.right_child, nl))
                vscore[k] += vals_unbiased[leaf.cpu().numpy()]
        if vbins is not None:
            ev_state.update(metrics, vscore, it)
            if ev_state.should_stop(early_stopping_rounds):
                Log.info("train_distributed: early stop at iter %d "
                         "(best %.6f @ %d)", it + 1,
                         ev_state.best_metric, ev_state.best_iter_num)
                completed = it + 1
                break
    return _assemble_booster(cfg, ds, objective, trees, inits, K, completed,
                             ev_state, evals_result, early_stopping_rounds,
                             pandas_categorical, dev)


class _EvalState:
    """The per-iteration validation bookkeeping and the first metric's
    early-stopping state (the JAX package's ``_EvalState``)."""

    def __init__(self, metrics, rounds):
        self.history: dict = {}
        self.first_hib = metrics[0]["higher_better"] if metrics else False
        self.best_metric = -np.inf if self.first_hib else np.inf
        self.best_iter_num = rounds
        self.since_best = 0

    def update(self, metrics, vscore, it):
        first = True
        for m in metrics:
            for name, val in m["eval"](vscore):
                self.history.setdefault(name, []).append(val)
                if first:
                    better = (val > self.best_metric + 1e-12
                              if self.first_hib
                              else val < self.best_metric - 1e-12)
                    if better:
                        self.best_metric = val
                        self.best_iter_num = it + 1
                        self.since_best = 0
                    else:
                        self.since_best += 1
                    first = False

    def should_stop(self, early_stopping_rounds) -> bool:
        return bool(early_stopping_rounds) and \
            self.since_best >= early_stopping_rounds


def _assemble_booster(cfg, ds, objective, trees, inits, K, completed,
                      ev_state, evals_result, early_stopping_rounds,
                      pandas_categorical, device):
    """The same Booster on every rank, from its model text."""
    from ..basic import Booster
    from ..models import model_io
    from ..models.gbdt import GBDT
    if evals_result is not None and ev_state.history:
        evals_result.setdefault("valid", {}).update(ev_state.history)
    gbdt = GBDT(cfg, device=device)
    gbdt.train_data = ds
    gbdt.objective = objective
    gbdt.models = trees
    gbdt.init_scores = list(inits)
    gbdt.num_tree_per_iteration = K
    gbdt.max_feature_idx = ds.num_total_features - 1
    gbdt.iter_ = completed
    bst = Booster(model_str=model_io.save_model_to_string(gbdt),
                  device=device)
    bst.pandas_categorical = pandas_categorical
    if ev_state.history and early_stopping_rounds:
        bst.best_iteration = ev_state.best_iter_num
    return bst


def _pooled_metrics(cfg, objective, vds, vlabel, mesh):
    """The rank-consistent pooled validation metrics: each entry is
    ``{"name", "higher_better", "eval": vscore -> [(name, value), ...]}``,
    where ``eval`` pools over the ranks:

    - additive metrics (l2, logloss, multi_logloss): (sum, count) pairs;
    - auc: the raw (score, label) pairs are gathered (validation shards are
      small) and every rank runs the exact tie-corrected AUC;
    - ndcg@k / map@k: queries are rank-local, so the local per-query mean
      pools weighted by the local query count.
    """
    names = list(cfg.metric) if cfg.metric else []
    if not names:
        names = [{"regression": "l2", "binary": "binary_logloss",
                  "multiclass": "multi_logloss", "multiclassova":
                  "multi_logloss", "lambdarank": "ndcg",
                  "rank_xendcg": "ndcg"}.get(cfg.objective, "l2")]

    def additive(fn, name):
        def ev(vscore):
            s, c = fn(vscore)
            pooled = mesh.gather_np(np.asarray([s, c], np.float64))
            return [(name, float(pooled[:, 0].sum()
                                 / max(pooled[:, 1].sum(), 1.0)))]
        return ev

    out = []
    for name in names:
        base = name.split("@")[0]
        if base in ("l2", "mse", "regression"):
            out.append({"name": "l2", "higher_better": False,
                        "eval": additive(
                            lambda sc: (float(np.sum((sc[0] - vlabel) ** 2)),
                                        len(vlabel)), "l2")})
        elif base in ("binary_logloss", "logloss"):
            def bl(sc):
                p1 = np.clip(np.asarray(objective.convert_output(sc[0]),
                                        np.float64), 1e-15, 1 - 1e-15)
                ll = -(vlabel * np.log(p1) + (1 - vlabel) * np.log(1 - p1))
                return float(ll.sum()), len(vlabel)
            out.append({"name": "binary_logloss", "higher_better": False,
                        "eval": additive(bl, "binary_logloss")})
        elif base in ("multi_logloss", "multiclass"):
            def ml(sc):
                prob = np.clip(np.asarray(objective.convert_output(sc),
                                          np.float64), 1e-15, 1.0)
                ll = -np.log(prob[vlabel.astype(np.int64),
                                  np.arange(len(vlabel))])
                return float(ll.sum()), len(vlabel)
            out.append({"name": "multi_logloss", "higher_better": False,
                        "eval": additive(ml, "multi_logloss")})
        elif base == "auc":
            # the labels and the shard sizes never change: pool them ONCE;
            # each iteration gathers only the scores
            from ..io.dataset import Metadata
            from ..metric.base import AUCMetric
            n_here = len(vlabel)
            n_max = int(mesh.gather_np(np.array([n_here], np.int64)).max())

            def pads(a):
                return np.pad(np.asarray(a, np.float64),
                              (0, n_max - n_here))
            lab_keep = mesh.gather_np(np.stack(
                [pads(vlabel), pads(np.ones(n_here))]))  # [W, 2, n_max]
            keep = lab_keep[:, 1].ravel() > 0
            nkeep = int(keep.sum())
            md = Metadata(nkeep)
            md.set_field("label", lab_keep[:, 0].ravel()[keep])
            auc_m = AUCMetric(cfg)
            auc_m.init(md, nkeep)

            def auc_ev(vscore, pads=pads, keep=keep, auc_m=auc_m):
                pooled = mesh.gather_np(pads(vscore[0])).reshape(-1)[keep]
                (_, val, _), = auc_m.eval(pooled)
                return [("auc", float(val))]
            out.append({"name": "auc", "higher_better": True,
                        "eval": auc_ev})
        elif base in ("ndcg", "map"):
            from ..metric.rank import MapMetric, NDCGMetric
            cls = NDCGMetric if base == "ndcg" else MapMetric
            m = cls(cfg)
            m.init(vds.metadata, vds.num_data)
            qb = vds.metadata.query_boundaries
            nq_local = len(qb) - 1 if qb is not None else 1

            def rank_ev(vscore, m=m, nq_local=nq_local):
                outv = []
                for mname, val, _ in m.eval(np.asarray(vscore[0],
                                                       np.float64)):
                    pooled = mesh.gather_np(np.asarray(
                        [val * nq_local, nq_local], np.float64))
                    outv.append((mname, float(pooled[:, 0].sum()
                                              / max(pooled[:, 1].sum(), 1))))
                return outv
            out.append({"name": base, "higher_better": True,
                        "eval": rank_ev})
        else:
            Log.warning("train_distributed: metric '%s' is not pooled "
                        "across processes; skipping", name)
    check(bool(out), "no poolable validation metric")
    return out
