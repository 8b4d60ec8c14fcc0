"""Training entry points: ``train()`` and ``cv()`` (reference
``python-package/lightgbm/engine.py:15,392``).

Port of the JAX package's ``engine.py``: ``train`` with its positional
order and every argument (custom objective ``fobj`` and metric ``feval``,
``init_model``, ``learning_rates``, ``snapshot_freq`` checkpoints), and
``cv`` over ``Dataset.subset`` folds drawn with numpy, returning a
``CVBooster`` on request.  Both take ``device`` last: ``None`` means the
CUDA card, ``"cpu"`` the plain PyTorch path.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import callback as callback_mod
from .basic import Booster, Dataset
from .models.gbdt import host_scores

__all__ = ["train", "cv", "CVBooster"]

_NUM_ROUND_ALIASES = ("num_iterations", "num_iteration", "n_iter", "num_tree",
                      "num_trees", "num_round", "num_rounds",
                      "num_boost_round", "n_estimators")
_EARLY_STOP_ALIASES = ("early_stopping_round", "early_stopping_rounds",
                       "early_stopping", "n_iter_no_change")


def _apply_dataset_kwargs(train_set: Dataset, feature_name,
                          categorical_feature) -> None:
    """Shared by train()/cv(): the reference applies these kwargs to the
    training Dataset before construction (``engine.py:96-99``)."""
    if feature_name != "auto":
        train_set.set_feature_name(feature_name)
    if categorical_feature != "auto":
        train_set.set_categorical_feature(categorical_feature)


def _sorted_callbacks(cbs):
    before = sorted((cb for cb in cbs if getattr(cb, "before_iteration", False)),
                    key=lambda cb: getattr(cb, "order", 0))
    after = sorted((cb for cb in cbs if not getattr(cb, "before_iteration", False)),
                   key=lambda cb: getattr(cb, "order", 0))
    return before, after


def train(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          fobj: Optional[Callable] = None, feval: Optional[Callable] = None,
          init_model=None,
          feature_name: Any = "auto", categorical_feature: Any = "auto",
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[Dict] = None,
          verbose_eval: Any = True, learning_rates: Any = None,
          keep_training_booster: bool = False,
          callbacks: Optional[List[Callable]] = None,
          device=None) -> Booster:
    """Train a booster on ``device`` (None: the CUDA card, raising without
    one; ``"cpu"``: the plain PyTorch path).  The positional order is the
    reference's; ``init_model`` is a model file or a ``Booster``."""
    params = dict(params or {})
    _apply_dataset_kwargs(train_set, feature_name, categorical_feature)
    for alias in _NUM_ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
    for alias in _EARLY_STOP_ALIASES:
        if alias in params:
            early_stopping_rounds = int(params.pop(alias))
    if fobj is not None:
        params["objective"] = "none"

    booster = Booster(params=params, train_set=train_set, device=device)
    contains_train = False
    if valid_sets:
        user_named = valid_names is not None
        valid_names = valid_names or [f"valid_{i}" for i in range(len(valid_sets))]
        for vs, name in zip(valid_sets, valid_names):
            if vs is train_set:
                # the training set is evaluated as such, under the caller's
                # name; it is not a valid set
                contains_train = True
                booster._gbdt.config.is_provide_training_metric = True
                if user_named:
                    booster.set_train_data_name(name)
                continue
            booster.add_valid(vs, name)

    if init_model is not None:
        prev = (Booster(model_file=init_model, device=booster.device)
                if isinstance(init_model, str) else init_model)
        booster._gbdt.continue_from(prev._gbdt)

    cbs = list(callbacks or [])
    if learning_rates is not None:
        # a list or callable(iteration) -> the reset_parameter callback
        cbs.append(callback_mod.reset_parameter(learning_rate=learning_rates))
    if verbose_eval is True:
        cbs.append(callback_mod.print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval > 0:
        cbs.append(callback_mod.print_evaluation(verbose_eval))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.append(callback_mod.early_stopping(early_stopping_rounds))
    if evals_result is not None:
        cbs.append(callback_mod.record_evaluation(evals_result))
    cbs_before, cbs_after = _sorted_callbacks(cbs)

    snapshot_freq = booster._gbdt.config.snapshot_freq
    evaluation_result_list = []
    for i in range(num_boost_round):
        for cb in cbs_before:
            cb(callback_mod.CallbackEnv(booster, params, i, 0, num_boost_round, None))
        stopped = booster.update(fobj=fobj)
        if snapshot_freq > 0 and (i + 1) % snapshot_freq == 0:
            # a checkpoint every snapshot_freq iterations (reference
            # GBDT::Train, gbdt.cpp:277-281)
            booster.save_model(
                f"{booster._gbdt.config.output_model}.snapshot_iter_{i + 1}")

        evaluation_result_list = []
        if booster._gbdt.valid_sets or booster._gbdt.config.is_provide_training_metric:
            evaluation_result_list = booster._gbdt.eval_current()
        if feval is not None:
            # feval's own rows: the builtin metrics are already listed
            if contains_train:
                evaluation_result_list.extend(booster._feval_results(
                    getattr(booster, "_train_data_name", "training"), -1,
                    feval))
            for vi, vname in enumerate(booster.name_valid_sets):
                evaluation_result_list.extend(
                    booster._feval_results(vname, vi, feval))
        try:
            for cb in cbs_after:
                cb(callback_mod.CallbackEnv(booster, params, i, 0, num_boost_round,
                                            evaluation_result_list))
        except callback_mod.EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            for name, metric, score, _ in (e.best_score or []):
                booster.best_score.setdefault(name, {})[metric] = score
            break
        if stopped:
            break
    if booster.best_iteration < 0 and evaluation_result_list:
        for name, metric, score, _ in evaluation_result_list:
            booster.best_score.setdefault(name, {})[metric] = score
    return booster


class CVBooster:
    """The boosters of the folds (reference ``engine.py:278``); any other
    method call goes to each booster in turn and returns the list."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler_function


def _make_n_folds(full_data: Dataset, nfold: int, params, seed: int,
                  stratified: bool, shuffle: bool):
    """``(train_idx, test_idx)`` of each fold, drawn with numpy: rows dealt
    round-robin in label order (stratified) or in a permuted order."""
    num_data = full_data.num_data()
    label = full_data.get_label()
    rng = np.random.default_rng(seed)
    folds_assign = np.empty(num_data, np.int64)
    if stratified and label is not None:
        order = np.argsort(label, kind="stable")
        folds_assign[order] = np.arange(num_data) % nfold
        if shuffle:
            folds_assign = rng.permutation(nfold)[folds_assign]
    else:
        idx = rng.permutation(num_data) if shuffle else np.arange(num_data)
        folds_assign[idx] = np.arange(num_data) % nfold
    for k in range(nfold):
        yield (np.where(folds_assign != k)[0], np.where(folds_assign == k)[0])


def cv(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True, shuffle: bool = True,
       metrics=None, fobj=None, feval=None, init_model=None,
       feature_name="auto", categorical_feature="auto",
       early_stopping_rounds: Optional[int] = None, fpreproc=None,
       verbose_eval=None, show_stdv: bool = True, seed: int = 0,
       callbacks=None, eval_train_metric: bool = False,
       return_cvbooster: bool = False, device=None) -> Dict[str, List[float]]:
    """Cross-validation (reference ``engine.py:392``): a booster a fold on
    ``device``, the mean and stdv of each metric over the folds an
    iteration, an optional ``fpreproc(dtrain, dtest, params)`` a fold, and
    callbacks over the aggregate (``cv_agg``) results.  ``init_model`` is
    accepted and unused, as in the JAX package."""
    params = dict(params or {})
    if metrics is not None:
        params["metric"] = metrics
    if params.get("objective") in (None, "regression") and stratified:
        stratified = False

    _apply_dataset_kwargs(train_set, feature_name, categorical_feature)
    train_set.construct(device)
    results: Dict[str, List[float]] = {}
    cvbooster = CVBooster()

    if folds is None:
        folds = list(_make_n_folds(train_set, nfold, params, seed, stratified, shuffle))
    elif hasattr(folds, "split"):
        folds = list(folds.split(np.zeros(train_set.num_data()),
                                 train_set.get_label()))

    for train_idx, test_idx in folds:
        tr = train_set.subset(train_idx)
        te = train_set.subset(test_idx)
        fold_params = dict(params)
        if fpreproc is not None:
            tr, te, fold_params = fpreproc(tr, te, dict(params))
        bst = Booster(params=fold_params, train_set=tr,
                      device=train_set.device)
        bst.add_valid(te, "valid")
        cvbooster.append(bst)

    cbs = list(callbacks or [])
    if verbose_eval:
        period = 1 if verbose_eval is True else int(verbose_eval)
        cbs.append(callback_mod.print_evaluation(period, show_stdv))
    cbs_before, cbs_after = _sorted_callbacks(cbs)

    best_iter = num_boost_round
    no_improve = 0
    best_mean: Dict[str, float] = {}
    for i in range(num_boost_round):
        for cb in cbs_before:
            cb(callback_mod.CallbackEnv(cvbooster, params, i, 0,
                                        num_boost_round, None))
        agg: Dict[str, List[float]] = {}
        hib_map: Dict[str, bool] = {}

        def add(key, val, hib):
            agg.setdefault(key, []).append(val)
            hib_map[key] = hib

        for bst in cvbooster.boosters:
            bst.update(fobj=fobj)
            for name, metric, val, hib in bst._gbdt.eval_current():
                if name == "training" and not eval_train_metric:
                    continue
                add(f"{name} {metric}", val, hib)
            if feval is not None:
                # the python-level Datasets; training too when asked
                evals = [("valid", bst._gbdt._valid_scores[0],
                          bst.valid_sets_py[0] if bst.valid_sets_py else None)]
                if eval_train_metric:
                    evals.append(("training", bst._gbdt._train_score,
                                  bst.train_set))
                for ename, score, dset in evals:
                    s = host_scores(score)
                    fres = feval(s[0] if bst._gbdt.num_tree_per_iteration == 1
                                 else s, dset)
                    if isinstance(fres, tuple):
                        fres = [fres]
                    for mname, val, hib in fres:
                        add(f"{ename} {mname}", val, hib)
        env_list = [("cv_agg", key, float(np.mean(vals)), hib_map[key],
                     float(np.std(vals))) for key, vals in agg.items()]
        for key, vals in agg.items():
            results.setdefault(f"{key}-mean", []).append(float(np.mean(vals)))
            results.setdefault(f"{key}-stdv", []).append(float(np.std(vals)))
        stop_now = False
        try:
            for cb in cbs_after:
                cb(callback_mod.CallbackEnv(cvbooster, params, i, 0,
                                            num_boost_round, env_list))
        except callback_mod.EarlyStopException as e:
            best_iter = e.best_iteration + 1
            stop_now = True
        if early_stopping_rounds and agg and not stop_now:
            key0 = next(iter(agg))
            mean0 = float(np.mean(agg[key0]))
            better = (mean0 > best_mean.get(key0, -np.inf)) if hib_map[key0] \
                else (mean0 < best_mean.get(key0, np.inf))
            if better:
                best_mean[key0] = mean0
                best_iter = i + 1
                no_improve = 0
            else:
                no_improve += 1
                if no_improve >= early_stopping_rounds:
                    stop_now = True
        if stop_now:
            for key in list(results):
                results[key] = results[key][:best_iter]
            break
    cvbooster.best_iteration = best_iter
    if return_cvbooster:
        results["cvbooster"] = cvbooster
    return results
