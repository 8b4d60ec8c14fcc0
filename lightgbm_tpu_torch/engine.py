"""Training entry point ``train()`` (reference
``python-package/lightgbm/engine.py:15``; loop at ``:230-270``).

Port of the JAX package's ``train`` with ``valid_sets``, early stopping,
``evals_result`` and callbacks.  Not ported yet: ``fobj``/``feval``,
``init_model``, ``learning_rates`` and ``cv``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from . import callback as callback_mod
from .basic import Booster, Dataset

__all__ = ["train"]


def train(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[Dict] = None,
          verbose_eval: Any = True,
          callbacks: Optional[List[Callable]] = None,
          device=None) -> Booster:
    """Train a booster on ``device`` (None: the CUDA card, raising without
    one; ``"cpu"``: the plain PyTorch path)."""
    params = dict(params or {})
    for alias in ("num_iterations", "num_iteration", "n_iter", "num_tree", "num_trees",
                  "num_round", "num_rounds", "num_boost_round", "n_estimators"):
        if alias in params:
            num_boost_round = int(params.pop(alias))
    for alias in ("early_stopping_round", "early_stopping_rounds", "early_stopping",
                  "n_iter_no_change"):
        if alias in params:
            early_stopping_rounds = int(params.pop(alias))

    booster = Booster(params=params, train_set=train_set, device=device)
    if valid_sets:
        user_named = valid_names is not None
        valid_names = valid_names or [f"valid_{i}" for i in range(len(valid_sets))]
        for vs, name in zip(valid_sets, valid_names):
            if vs is train_set:
                booster._gbdt.config.is_provide_training_metric = True
                if user_named:
                    booster.set_train_data_name(name)
                continue
            booster.add_valid(vs, name)

    cbs = list(callbacks or [])
    if verbose_eval is True:
        cbs.append(callback_mod.print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval > 0:
        cbs.append(callback_mod.print_evaluation(verbose_eval))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.append(callback_mod.early_stopping(early_stopping_rounds))
    if evals_result is not None:
        cbs.append(callback_mod.record_evaluation(evals_result))
    cbs_before = [cb for cb in cbs if getattr(cb, "before_iteration", False)]
    cbs_after = [cb for cb in cbs if not getattr(cb, "before_iteration", False)]
    cbs_before.sort(key=lambda cb: getattr(cb, "order", 0))
    cbs_after.sort(key=lambda cb: getattr(cb, "order", 0))

    evaluation_result_list = []
    for i in range(num_boost_round):
        for cb in cbs_before:
            cb(callback_mod.CallbackEnv(booster, params, i, 0, num_boost_round, None))
        stopped = booster.update()
        evaluation_result_list = []
        if booster._gbdt.valid_sets or booster._gbdt.config.is_provide_training_metric:
            evaluation_result_list = booster._gbdt.eval_current()
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
