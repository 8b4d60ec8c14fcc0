"""Training callbacks (reference ``python-package/lightgbm/callback.py``):
``print_evaluation``/``log_evaluation``, ``record_evaluation``,
``reset_parameter``, ``early_stopping`` — same env-closure protocol."""
from __future__ import annotations

import collections
from typing import Callable, Dict, List

from .utils.log import Log


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def print_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list and \
                (env.iteration + 1) % period == 0:
            def fmt(entry):
                # cv passes 5-tuples carrying the across-fold stdv
                if len(entry) == 5 and show_stdv:
                    n, m, v, _, sd = entry
                    return f"{n}'s {m}: {v:g} + {sd:g}"
                n, m, v = entry[0], entry[1], entry[2]
                return f"{n}'s {m}: {v:g}"
            result = "\t".join(
                fmt(e) for e in env.evaluation_result_list)
            Log.info("[%d]\t%s", env.iteration + 1, result)
    _callback.order = 10
    return _callback


log_evaluation = print_evaluation


def record_evaluation(eval_result: Dict) -> Callable:
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")

    def _init(env: CallbackEnv) -> None:
        eval_result.clear()
        for name, metric, *_ in env.evaluation_result_list:
            eval_result.setdefault(name, collections.OrderedDict())
            eval_result[name].setdefault(metric, [])

    def _callback(env: CallbackEnv) -> None:
        if not eval_result:
            _init(env)
        for name, metric, value, *_ in env.evaluation_result_list:
            eval_result.setdefault(name, collections.OrderedDict()).setdefault(
                metric, []).append(value)
    _callback.order = 20
    return _callback


def reset_parameter(**kwargs) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        new_params = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(f"Length of list {key} has to equal to 'num_boost_round'.")
                new_params[key] = value[env.iteration - env.begin_iteration]
            elif callable(value):
                new_params[key] = value(env.iteration - env.begin_iteration)
            else:
                # reference callback.reset_parameter: anything else is a
                # user error, not a silent no-op
                raise ValueError(
                    "Only list and callable values are supported "
                    f"as a mapping from boosting round index to new "
                    f"parameter value (got {type(value).__name__} for "
                    f"{key!r}).")
        if new_params:
            # route through Booster.reset_parameter so compile-time grower
            # params (num_leaves, min_data_in_leaf, ...) genuinely re-apply
            # (reference model.reset_parameter(new_parameters))
            env.model.reset_parameter(new_params)
            for k, v in new_params.items():
                env.params[k] = v
    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True) -> Callable:
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List[list] = []
    cmp_op: List[Callable] = []
    enabled = [True]
    first_metric = [""]

    def _init(env: CallbackEnv) -> None:
        enabled[0] = not any(env.params.get(alias, "") == "dart"
                             for alias in ("boosting", "boosting_type", "boost"))
        if not enabled[0]:
            Log.warning("Early stopping is not available in dart mode")
            return
        if not env.evaluation_result_list:
            raise ValueError("For early stopping, at least one dataset and eval metric is required for evaluation")
        if verbose:
            Log.info("Training until validation scores don't improve for %d rounds", stopping_rounds)
        # cv entries carry composite "<set> <metric>" keys; compare
        # bare metric names (reference .split(" ")[-1])
        first_metric[0] = env.evaluation_result_list[0][1].split(" ")[-1]
        for entry in env.evaluation_result_list:
            name, metric, higher_better = entry[0], entry[1], entry[3]
            best_iter.append(0)
            best_score_list.append(None)
            if higher_better:
                best_score.append(float("-inf"))
                cmp_op.append(lambda x, y: x > y)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda x, y: x < y)

    def _callback(env: CallbackEnv) -> None:
        if not cmp_op:
            _init(env)
        if not enabled[0]:
            return
        # CVBooster's __getattr__ fabricates a handler for any attribute, so
        # only trust a real string here (cv's train rows are the cv_agg case)
        train_name = getattr(env.model, "_train_data_name", "training")
        if not isinstance(train_name, str):
            train_name = "training"
        for i, entry in enumerate(env.evaluation_result_list):
            name, metric, score = entry[0], entry[1], entry[2]
            if best_score_list[i] is None or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            if first_metric_only and first_metric[0] != metric.split(" ")[-1]:
                continue
            if (name == "training" or name == train_name
                    or (name == "cv_agg" and metric.startswith("train"))):
                continue
            if env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    Log.info("Early stopping, best iteration is: [%d]", best_iter[i] + 1)
                raise EarlyStopException(best_iter[i], best_score_list[i])
            if env.iteration == env.end_iteration - 1:
                if verbose:
                    Log.info("Did not meet early stopping. Best iteration is: [%d]", best_iter[i] + 1)
                raise EarlyStopException(best_iter[i], best_score_list[i])
    _callback.order = 30
    return _callback
