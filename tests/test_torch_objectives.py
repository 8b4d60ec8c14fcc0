"""PyTorch port, the objectives and metrics beyond binary, against the JAX
package on the CPU.

Each objective's gradients, hessians, initial score and output transform
match the JAX one's on fixed scores (float32 ops in the same order; XLA's
and PyTorch's ``exp`` may differ by an ulp, which a difference such as
``exp(s) - y`` keeps: 1e-6 absolute), and each trains the JAX package's
trees: the same model text apart from float digits, leaf values within
1e-5 (L1 and quantile renew their leaves to residual percentiles on the
synchronous path) and predictions within 5e-6 (relative to a prediction
above 1: Poisson's are counts), raw scores within 2e-5, on a regression target
scaled to unit variance, three or four classes from quantiles of the
latent score,
counts and a probability label.  A split gain is a difference of leaf
gains, so the float32 summation residue (ROADMAP queue C, "not faults")
is held relative to the tree's largest gain (1e-4 of it), not to each
gain: Poisson's hessians reach ``exp(score + 0.7)`` and its gains cancel
more than the binary ones.  Every ported metric equals its JAX twin on fixed
scores, and a multiclass model written by either package loads in the
other.
"""
import functools

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Metadata as JMeta
from lightgbm_tpu.metric import create_metric as jcreate_metric
from lightgbm_tpu.objective import create_objective as jcreate_objective
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.utils.log import LightGBMError
from lightgbm_tpu_torch.io.dataset import Metadata as TMeta
from lightgbm_tpu_torch.metric import create_metric as tcreate_metric
from lightgbm_tpu_torch.objective import create_objective as tcreate_objective
from test_torch_train import _assert_same_model_text, _data

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ITERS = 6
# the K-tree objectives train 4 iterations of 3 classes (12 trees): the
# file stays within its time budget
ITERS_MULTI = 4


N_TRAIN = 2500


def _labels(n, seed=7):
    """Regression (unit variance), 3- and 4-class, count and probability
    labels from one latent score of ``_data``'s features."""
    X, _, Xv, _ = _data(0, n=N_TRAIN)
    Xa = np.concatenate([X, Xv])
    rng = np.random.default_rng(seed)
    score = Xa[:, 0] + 0.5 * Xa[:, 1] ** 2 - Xa[:, 2] * Xa[:, 3]
    yr = score + 0.3 * rng.normal(size=len(score))
    yr = ((yr - yr.mean()) / yr.std()).astype(np.float32)
    yc = np.digitize(score, np.quantile(score, [0.25, 0.5, 0.75])).astype(
        np.float32)
    y3 = np.digitize(score, np.quantile(score, [1 / 3, 2 / 3])).astype(
        np.float32)
    yp = rng.poisson(np.exp(0.3 * np.clip(score, -3, 3))).astype(np.float32)
    yx = (1.0 / (1.0 + np.exp(-score))).astype(np.float32)
    return {"regression": yr, "class": yc, "class3": y3, "count": yp,
            "prob": yx}


# objective -> (label kind, extra params)
TRAINED = {
    "regression": ("regression", {}),
    "regression_l1": ("regression", {}),
    "huber": ("regression", {}),
    "poisson": ("count", {}),
    "quantile": ("regression", {"alpha": 0.7}),
    "multiclass": ("class3", {"num_class": 3}),
    "multiclassova": ("class3", {"num_class": 3}),
    "cross_entropy": ("prob", {}),
}


def _iters(objective):
    return ITERS_MULTI if objective.startswith("multiclass") else ITERS


@functools.lru_cache(maxsize=None)
def _trained(objective):
    X, _, Xv, _ = _data(0, n=N_TRAIN)
    kind, extra = TRAINED[objective]
    y = _labels(len(X))[kind][:len(X)]
    params = {"objective": objective, "num_leaves": 15, "verbose": -1,
              **extra}
    it = _iters(objective)
    bj = lgb.train(params, lgb.Dataset(X, label=y), it, verbose_eval=False)
    bt = lgt.train(params, lgt.Dataset(X, label=y), it, verbose_eval=False,
                   device="cpu")
    return bj, bt, Xv


def _assert_same_models(tj, tt):
    def gains(text):
        return [np.array(ln.split("=", 1)[1].split(), float)
                for ln in text.splitlines() if ln.startswith("split_gain=")]

    def strip(text):
        return "\n".join(ln for ln in text.splitlines()
                         if not ln.startswith("split_gain="))
    for gj, gt in zip(gains(tj), gains(tt), strict=True):
        np.testing.assert_allclose(gt, gj, rtol=0,
                                   atol=1e-4 * np.abs(gj).max())
    _assert_same_model_text(strip(tj), strip(tt))


@pytest.mark.parametrize("objective", list(TRAINED))
def test_objective_trains_like_jax(objective):
    bj, bt, Xv = _trained(objective)
    K = bt.num_model_per_iteration()
    assert K == bj.num_model_per_iteration()
    assert bt.num_trees() == bj.num_trees() == _iters(objective) * K
    _assert_same_models(bj.model_to_string(), bt.model_to_string())
    pj, pt = bj.predict(Xv), bt.predict(Xv)
    assert pt.shape == pj.shape == ((len(Xv), K) if K > 1 else (len(Xv),))
    # 5e-6, relative where a prediction exceeds 1 (Poisson's counts)
    np.testing.assert_allclose(pt, pj, rtol=5e-6, atol=5e-6)
    np.testing.assert_allclose(bt.predict(Xv, raw_score=True),
                               bj.predict(Xv, raw_score=True), rtol=0,
                               atol=2e-5)
    np.testing.assert_array_equal(bt.predict(Xv, pred_leaf=True),
                                  bj.predict(Xv, pred_leaf=True))


# objective -> (label kind, extra params); with and without weights
ALL_OBJECTIVES = {
    "regression": ("regression", {}),
    "regression_sqrt": ("regression", {"objective": "regression",
                                       "reg_sqrt": True}),
    "regression_l1": ("regression", {}),
    "huber": ("regression", {"alpha": 0.6}),
    "fair": ("regression", {"fair_c": 0.8}),
    "poisson": ("count", {}),
    "quantile": ("regression", {"alpha": 0.3}),
    "mape": ("regression", {}),
    "gamma": ("count_pos", {}),
    "tweedie": ("count", {"tweedie_variance_power": 1.3}),
    "multiclass": ("class", {"num_class": 4}),
    "multiclassova": ("class", {"num_class": 4}),
    "cross_entropy": ("prob", {}),
    "cross_entropy_lambda": ("prob", {}),
}


def _objective_pair(name, weighted):
    n = N_TRAIN
    kind, extra = ALL_OBJECTIVES[name]
    labels = _labels(n)
    label = (labels["count"] + 1.0 if kind == "count_pos"
             else labels[kind])[:n]
    weight = (np.random.default_rng(2).uniform(0.5, 2.0, n).astype(np.float32)
              if weighted else None)
    params = {"objective": name, **extra}
    jm, tm = JMeta(n), TMeta(n)
    for md in (jm, tm):
        md.set_field("label", label)
        if weight is not None:
            md.set_field("weight", weight)
    oj = jcreate_objective(JConfig.from_params(dict(params)))
    ot = tcreate_objective(TConfig.from_params(dict(params)))
    oj.init(jm, n)
    ot.init(tm, n)
    return oj, ot, label, weight


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", list(ALL_OBJECTIVES))
def test_objective_matches_jax(name, weighted):
    oj, ot, label, weight = _objective_pair(name, weighted)
    K = ot.num_model_per_iteration
    assert K == oj.num_model_per_iteration
    n = len(label)
    score = (np.random.default_rng(3).normal(size=(K, n)) * 0.7).astype(
        np.float32)
    s_t = torch.as_tensor(score)
    l_t = torch.as_tensor(label)
    w_t = torch.as_tensor(weight) if weight is not None else None
    if K > 1:
        gj, hj = oj.get_gradients_multi(score, label, weight)
        gt, ht = ot.get_gradients_multi(s_t, l_t, w_t)
        raw = score.astype(np.float64)
    else:
        gj, hj = oj.get_gradients(score[0], label, weight)
        gt, ht = ot.get_gradients(s_t[0], l_t, w_t)
        raw = score[0].astype(np.float64)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=2e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=2e-6,
                               atol=1e-6)
    for k in range(K):
        assert ot.boost_from_score(k) == pytest.approx(
            oj.boost_from_score(k), rel=1e-12, abs=1e-12)
    np.testing.assert_allclose(np.asarray(ot.convert_output(raw)),
                               np.asarray(oj.convert_output(raw)),
                               rtol=2e-6, atol=1e-6)
    assert ot.need_renew_tree_output() == oj.need_renew_tree_output()
    if ot.need_renew_tree_output():
        leaf_pred = np.random.default_rng(5).integers(0, 7, n)
        vals = np.zeros(7)
        np.testing.assert_array_equal(
            ot.renew_leaf_values(leaf_pred, raw, vals, 7),
            oj.renew_leaf_values(leaf_pred, raw, vals, 7))


# metric -> (objective for the output transform, label kind, extra params)
METRICS = {
    "l1": ("regression", "regression", {}),
    "l2": ("regression", "regression", {}),
    "rmse": ("regression", "regression", {}),
    "quantile": ("quantile", "regression", {"alpha": 0.3}),
    "huber": ("huber", "regression", {}),
    "fair": ("fair", "regression", {}),
    "poisson": ("poisson", "count", {}),
    "mape": ("mape", "regression", {}),
    "gamma": ("gamma", "count_pos", {}),
    "gamma_deviance": ("gamma", "count_pos", {}),
    "tweedie": ("tweedie", "count", {}),
    "binary_logloss": ("binary", "binary", {}),
    "binary_error": ("binary", "binary", {}),
    "auc": ("binary", "binary", {}),
    "average_precision": ("binary", "binary", {}),
    "multi_logloss": ("multiclass", "class", {"num_class": 4}),
    "multi_error": ("multiclass", "class", {"num_class": 4,
                                            "multi_error_top_k": 2}),
    "auc_mu": ("multiclass", "class", {
        "num_class": 4, "auc_mu_weights": [0, 1, 2, 3, 1, 0, 4, 5, 2, 4, 0,
                                           6, 3, 5, 6, 0]}),
    "cross_entropy": ("cross_entropy", "prob", {}),
    "cross_entropy_lambda": ("cross_entropy_lambda", "prob", {}),
    "kullback_leibler": ("cross_entropy", "prob", {}),
}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("metric", list(METRICS))
def test_metric_matches_jax(metric, weighted):
    objective, kind, extra = METRICS[metric]
    n = N_TRAIN
    labels = _labels(n)
    label = {"binary": (labels["prob"] > 0.5).astype(np.float32),
             "count_pos": labels["count"] + 1.0}.get(kind, labels.get(kind))
    label = label[:n]
    weight = (np.random.default_rng(2).uniform(0.5, 2.0, n).astype(np.float32)
              if weighted else None)
    params = {"objective": objective, "metric": metric, **extra}
    cj, ct = JConfig.from_params(dict(params)), TConfig.from_params(dict(params))
    jm, tm = JMeta(n), TMeta(n)
    for md in (jm, tm):
        md.set_field("label", label)
        if weight is not None:
            md.set_field("weight", weight)
    oj, ot = jcreate_objective(cj), tcreate_objective(ct)
    oj.init(jm, n)
    ot.init(tm, n)
    mj, mt = jcreate_metric(metric, cj), tcreate_metric(metric, ct)
    mj.init(jm, n)
    mt.init(tm, n)
    K = ot.num_model_per_iteration
    score = np.random.default_rng(3).normal(size=(K, n)) * 0.7
    score = score[0] if K == 1 else score
    vj, vt = mj.eval(score, oj), mt.eval(score, ot)
    assert [(a, c) for a, _, c in vt] == [(a, c) for a, _, c in vj]
    for (_, a, _), (_, b, _) in zip(vt, vj):
        assert a == pytest.approx(b, rel=1e-6, abs=1e-9)


@pytest.mark.parametrize("params,msg", [
    ({"objective": "lambdarank"}, "Ranking tasks require query"),
    ({"objective": "rank_xendcg"}, "Ranking tasks require query"),
    ({"metric": "ndcg"}, "NDCG metric requires query"),
    ({"metric": "map"}, "MAP metric, there should be query")])
def test_ranking_raises(params, msg):
    """The ranking objectives and metrics without query groups raise the
    JAX package's error (ranking itself: tests/test_torch_rank.py)."""
    X, y, _, _ = _data(5, n=800)
    y = np.floor(np.abs(y) * 3)
    params = {"num_leaves": 7, "verbose": -1, **params}
    with pytest.raises(lgb.basic.LightGBMError, match=msg):
        lgb.train(params, lgb.Dataset(X, label=y), 1, verbose_eval=False)
    with pytest.raises(LightGBMError, match=msg):
        lgt.train(params, lgt.Dataset(X, label=y), 1, verbose_eval=False,
                  device="cpu")


def test_multiclass_models_load_across_packages(tmp_path):
    bj, bt, Xv = _trained("multiclass")
    pj, pt = tmp_path / "jax.txt", tmp_path / "torch.txt"
    bj.save_model(str(pj))
    bt.save_model(str(pt))
    tj = lgt.Booster(model_file=str(pj), device="cpu")
    assert tj.model_to_string() == lgb.Booster(model_file=str(pj)).model_to_string()
    np.testing.assert_array_equal(tj.predict(Xv, raw_score=True),
                                  bj.predict(Xv, raw_score=True))
    np.testing.assert_allclose(tj.predict(Xv), bj.predict(Xv), rtol=0,
                               atol=1.2e-7)
    jt = lgb.Booster(model_file=str(pt))
    tt = lgt.Booster(model_file=str(pt), device="cpu")
    assert jt.model_to_string() == tt.model_to_string()
    np.testing.assert_array_equal(jt.predict(Xv, raw_score=True),
                                  bt.predict(Xv, raw_score=True))
    assert tt.predict(Xv).shape == (len(Xv), 3)
