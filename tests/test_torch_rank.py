"""PyTorch port, ranking: lambdarank, rank_xendcg, NDCG and MAP against the
JAX package on the CPU.

The same query groups, labels and scores (numpy, from a seed) go through
both packages.  lambdarank's gradients are the JAX ones to 1e-6 relative
(float32 ops in the same order; the port pads each query only to its length
bucket, so its sums of exact zeros are shorter, and XLA's and PyTorch's
``exp`` in the sigmoid may differ by an ulp).  rank_xendcg's draw is the
JAX package's ``uniform(PRNGKey(seed + 7919 i), (Q, L))`` bit for bit, its
gradients within 1e-6 relative (1e-7 absolute where they cancel to ~0).
NDCG@k and MAP@k equal the JAX metrics to 1e-6.  Both objectives train the
JAX package's trees with query groups on training and validation data:
the same model text (gains within 1e-4 of the tree's largest, as
tests/test_torch_objectives.py holds them), predictions within 5e-6 and
the same validation NDCG/MAP.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Metadata as JMeta
from lightgbm_tpu.metric import rank as jrank_metric
from lightgbm_tpu.objective import rank as jrank
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Metadata as TMeta
from lightgbm_tpu_torch.metric import rank as trank_metric
from lightgbm_tpu_torch.objective import rank as trank
from lightgbm_tpu_torch.utils.log import LightGBMError
from test_torch_objectives import _assert_same_models

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


def _queries(seed, nq=40, lo=1, hi=60):
    """Query sizes (a one-document query among them), 0-4 labels from a
    latent score of the features, and the features."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(lo, hi, nq)
    sizes[3] = 1
    n = int(sizes.sum())
    X = rng.normal(size=(n, 8))
    lat = X[:, 0] + 0.6 * X[:, 1] - 0.4 * X[:, 2] * X[:, 3] \
        + 0.3 * rng.normal(size=n)
    y = np.clip(np.floor(lat + 2.0), 0, 4).astype(np.float32)
    return X, y, sizes


def _metas(y, sizes, weight=None):
    n = len(y)
    jm, tm = JMeta(n), TMeta(n)
    for md in (jm, tm):
        md.set_field("label", y)
        md.set_field("group", sizes)
        if weight is not None:
            md.set_field("weight", weight)
    return jm, tm


def _grads_pair(cls_j, cls_t, params, y, sizes, score, weight=None):
    jm, tm = _metas(y, sizes, weight)
    oj = cls_j(JConfig.from_params(dict(params)))
    ot = cls_t(TConfig.from_params(dict(params)))
    oj.init(jm, len(y))
    ot.init(tm, len(y))
    w = None if weight is None else weight.astype(np.float32)
    gj, hj = oj.get_gradients(jnp.asarray(score), jnp.asarray(y),
                              None if w is None else jnp.asarray(w))
    gt, ht = ot.get_gradients(torch.as_tensor(score), torch.as_tensor(y),
                              None if w is None else torch.as_tensor(w))
    return (np.asarray(gj), np.asarray(hj)), (gt.numpy(), ht.numpy())


@pytest.mark.parametrize("params", [
    {"objective": "lambdarank"},
    {"objective": "lambdarank", "lambdarank_norm": False, "sigmoid": 1.7},
    {"objective": "lambdarank", "lambdarank_truncation_level": 5,
     "label_gain": [0, 1, 3, 7, 15, 40]}],
    ids=["default", "no_norm", "truncated"])
def test_lambdarank_gradients_match_jax(params):
    X, y, sizes = _queries(0)
    rng = np.random.default_rng(1)
    score = rng.normal(size=len(y)).astype(np.float32)
    score[:20] = 0.0                                   # tied scores
    weight = np.repeat(rng.uniform(0.5, 2.0, len(sizes)), sizes)
    for w in (None, weight):
        (gj, hj), (gt, ht) = _grads_pair(jrank.LambdarankNDCG,
                                         trank.LambdarankNDCG, params, y,
                                         sizes, score, w)
        np.testing.assert_allclose(gt, gj, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ht, hj, rtol=1e-6, atol=1e-7)
    # a bucket narrower than the common width: the layout pads less
    ot = trank.LambdarankNDCG(TConfig.from_params(dict(params)))
    ot.init(_metas(y, sizes)[1], len(y))
    assert min(w for w, *_ in ot._buckets) < ot.L


def test_xendcg_draw_and_gradients_match_jax():
    X, y, sizes = _queries(2)
    params = {"objective": "rank_xendcg", "objective_seed": 9}
    jm, tm = _metas(y, sizes)
    oj = jrank.RankXENDCG(JConfig.from_params(dict(params)))
    ot = trank.RankXENDCG(TConfig.from_params(dict(params)))
    oj.init(jm, len(y))
    ot.init(tm, len(y))
    assert (ot.num_queries, ot.L) == (oj.num_queries, oj.L)
    assert ot.L % 8 == 0 and ot.L > int(sizes.max()) - 8
    for it in (0, 2):
        want = jax.random.uniform(jax.random.PRNGKey(9 + it * 7919),
                                  (oj.num_queries, oj.L))
        np.testing.assert_array_equal(ot.draw(it, "cpu").numpy(),
                                      np.asarray(want))
    rng = np.random.default_rng(3)
    for it in range(2):                     # the draw advances per call
        score = rng.normal(size=len(y)).astype(np.float32)
        gj, hj = oj.get_gradients(jnp.asarray(score), jnp.asarray(y), None)
        gt, ht = ot.get_gradients(torch.as_tensor(score), torch.as_tensor(y),
                                  None)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("weighted", [False, True])
def test_rank_metrics_match_jax(weighted):
    X, y, sizes = _queries(4)
    rng = np.random.default_rng(5)
    w = (np.repeat(rng.uniform(0.5, 2.0, len(sizes)), sizes)
         if weighted else None)
    jm, tm = _metas(y, sizes, w)
    score = rng.normal(size=len(y))
    score[::7] = 0.0
    params = {"eval_at": [1, 3, 5, 10]}
    for jcls, tcls in ((jrank_metric.NDCGMetric, trank_metric.NDCGMetric),
                       (jrank_metric.MapMetric, trank_metric.MapMetric)):
        mj = jcls(JConfig.from_params(dict(params)))
        mt = tcls(TConfig.from_params(dict(params)))
        mj.init(jm, len(y))
        mt.init(tm, len(y))
        vj, vt = mj.eval(score), mt.eval(score)
        assert [(a, c) for a, _, c in vt] == [(a, c) for a, _, c in vj]
        for (_, a, _), (_, b, _) in zip(vt, vj):
            assert a == pytest.approx(b, rel=1e-6, abs=1e-9)


@pytest.mark.parametrize("objective", ["lambdarank", "rank_xendcg"])
def test_ranking_trains_like_jax(objective):
    X, y, sizes = _queries(6, nq=50)
    Xv, yv, sv = _queries(7, nq=20)
    params = {"objective": objective, "num_leaves": 15, "verbose": -1,
              "metric": "ndcg,map", "eval_at": [1, 3, 5],
              "min_data_in_leaf": 10}
    ej, et = {}, {}
    dj = lgb.Dataset(X, label=y, group=sizes)
    bj = lgb.train(params, dj, 5, evals_result=ej, verbose_eval=False,
                   valid_sets=[dj.create_valid(Xv, yv, group=sv)])
    dt = lgt.Dataset(X, label=y, group=sizes)
    bt = lgt.train(params, dt, 5, evals_result=et, verbose_eval=False,
                   valid_sets=[dt.create_valid(Xv, yv, group=sv)],
                   device="cpu")
    np.testing.assert_array_equal(dt.get_group(), sizes)
    assert bt.num_trees() == bj.num_trees() == 5
    _assert_same_models(bj.model_to_string(), bt.model_to_string())
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), rtol=0,
                               atol=5e-6)
    assert sorted(et["valid_0"]) == sorted(ej["valid_0"])
    for name, vals in ej["valid_0"].items():
        np.testing.assert_allclose(et["valid_0"][name], vals, rtol=0,
                                   atol=1e-6, err_msg=name)


def test_groups_must_sum_to_num_data():
    X, y, sizes = _queries(8, nq=10)
    bad = sizes.copy()
    bad[0] += 1
    with pytest.raises(lgb.basic.LightGBMError, match="do not sum"):
        lgb.Dataset(X, label=y, group=bad).construct()
    with pytest.raises(LightGBMError, match="do not sum"):
        lgt.Dataset(X, label=y, group=bad).construct(device="cpu")
