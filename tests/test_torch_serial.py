"""PyTorch port, the sequential (serial) grower against the JAX package's
serial grower and against the port's own frontier grower, on the CPU.

``tree_grower=serial`` grows one split at a time over a row permutation
(``ops/grower.py::grow_tree_serial``).  It must give the JAX package's
serial trees: the same model text apart from float digits, leaf values to
1e-5, predictions to 5e-6 and the same ``pred_leaf`` (the residue of the
JAX CPU's float32 row-order histogram sums against the port's float64
sums, ROADMAP.md queue C; the data keeps clear of near-tie gains).  And
wherever the frontier grower is eligible it must give the frontier's trees
exactly: the same ``pred_leaf``, which holds the best-leaf pick and its tie
rule (lowest leaf id) to one another.  Cases: binary, weighted
regression, multiclass, categorical (one-hot and sorted), EFB bundles of
CSR input, and the compacted bag.
"""
import functools

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops import grower as tgrow
from lightgbm_tpu_torch.ops import frontier as tfront
from lightgbm_tpu_torch.ops import predict as tpred
from test_torch_categorical import CAT_PARAMS, _cat_data
from test_torch_efb import _one_hot
from test_torch_objectives import _assert_same_models
from test_torch_train import PARAMS, _data

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ITERS = 5


def _regression(seed, n=3000):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6))
    y = 2 * X[:, 0] + np.sin(3 * X[:, 1]) + X[:, 2] * X[:, 3] \
        + 0.1 * rng.normal(size=n)
    w = np.abs(rng.normal(1.0, 0.4, n)) + 0.1
    return X, y, w


def _multiclass(seed, n=3000):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6))
    lat = np.stack([X[:, 0] + X[:, 1], X[:, 2] - X[:, 0], 0.8 * X[:, 3]], 1)
    y = np.argmax(lat + 0.3 * rng.normal(size=lat.shape), 1).astype(float)
    return X, y


def _case(name):
    """(params, X, y, Dataset kwargs, X to predict)."""
    if name == "binary":
        X, y, Xv, _ = _data(0)
        return dict(PARAMS), X, y, {}, Xv
    if name == "regression_weighted":
        X, y, w = _regression(1)
        return ({"objective": "regression", "num_leaves": 15, "verbose": -1},
                X, y, {"weight": w}, X[:800])
    if name == "multiclass":
        X, y = _multiclass(2)
        return ({"objective": "multiclass", "num_class": 3, "num_leaves": 7,
                 "verbose": -1}, X, y, {}, X[:800])
    if name == "categorical":
        X, y = _cat_data(0)
        return (dict(CAT_PARAMS), X, y, {"categorical_feature": [0, 1]},
                _cat_data(1, n=800)[0])
    if name == "efb":
        X, y = _one_hot(0)
        return ({"objective": "binary", "num_leaves": 15, "verbose": -1,
                 "min_data_in_leaf": 10}, X, y, {}, X[:800])
    if name == "bagging_compacted":
        X, y, Xv, _ = _data(2)
        return ({**PARAMS, "bagging_fraction": 0.5, "bagging_freq": 1},
                X, y, {}, Xv)
    raise KeyError(name)


CASES = ("binary", "regression_weighted", "multiclass", "categorical", "efb",
         "bagging_compacted")


@functools.lru_cache(maxsize=None)
def _trained(name):
    params, X, y, kw, Xv = _case(name)
    serial = {**params, "tree_grower": "serial"}
    bj = lgb.train(serial, lgb.Dataset(X, label=y, **kw), ITERS,
                   verbose_eval=False)
    bt = lgt.train(serial, lgt.Dataset(X, label=y, **kw), ITERS,
                   verbose_eval=False, device="cpu")
    bf = lgt.train(params, lgt.Dataset(X, label=y, **kw), ITERS,
                   verbose_eval=False, device="cpu")
    return bj, bt, bf, Xv


@pytest.mark.parametrize("name", CASES)
def test_serial_trains_like_jax_serial(name):
    bj, bt, _, Xv = _trained(name)
    assert bt.num_trees() == bj.num_trees()
    _assert_same_models(bj.model_to_string(), bt.model_to_string())
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), rtol=5e-6,
                               atol=5e-6)
    np.testing.assert_array_equal(bt.predict(Xv, pred_leaf=True),
                                  bj.predict(Xv, pred_leaf=True))


@pytest.mark.parametrize("name", CASES)
def test_serial_equals_frontier(name):
    """Where the frontier is eligible, both growers give the same trees:
    the same leaf numbering and the same values."""
    _, bt, bf, Xv = _trained(name)
    np.testing.assert_array_equal(bt.predict(Xv, pred_leaf=True),
                                  bf.predict(Xv, pred_leaf=True))
    np.testing.assert_array_equal(bt.predict(Xv, raw_score=True),
                                  bf.predict(Xv, raw_score=True))


def test_serial_grower_builds_one_histogram_a_split(monkeypatch):
    """The root and each split's smaller child: one full-histogram build
    per split plus one, never a per-leaf batched build; the larger child is
    the parent less the smaller (its rows are never summed)."""
    X, y, _, _ = _data(3, n=2000)
    ds = lgt.Dataset(X, label=y)
    bt = lgt.train({**PARAMS, "tree_grower": "serial"}, ds, 1,
                   verbose_eval=False, device="cpu")
    dd = ds._inner.device_data("cpu")
    gcfg = bt._gbdt._grower_cfg
    g = torch.as_tensor(np.where(y > 0, -0.5, 0.5).astype(np.float32))
    h = torch.full_like(g, 0.25)
    calls = {"full": 0, "leaves": 0}

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call
    monkeypatch.setattr(tgrow, "build_histogram",
                        counted("full", tgrow.build_histogram))
    monkeypatch.setattr(tfront, "build_histogram",
                        counted("full", tfront.build_histogram))
    monkeypatch.setattr(tfront, "build_histogram_leaves",
                        counted("leaves", tfront.build_histogram_leaves))
    tree, assign, host = tgrow.grow_tree(
        dd.bins, g, h, torch.ones_like(g), torch.ones(dd.bins.shape[1]),
        dd.num_bins, dd.nan_bins, gcfg)
    nl = int(host.num_leaves)
    assert nl == PARAMS["num_leaves"]
    assert calls == {"full": nl, "leaves": 0}
    # node assignment: every row sits in the leaf its bins route it to
    assert sorted(set(assign.tolist())) == list(range(nl))
    np.testing.assert_array_equal(
        assign.numpy(),
        tpred.predict_leaf_binned(tree, dd.bins, dd.nan_bins).numpy())
