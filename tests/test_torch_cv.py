"""PyTorch port, ``cv`` against the JAX package.

The same seeded data goes through both packages' ``cv``: stratified and
shuffled folds with ``return_cvbooster``; unstratified, unshuffled folds
with ``fpreproc``, a custom metric, training metrics and a recording
callback; early stopping by ``early_stopping_rounds`` (and in the port by
the callback, to the same iteration).
Every mean and stdv must agree within 1e-6, and the fold boosters'
predictions within 5e-6 (``test_torch_train.py``'s bound).  The JAX
package compiles its grower for each fold's booster (~4.5 s on the CPU),
so the cases keep to two folds.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

from test_torch_engine import PARAMS, _data, _error_rate

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


def _both(params, **kw):
    X, y, _, _ = _data()
    rj = lgb.cv(dict(params), lgb.Dataset(X, label=y), **kw)
    rt = lgt.cv(dict(params), lgt.Dataset(X, label=y), device="cpu", **kw)
    cvb = rj.pop("cvbooster", None), rt.pop("cvbooster", None)
    assert rt.keys() == rj.keys()
    for key in rj:
        np.testing.assert_allclose(rt[key], rj[key], rtol=0, atol=1e-6,
                                   err_msg=key)
    return rj, rt, cvb


def test_cv_stratified_shuffled_cvbooster_matches_jax():
    _, rt, (cvb_j, cvb_t) = _both(
        dict(PARAMS, metric="binary_logloss,auc"), num_boost_round=5,
        nfold=2, stratified=True, shuffle=True, seed=7,
        return_cvbooster=True)
    assert set(rt) == {"valid binary_logloss-mean", "valid binary_logloss-stdv",
                       "valid auc-mean", "valid auc-stdv"}
    assert len(rt["valid auc-mean"]) == 5
    assert cvb_t.best_iteration == cvb_j.best_iteration == 5
    Xv = _data()[2]
    pt, pj = cvb_t.predict(Xv), cvb_j.predict(Xv)
    assert len(pt) == 2 and all(p.shape == (len(Xv),) for p in pt)
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-6)


def test_cv_unstratified_fpreproc_feval_and_callbacks_match_jax():
    seen = []

    def fpreproc(dtrain, dtest, params):
        seen.append((dtrain.num_data(), dtest.num_data()))
        return dtrain, dtest, dict(params, learning_rate=0.2)

    hist_j, hist_t = {}, {}
    kw = dict(num_boost_round=4, nfold=2, stratified=False, shuffle=False,
              fpreproc=fpreproc, feval=_error_rate, eval_train_metric=True)
    X, y, _, _ = _data()
    params = dict(PARAMS, metric="auc")
    rj = lgb.cv(params, lgb.Dataset(X, label=y),
                callbacks=[lgb.record_evaluation(hist_j)], **kw)
    rt = lgt.cv(params, lgt.Dataset(X, label=y), device="cpu",
                callbacks=[lgt.record_evaluation(hist_t)], **kw)
    assert len(seen) == 4 and seen[2:] == [(2000, 2000)] * 2
    assert rt.keys() == rj.keys()
    # eval_train_metric adds feval's training rows; the builtin training
    # metrics need is_training_metric, in both packages
    assert {"valid auc-mean", "valid error_rate-mean",
            "training error_rate-mean"} <= set(rt)
    for key in rj:
        np.testing.assert_allclose(rt[key], rj[key], rtol=0, atol=1e-6,
                                   err_msg=key)
    assert hist_t.keys() == hist_j.keys() == {"cv_agg"}
    for key in hist_j["cv_agg"]:
        np.testing.assert_allclose(hist_t["cv_agg"][key],
                                   hist_j["cv_agg"][key], rtol=0, atol=1e-6)


def test_cv_early_stopping_matches_jax():
    """``early_stopping_rounds`` against the JAX package; the port's
    early-stopping callback stops at the same iteration."""
    params = dict(PARAMS, metric="binary_logloss", learning_rate=1.0)
    kw = dict(num_boost_round=30, nfold=2, seed=3)
    _, rt, _ = _both(params, early_stopping_rounds=2, **kw)
    n = len(rt["valid binary_logloss-mean"])
    print("stopped at", n)
    assert n < 30
    X, y, _, _ = _data()
    rc = lgt.cv(params, lgt.Dataset(X, label=y), device="cpu",
                return_cvbooster=True,
                callbacks=[lgt.early_stopping(2, verbose=False)], **kw)
    assert rc["cvbooster"].best_iteration == n
    assert rc["valid binary_logloss-mean"] == rt["valid binary_logloss-mean"]
