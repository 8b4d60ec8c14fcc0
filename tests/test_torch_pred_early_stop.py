"""PyTorch port, prediction early stopping (``pred_early_stop``) on the CPU:
the JAX package's bar (``tests/test_aux_features.py::
TestPredictionEarlyStop``) run against the port, and the same raw scores as
the JAX package's early-stopped prediction for the same model (both sum the
host trees in float64 over the rows still active).
"""
import numpy as np
import pytest
import torch
from sklearn.datasets import make_classification

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


def _model(n=800, rounds=40):
    X, y = make_classification(n_samples=n, n_features=10, random_state=1)
    bst = lgt.train({"objective": "binary", "verbose": -1},
                    lgt.Dataset(X, label=y), rounds, device="cpu")
    return bst, X


def _early(bst, freq=None, margin=None):
    cfg = bst._gbdt.config
    cfg.pred_early_stop = True
    if freq is not None:
        cfg.pred_early_stop_freq = freq
    if margin is not None:
        cfg.pred_early_stop_margin = margin


def _jax_twin(bst):
    """The JAX package's booster of the same model text."""
    return lgb.Booster(model_str=bst.model_to_string())


def test_binary_margin_skips_trees():
    bst, X = _model()
    p_full = bst.predict(X, raw_score=True)
    bj = _jax_twin(bst)
    _early(bst, 5, 0.5)
    _early(bj, 5, 0.5)
    p_es = bst.predict(X, raw_score=True)
    changed = np.abs(p_full - p_es) > 1e-12
    assert changed.any()                      # some rows stopped early
    # early-stopped rows must already exceed the margin
    assert np.all(2.0 * np.abs(p_es[changed]) > 0.5)
    np.testing.assert_array_equal(p_es, bj.predict(X, raw_score=True))


def test_huge_margin_is_noop():
    bst, X = _model(rounds=20)
    p_full = bst.predict(X, raw_score=True)
    _early(bst, margin=1e9)
    np.testing.assert_allclose(bst.predict(X, raw_score=True), p_full)


def test_multiclass_margin():
    X, y = make_classification(n_samples=500, n_features=10,
                               n_informative=6, n_classes=3, random_state=2)
    bst = lgt.train({"objective": "multiclass", "num_class": 3,
                     "verbose": -1}, lgt.Dataset(X, label=y), 20,
                    device="cpu")
    p_full = bst.predict(X, raw_score=True)
    bj = _jax_twin(bst)
    _early(bst, 3, 0.1)
    _early(bj, 3, 0.1)
    p_es = bst.predict(X, raw_score=True)
    assert (np.abs(p_full - p_es) > 1e-12).any()
    np.testing.assert_array_equal(p_es, bj.predict(X, raw_score=True))


def test_regression_ignores_early_stop():
    """Only binary and multiclass objectives stop early (the reference's
    prediction_early_stop.cpp types)."""
    X, y = make_classification(n_samples=400, n_features=6, random_state=3)
    bst = lgt.train({"objective": "regression", "verbose": -1},
                    lgt.Dataset(X, label=y.astype(float)), 10, device="cpu")
    p_full = bst.predict(X)
    _early(bst, 1, 0.0)
    np.testing.assert_array_equal(bst.predict(X), p_full)
