"""PyTorch port, TreeSHAP (``pred_contrib``) against the JAX package.

Fault C7: the port's ``Booster.predict`` took ``pred_contrib`` into
``**kwargs`` and returned ordinary predictions, shape ``(n,)``.  Here one
model (trained by the port, carried to the JAX package by its text, so that
only the SHAP code differs) gives each package's contributions: ``[n, F +
1]`` (per class for multiclass, ``[n, K * (F + 1)]``), within 1e-6 of the
JAX package's, summing to the raw score; sparse input gives sparse output
in its own format (CSR or CSC), equal to the dense result.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


def _data(seed, n=3000, f=8, classes=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[rng.random(n) < 0.05, 3] = np.nan
    X[rng.random((n, f)) < 0.3] = 0.0           # zeros for the sparse forms
    latent = X[:, 0] + 0.5 * np.nan_to_num(X[:, 3]) - X[:, 1] * X[:, 2]
    if classes == 2:
        y = (latent + 0.5 * rng.normal(size=n) > 0).astype(np.float32)
    else:
        y = np.digitize(latent, np.quantile(
            latent, np.linspace(0, 1, classes + 1)[1:-1]))
    return X, y.astype(np.float32)


def _models(params, X, y, rounds=6):
    bt = lgt.train(dict(params, verbose=-1), lgt.Dataset(X, label=y), rounds,
                   verbose_eval=False, device="cpu")
    return bt, lgb.Booster(model_str=bt.model_to_string())


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_contrib_matches_jax_dense(objective):
    K = 2 if objective == "binary" else 4
    X, y = _data(0, classes=K)
    params = {"objective": objective, "num_leaves": 15}
    if K > 2:
        params["num_class"] = K
    bt, bj = _models(params, X, y)
    Xs = X[:200]
    ct, cj = bt.predict(Xs, pred_contrib=True), bj.predict(Xs, pred_contrib=True)
    F1 = X.shape[1] + 1
    assert ct.shape == cj.shape == (len(Xs), F1 * (1 if K == 2 else K))
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-6)
    raw = bt.predict(Xs, raw_score=True)
    sums = ct.reshape(len(Xs), -1, F1).sum(axis=2)
    np.testing.assert_allclose(sums.reshape(raw.shape), raw, rtol=0,
                               atol=1e-6)
    # iteration slicing reaches the contributions too
    part = bt.predict(Xs, pred_contrib=True, num_iteration=2)
    np.testing.assert_allclose(
        part, bj.predict(Xs, pred_contrib=True, num_iteration=2), rtol=0,
        atol=1e-6)


@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_contrib_sparse_keeps_the_input_format(fmt, objective):
    K = 2 if objective == "binary" else 3
    X, y = _data(1, classes=K)
    X = np.nan_to_num(X)
    params = {"objective": objective, "num_leaves": 7}
    if K > 2:
        params["num_class"] = K
    bt, bj = _models(params, X, y, rounds=4)
    Xs = X[:150]
    mat = sp.csr_matrix(Xs) if fmt == "csr" else sp.csc_matrix(Xs)
    ct, cj = bt.predict(mat, pred_contrib=True), bj.predict(mat, pred_contrib=True)
    dense = bt.predict(Xs, pred_contrib=True)
    parts_t = [ct] if K == 2 else ct
    parts_j = [cj] if K == 2 else cj
    assert len(parts_t) == (1 if K == 2 else K)
    F1 = X.shape[1] + 1
    for k, (pt, pj) in enumerate(zip(parts_t, parts_j)):
        assert sp.issparse(pt) and pt.format == fmt == pj.format
        np.testing.assert_allclose(pt.toarray(), pj.toarray(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(pt.toarray(),
                                      dense[:, k * F1:(k + 1) * F1])


def test_contrib_of_a_jax_trained_model():
    """A JAX-trained model loaded in the port: the same contributions."""
    X, y = _data(2, n=1500)
    bj = lgb.train({"objective": "regression", "num_leaves": 7,
                    "verbose": -1}, lgb.Dataset(X, label=y), 3)
    bt = lgt.Booster(model_str=bj.model_to_string(), device="cpu")
    np.testing.assert_allclose(bt.predict(X[:100], pred_contrib=True),
                               bj.predict(X[:100], pred_contrib=True),
                               rtol=0, atol=1e-6)
