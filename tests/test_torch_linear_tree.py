"""PyTorch port, linear trees (``linear_tree=true``) against the JAX package
on the CPU.

``ops/linear.py`` fits each leaf's ridge regression of the Newton step on
its branch features' raw values.  The port builds the normal equations and
solves them in float64, as the reference's double buffers do; the JAX
package builds and solves them in float32, which on these shapes lands
within 5e-5 of the float64 solution (measured against a float64 numpy
solve of the same system).  So the port's ``fit_leaf_linear`` is held to a
float64 numpy reference at 1e-9 and to JAX's at 1e-4; trained models have
JAX's structure, leaf constants and coefficients within 5e-5, and
predictions within 1e-5 relative and absolute (up to 1.6e-5 measured over
seeds 0-2 of this data, predictions of size ~3).  Prediction on the device
(the stacked ensemble), continued training from a linear-tree model, and
the refusals of refit and pred_contrib follow the JAX package.
"""
import functools

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops import linear as jlin
from lightgbm_tpu_torch.ops import linear as tlin

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

PARAMS = {"objective": "regression", "num_leaves": 6, "verbose": -1,
          "linear_tree": True, "metric": "l2"}
ITERS = 6
STRUCT_KEYS = ("num_leaves", "split_feature", "threshold", "decision_type",
               "left_child", "right_child", "is_linear", "num_features",
               "leaf_features")


def _piecewise(seed=0, n=3000):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(n, 4)).astype(np.float32)
    y = np.where(X[:, 1] > 0, 3.0 * X[:, 0] + 1.0, -2.0 * X[:, 0] - 1.0)
    y = y + 0.05 * rng.normal(size=n)
    X[rng.random(n) < 0.02, 2] = np.nan
    return X, y


def _system(seed=0, n=2500, L=6):
    rng = np.random.default_rng(seed)
    raw = rng.uniform(-2, 2, size=(n, 5)).astype(np.float32)
    raw[rng.random(n) < 0.03, 3] = np.nan
    g = (np.where(raw[:, 1] > 0, 3.0 * raw[:, 0], -raw[:, 2])
         + 0.1 * rng.normal(size=n)).astype(np.float32)
    h = rng.uniform(0.5, 1.5, n).astype(np.float32)
    na = rng.integers(0, L, n).astype(np.int32)
    rw = (rng.random(n) < 0.9).astype(np.float32)
    feat = np.array([[0, 1], [0, -1], [2, 3], [0, 4], [3, -1], [-1, -1]],
                    np.int32)
    return raw, g, h, na, rw, feat


def _numpy_fit(raw, g, h, na, rw, feat, lam):
    """Float64 normal equations per leaf, solved with numpy."""
    L, K = feat.shape
    coeffs, consts, oks = np.zeros((L, K)), np.zeros(L), np.zeros(L, bool)
    for leaf in range(L):
        fs = feat[leaf][feat[leaf] >= 0]
        x = raw[:, fs].astype(np.float64)
        w = (na == leaf) & (rw > 0) & ~np.isnan(x).any(1)
        xa = np.concatenate([x[w], np.ones((w.sum(), 1))], 1)
        a = (xa * h[w, None]).T @ xa + np.diag(
            [lam] * len(fs) + [0.0]) + 1e-10 * np.eye(len(fs) + 1)
        beta = -np.linalg.solve(a, xa.T @ g[w].astype(np.float64))
        coeffs[leaf, :len(fs)] = beta[:-1]
        consts[leaf] = beta[-1]
        oks[leaf] = w.sum() >= len(fs) + 1
    return coeffs, consts, oks


@pytest.mark.parametrize("lam", [0.0, 0.5])
def test_fit_leaf_linear_matches_float64_and_jax(lam):
    raw, g, h, na, rw, feat = _system()
    ct, kt, okt = tlin.fit_leaf_linear(*map(torch.as_tensor,
                                            (raw, g, h, na, rw)),
                                       torch.as_tensor(feat).long(), lam)
    cn, kn, okn = _numpy_fit(raw, g, h, na, rw, feat, lam)
    valid = okn[:, None] & (feat >= 0)
    np.testing.assert_allclose(np.where(valid, ct.numpy(), 0.0),
                               np.where(valid, cn, 0.0), rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.where(okn, kt.numpy(), 0.0),
                               np.where(okn, kn, 0.0), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(okt.numpy(), okn)
    cj, kj, okj = jlin.fit_leaf_linear(*raw_jax(raw, g, h, na, rw, feat),
                                       feat.shape[0], lam)
    np.testing.assert_array_equal(np.asarray(okj), okn)
    np.testing.assert_allclose(np.where(valid, ct.numpy(), 0.0),
                               np.where(valid, np.asarray(cj), 0.0),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.where(okn, kt.numpy(), 0.0),
                               np.where(okn, np.asarray(kj), 0.0),
                               rtol=0, atol=1e-4)


def raw_jax(*arrays):
    import jax.numpy as jnp
    return [jnp.asarray(a) for a in arrays]


def test_linear_leaf_delta_matches_jax():
    raw, _, _, na, _, feat = _system(1)
    rng = np.random.default_rng(2)
    coeffs = rng.normal(size=feat.shape).astype(np.float32)
    consts = rng.normal(size=feat.shape[0]).astype(np.float32)
    fallback = rng.normal(size=feat.shape[0]).astype(np.float32)
    dt = tlin.linear_leaf_delta(*map(torch.as_tensor, (raw, na)),
                                torch.as_tensor(coeffs),
                                torch.as_tensor(consts),
                                torch.as_tensor(feat).long(),
                                torch.as_tensor(fallback))
    dj = jlin.linear_leaf_delta(*raw_jax(raw, na, coeffs, consts, feat,
                                         fallback))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0,
                               atol=1e-6)


@functools.lru_cache(maxsize=None)
def _trained():
    X, y = _piecewise()
    dj = lgb.Dataset(X[:2500], label=y[:2500], params=PARAMS)
    dt = lgt.Dataset(X[:2500], label=y[:2500], params=PARAMS)
    ej, et = {}, {}
    bj = lgb.train(PARAMS, dj, ITERS, valid_sets=[dj.create_valid(
        X[2500:], label=y[2500:])], evals_result=ej, verbose_eval=False)
    bt = lgt.train(PARAMS, dt, ITERS, valid_sets=[dt.create_valid(
        X[2500:], label=y[2500:])], evals_result=et, verbose_eval=False,
        device="cpu")
    return bj, bt, ej, et, X, y


def test_linear_tree_trains_like_jax():
    bj, bt, ej, et, X, _ = _trained()
    tj, tt = bj.model_to_string(), bt.model_to_string()
    fj = [ln.split("=", 1) for ln in tj.splitlines() if "=" in ln]
    ft = [ln.split("=", 1) for ln in tt.splitlines() if "=" in ln]
    assert [k for k, _ in fj] == [k for k, _ in ft]
    for (k, vj), (_, vt) in zip(fj, ft):
        if k in STRUCT_KEYS:
            assert vt == vj, k
        elif k in ("leaf_const", "leaf_coeff"):
            np.testing.assert_allclose(np.array(vt.split(), float),
                                       np.array(vj.split(), float),
                                       rtol=0, atol=5e-5, err_msg=k)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(bt.predict(X, pred_leaf=True),
                                  bj.predict(X, pred_leaf=True))
    # the valid scores ride the linear leaves too
    np.testing.assert_allclose(et["valid_0"]["l2"], ej["valid_0"]["l2"],
                               rtol=1e-5, atol=0)
    assert et["valid_0"]["l2"][-1] < et["valid_0"]["l2"][0]


def test_linear_tree_beats_constant():
    """The JAX package's bar (tests/test_linear_tree.py): on a piecewise
    linear target the linear leaves fit far better (its data too)."""
    rng = np.random.default_rng(11)
    X = rng.uniform(-3, 3, size=(3000, 4))
    y = np.where(X[:, 1] > 0, 3.0 * X[:, 0] + 1.0, -2.0 * X[:, 0] - 1.0)
    y += 0.05 * rng.normal(size=3000)
    params = {"objective": "regression", "num_leaves": 4, "verbose": -1,
              "learning_rate": 0.5, "min_data_in_leaf": 50}
    const = lgt.train(params, lgt.Dataset(X, label=y), 10,
                      verbose_eval=False, device="cpu")
    lp = dict(params, linear_tree=True)
    linear = lgt.train(lp, lgt.Dataset(X, label=y, params=lp), 10,
                       verbose_eval=False, device="cpu")
    assert np.mean((linear.predict(X) - y) ** 2) < \
        0.5 * np.mean((const.predict(X) - y) ** 2)


def test_linear_tree_device_predict_and_text():
    """The stacked ensemble predicts linear leaves (NaN rows fall back to
    the constant leaf); a model carried by its text predicts the same in
    both packages."""
    _, bt, _, _, X, _ = _trained()
    Xn = X.copy()
    Xn[:50, 0] = np.nan
    host = bt.predict(Xn, raw_score=True)
    bt._gbdt.config.pred_device = "device"
    try:
        dev = bt.predict(Xn, raw_score=True)
    finally:
        bt._gbdt.config.pred_device = "auto"
    np.testing.assert_allclose(dev, host, rtol=1e-6, atol=1e-6)
    text = bt.model_to_string()
    assert "is_linear=1" in text
    lj = lgb.Booster(model_str=text)
    lt = lgt.Booster(model_str=text, device="cpu")
    np.testing.assert_array_equal(lt.predict(Xn), host)
    np.testing.assert_allclose(lj.predict(Xn), host, rtol=1e-12, atol=1e-12)


def test_linear_tree_continued_training(tmp_path):
    """Continued training from a linear-tree model warms the scores from
    its raw-value predictions (the JAX package's continue_from) and keeps
    improving the fit."""
    bj, bt, _, _, X, y = _trained()
    path = str(tmp_path / "linear.txt")
    bt.save_model(path)
    cj = lgb.train(PARAMS, lgb.Dataset(X, label=y, params=PARAMS), 3,
                   init_model=path, verbose_eval=False)
    ct = lgt.train(PARAMS, lgt.Dataset(X, label=y, params=PARAMS), 3,
                   init_model=path, verbose_eval=False, device="cpu")
    assert ct.num_trees() == cj.num_trees() == ITERS + 3
    np.testing.assert_allclose(ct.predict(X), cj.predict(X), rtol=1e-5,
                               atol=1e-5)
    assert np.mean((ct.predict(X) - y) ** 2) < \
        np.mean((bt.predict(X) - y) ** 2)


def test_linear_tree_contrib_and_refit_raise():
    """Neither package has TreeSHAP or refit for linear trees: the port
    raises the JAX package's LightGBMError."""
    _, bt, _, _, X, y = _trained()
    with pytest.raises(lgt.LightGBMError, match="linear trees"):
        bt.predict(X, pred_contrib=True)
    with pytest.raises(lgt.LightGBMError, match="linear-tree"):
        bt.refit(X, y)


def test_leaf_constant_integer_feature_solves_in_float64(monkeypatch):
    """Integer-valued columns that are not declared categorical, split on
    twice, are constant in a leaf: with ``linear_lambda=0`` that column is
    collinear with the intercept and the leaf's normal equations are
    singular but for the 1e-10 jitter.  The JAX package builds and solves
    them in float32, below whose resolution the jitter lies, and gives
    ``inf`` (ROADMAP C10); the port solves in float64, as the reference's
    double buffers do, and stays finite.  Each fit equals a float64 numpy
    solve of the same system: the coefficients of the features that vary
    in the leaf and the fitted values on the leaf's rows to 1e-9, while the
    constant column and the intercept, determined only up to the
    singular direction, trade within 1e-3."""
    rng = np.random.default_rng(0)
    n = 3000
    X = rng.uniform(-2, 2, size=(n, 8)).astype(np.float32)
    X[:, 6] = rng.integers(0, 12, n)
    X[:, 7] = rng.integers(0, 40, n)
    y = (3 * np.sin(1.7 * X[:, 6]) + np.cos(0.9 * X[:, 7]) + X[:, 0]
         + 0.1 * rng.normal(size=n))
    calls = []
    fit = tlin.fit_leaf_linear

    def recorded(*args):
        out = fit(*args)
        calls.append((args, out))
        return out
    monkeypatch.setattr(tlin, "fit_leaf_linear", recorded)
    params = {"objective": "regression", "linear_tree": True,
              "num_leaves": 15, "min_data_in_leaf": 20, "verbose": -1}
    bt = lgt.train(params, lgt.Dataset(X, label=y, params=params), 5,
                   verbose_eval=False, device="cpu")
    assert np.isfinite(bt.predict(X)).all()
    assert len(calls) == 4                      # every tree but the first
    constant_leaves = 0
    for (raw, g, h, na, rw, feat, lam), (co, cs, ok) in calls:
        assert lam == 0.0
        raw, na, feat = raw.numpy(), na.numpy(), feat.numpy()
        nco, ncs, nok = _numpy_fit(raw, g.numpy(), h.numpy(), na, rw.numpy(),
                                   feat, lam)
        np.testing.assert_array_equal(ok.numpy(), nok)
        co, cs = co.numpy(), cs.numpy()
        for leaf in np.nonzero(nok)[0]:
            fs = feat[leaf][feat[leaf] >= 0]
            x = raw[na == leaf][:, fs].astype(np.float64)
            x = x[~np.isnan(x).any(1)]
            k = len(fs)
            np.testing.assert_allclose(x @ co[leaf, :k] + cs[leaf],
                                       x @ nco[leaf, :k] + ncs[leaf],
                                       rtol=0, atol=1e-9)
            varies = (x != x[:1]).any(0)
            constant_leaves += int(not varies.all())
            np.testing.assert_allclose(co[leaf, :k][varies],
                                       nco[leaf, :k][varies], rtol=0,
                                       atol=1e-9)
            np.testing.assert_allclose(co[leaf], nco[leaf], rtol=0, atol=1e-3)
            assert abs(cs[leaf] - ncs[leaf]) <= 1e-3
    assert constant_leaves > 0
