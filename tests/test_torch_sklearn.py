"""PyTorch port, the scikit-learn estimators (``lightgbm_tpu_torch.sklearn``)
on the CPU: what applies of ``tests/test_sklearn.py``, run against the
port with ``device="cpu"``, plus parity with the JAX package's estimators
(the same trees: predictions to 5e-6, as ``tests/test_torch_train.py``
holds the train API) and with the port's own ``train`` (bit for bit).
Without scikit-learn the estimators derive from stand-in bases and still
fit and predict; ``device`` is estimator state forwarded to ``train``,
None meaning the CUDA card.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import LGBMClassifier, LGBMRanker, LGBMRegressor

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device": "cpu"}


def test_regressor_basic(regression_data):
    Xtr, ytr, Xte, yte = regression_data
    m = LGBMRegressor(n_estimators=15, num_leaves=15, learning_rate=0.2,
                      random_state=42, **CPU)
    m.fit(Xtr, ytr)
    pred = m.predict(Xte)
    assert float(np.mean((pred - yte) ** 2)) < 0.4 * float(np.var(yte))
    assert m.score(Xte, yte) > 0.6
    assert m.n_features_ == Xtr.shape[1]
    imp = m.feature_importances_
    assert imp.shape == (Xtr.shape[1],) and imp.sum() > 0


def test_classifier_binary_matches_jax_and_train(binary_data):
    Xtr, ytr, Xte, yte = binary_data
    m = LGBMClassifier(n_estimators=10, num_leaves=15, **CPU)
    m.fit(Xtr, ytr)
    assert set(m.classes_) == {0, 1} and m.n_classes_ == 2
    proba = m.predict_proba(Xte)
    assert proba.shape == (len(yte), 2)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, rtol=1e-5)
    assert m.score(Xte, yte) > 0.8
    j = lgb.LGBMClassifier(n_estimators=10, num_leaves=15).fit(Xtr, ytr)
    np.testing.assert_allclose(proba, j.predict_proba(Xte), rtol=0,
                               atol=5e-6)
    np.testing.assert_array_equal(m.predict(Xte), j.predict(Xte))
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1}
    bst = lgt.train(params, lgt.Dataset(Xtr, label=ytr.astype(float)), 10,
                    device="cpu")
    np.testing.assert_array_equal(proba[:, 1], bst.predict(Xte))


def test_classifier_multiclass_and_string_labels(multiclass_data,
                                                 binary_data):
    Xtr, ytr, Xte, yte = multiclass_data
    m = LGBMClassifier(n_estimators=8, num_leaves=7, **CPU)
    m.fit(Xtr, ytr)
    assert m.n_classes_ == 4
    assert m.predict_proba(Xte).shape == (len(yte), 4)
    assert m.score(Xte, yte) > 0.7
    Xtr, ytr, Xte, yte = binary_data
    labels = np.array(["neg", "pos"])
    m = LGBMClassifier(n_estimators=8, num_leaves=15, **CPU)
    m.fit(Xtr, labels[ytr.astype(int)])
    pred = m.predict(Xte)
    assert set(np.unique(pred)) <= {"neg", "pos"}
    assert float(np.mean(pred == labels[yte.astype(int)])) > 0.8


def test_eval_set_early_stopping_and_empty(binary_data):
    Xtr, ytr, Xte, yte = binary_data
    m = LGBMClassifier(n_estimators=40, num_leaves=15, learning_rate=0.5,
                       **CPU)
    m.fit(Xtr, ytr, eval_set=[(Xte, yte)], eval_metric="binary_logloss",
          early_stopping_rounds=5)
    assert 0 < m.best_iteration_ < 40
    assert "binary_logloss" in m.evals_result_["valid_0"]
    m = LGBMClassifier(n_estimators=8, num_leaves=15, **CPU)
    m.fit(Xtr, ytr, eval_set=[])
    assert m.evals_result_ == {}
    assert m.score(Xte, yte) > 0.8


def test_init_model_continuation_with_eval_set(binary_data, tmp_path):
    Xtr, ytr, Xte, yte = binary_data
    base = LGBMClassifier(n_estimators=10, num_leaves=15, learning_rate=0.2,
                          **CPU)
    base.fit(Xtr, ytr, eval_set=[(Xte, yte)], eval_metric="binary_logloss")
    base_last = base.evals_result_["valid_0"]["binary_logloss"][-1]
    cont = LGBMClassifier(n_estimators=5, num_leaves=15, learning_rate=0.2,
                          **CPU)
    cont.fit(Xtr, ytr, eval_set=[(Xte, yte)], eval_metric="binary_logloss",
             init_model=base)
    hist = cont.evals_result_["valid_0"]["binary_logloss"]
    assert len(hist) == 5 and cont.booster_.num_trees() == 15
    assert hist[0] < base_last * 1.10
    path = str(tmp_path / "base.txt")
    base.booster_.save_model(path)
    cont2 = LGBMClassifier(n_estimators=5, num_leaves=15, learning_rate=0.2,
                           **CPU)
    cont2.fit(Xtr, ytr, eval_set=[(Xte, yte)], eval_metric="binary_logloss",
              init_model=path)
    np.testing.assert_allclose(
        cont2.evals_result_["valid_0"]["binary_logloss"], hist, rtol=1e-5,
        atol=1e-7)


def test_custom_objective_and_eval(regression_data):
    Xtr, ytr, Xte, yte = regression_data

    def mse_obj(y_true, y_pred):
        return (y_pred - y_true), np.ones_like(y_true)

    def mae_eval(y_true, y_pred):
        return "custom_mae", float(np.mean(np.abs(y_true - y_pred))), False

    m = LGBMRegressor(n_estimators=15, num_leaves=15, learning_rate=0.2,
                      objective=mse_obj, **CPU)
    m.fit(Xtr, ytr, eval_set=[(Xte, yte)], eval_metric=mae_eval)
    assert float(np.mean((m.predict(Xte) - yte) ** 2)) < \
        0.5 * float(np.var(yte))
    assert "custom_mae" in m.evals_result_["valid_0"]


def test_ranker():
    from test_rank_xentropy import make_ranking
    X, y, group = make_ranking()
    split = int(len(group) * 0.8)
    n_tr = int(group[:split].sum())
    m = LGBMRanker(n_estimators=10, num_leaves=15, min_child_samples=5, **CPU)
    m.fit(X[:n_tr], y[:n_tr], group=group[:split],
          eval_set=[(X[n_tr:], y[n_tr:])], eval_group=[group[split:]],
          eval_metric="ndcg")
    assert any(k.startswith("ndcg@") for k in m.evals_result_["valid_0"])
    assert m.predict(X[n_tr:]).shape == (len(y) - n_tr,)
    with pytest.raises(lgt.LightGBMError):
        LGBMRanker(**CPU).fit(X, y)                 # no group


def test_get_set_params_pickle_and_clone(binary_data):
    from sklearn.base import clone
    m = LGBMClassifier(num_leaves=63, learning_rate=0.05,
                       min_child_samples=10, **CPU)
    p = m.get_params()
    assert p["num_leaves"] == 63 and p["device"] == "cpu"
    m.set_params(num_leaves=7, reg_alpha=0.5)
    assert m.get_params()["num_leaves"] == 7
    assert LGBMClassifier(**m.get_params()).get_params() == m.get_params()
    Xtr, ytr, Xte, _ = binary_data
    m = LGBMClassifier(n_estimators=10, num_leaves=15, **CPU).fit(Xtr, ytr)
    m2 = pickle.loads(pickle.dumps(m))
    np.testing.assert_array_equal(m2.predict_proba(Xte), m.predict_proba(Xte))
    c = clone(m)
    assert c.get_params() == m.get_params()
    with pytest.raises(lgt.LightGBMError):
        c.predict(Xte)                             # the clone is unfitted
    np.testing.assert_array_equal(c.fit(Xtr, ytr).predict_proba(Xte),
                                  m.predict_proba(Xte))


def test_class_weight_and_shape_checks(binary_data):
    Xtr, ytr, Xte, yte = binary_data
    m = LGBMClassifier(n_estimators=15, num_leaves=15,
                       class_weight="balanced", **CPU)
    m.fit(Xtr, ytr)
    assert m.score(Xte, yte) > 0.75
    with pytest.raises(lgt.LightGBMError):
        m.predict(Xte[:, :3])
    with pytest.raises(lgt.LightGBMError):
        LGBMClassifier(**CPU).predict(Xte)
    with pytest.raises(lgt.LightGBMError):
        _ = LGBMClassifier(**CPU).feature_importances_


def test_device_none_means_cuda(binary_data):
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU error; this machine has a card")
    Xtr, ytr, _, _ = binary_data
    with pytest.raises(lgt.NoCudaDeviceError):
        LGBMClassifier(n_estimators=2).fit(Xtr, ytr)


_NO_SKLEARN = r"""
import sys
import numpy as np


class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == "sklearn" or name.startswith("sklearn."):
            raise ImportError("sklearn is absent here")


sys.meta_path.insert(0, _Block())
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.sklearn import LGBMClassifier, _SKLBase
assert _SKLBase is object
rng = np.random.default_rng(0)
X = rng.normal(size=(1500, 6))
y = (X[:, 0] + X[:, 1] ** 2 > 0.5).astype(int)
m = LGBMClassifier(n_estimators=8, num_leaves=15, device="cpu").fit(X, y)
bst = lgt.train({"objective": "binary", "num_leaves": 15, "verbose": -1},
                lgt.Dataset(X, label=y.astype(float)), 8, device="cpu")
assert np.array_equal(m.predict_proba(X)[:, 1], bst.predict(X))
assert "sklearn" not in sys.modules
print("OK")
"""


def test_estimators_without_sklearn():
    env = {k: v for k, v in os.environ.items() if "PYTHONPATH" not in k}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _NO_SKLEARN], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("OK")
