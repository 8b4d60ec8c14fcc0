"""PyTorch port, the slice as a whole: train and predict against the JAX
package.

``lightgbm_tpu_torch.train`` on the CPU must give the JAX package's trees
for the same data and parameters: the same model text apart from float
digits, and leaf values to 1e-5.  Predictions agree to 5e-6, not 1e-6:
the JAX frontier sums its CPU histograms in float32 in row order, the port
in float64 rounded once, and XLA and PyTorch evaluate the float32 ``exp``
of the gradients to different ulps; over 10 trees that moves the predicted
probability by up to 2.2e-6 (measured over 8 seeds of this data; below
1e-6 on 3 of them; ROADMAP.md queue C).  A model carried across by its
text predicts raw scores bit-identical.  The data has no near-tie gain that the order could
flip.
Models written by either package load in the other.  The package must not
import JAX or anything of the JAX package, and must refuse the CPU unless
asked for it.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.metric import base as jmetric
from lightgbm_tpu.objective.binary import BinaryLogloss as JBinary
from lightgbm_tpu_torch import interop
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.device import NotPortedError
from lightgbm_tpu_torch.metric import base as tmetric
from lightgbm_tpu_torch.objective.binary import BinaryLogloss as TBinary

pytestmark = pytest.mark.torch_port
# one intra-op thread each: the suite runs in several worker processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "lightgbm_tpu_torch")
PARAMS = {"objective": "binary", "num_leaves": 15, "metric": "auc",
          "verbose": -1}
STRUCT_KEYS = ("num_leaves", "split_feature", "threshold", "decision_type",
               "left_child", "right_child", "num_cat", "shrinkage",
               "tree_sizes")


def _data(seed, n=4000, nv=1000, f=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n + nv, f)).astype(np.float32)
    X[rng.random(n + nv) < 0.03, 4] = np.nan
    y = (X[:, 0] + 0.5 * X[:, 1] ** 2 - X[:, 2] * X[:, 3]
         + 0.5 * rng.normal(size=n + nv) > 0.3).astype(np.float32)
    return X[:n], y[:n], X[n:], y[n:]


def _text_fields(text):
    """model text -> list of (key, value) lines, in order."""
    return [tuple(line.split("=", 1)) for line in text.splitlines()
            if "=" in line]


def _assert_same_model_text(tj, tt):
    fj, ft = _text_fields(tj), _text_fields(tt)
    assert [k for k, _ in fj] == [k for k, _ in ft]
    for (k, vj), (_, vt) in zip(fj, ft):
        if k == "tree_sizes":
            continue              # byte counts move with float digits
        if k in ("leaf_value",):
            np.testing.assert_allclose(np.array(vt.split(), float),
                                       np.array(vj.split(), float),
                                       rtol=0, atol=1e-5, err_msg=k)
        elif k in ("split_gain", "internal_value", "leaf_weight",
                   "internal_weight", "leaf_count", "internal_count"):
            np.testing.assert_allclose(np.array(vt.split(), float),
                                       np.array(vj.split(), float),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
        elif k in STRUCT_KEYS or k in ("version", "objective",
                                       "feature_names", "feature_infos",
                                       "max_feature_idx", "num_class"):
            assert vt == vj, k


@pytest.mark.parametrize("seed", [0, 3])
def test_train_matches_jax(seed):
    X, y, Xv, yv = _data(seed)
    ej, et = {}, {}
    dj = lgb.Dataset(X, label=y)
    bj = lgb.train(PARAMS, dj, 10, valid_sets=[dj.create_valid(Xv, yv)],
                   evals_result=ej, verbose_eval=False)
    dt = lgt.Dataset(X, label=y)
    bt = lgt.train(PARAMS, dt, 10, valid_sets=[dt.create_valid(Xv, yv)],
                   evals_result=et, verbose_eval=False, device="cpu")
    assert bt.num_trees() == bj.num_trees() == 10
    _assert_same_model_text(bj.model_to_string(), bt.model_to_string())
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv),
                               rtol=0, atol=5e-6)
    np.testing.assert_allclose(bt.predict(Xv, raw_score=True),
                               bj.predict(Xv, raw_score=True),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(et["valid_0"]["auc"], ej["valid_0"]["auc"],
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(bt.predict(Xv, pred_leaf=True),
                                  bj.predict(Xv, pred_leaf=True))


def _assert_same_predictions(a, b, X):
    """The same trees: raw scores bit-identical (both sum leaf values in f64
    on the host), probabilities to one f32 ulp (XLA's and PyTorch's f32
    ``exp`` differ by one)."""
    np.testing.assert_array_equal(a.predict(X, raw_score=True),
                                  b.predict(X, raw_score=True))
    np.testing.assert_allclose(a.predict(X), b.predict(X), rtol=0, atol=1.2e-7)


def test_models_load_across_packages(tmp_path):
    X, y, Xv, _ = _data(1, n=3000)
    bj = lgb.train(PARAMS, lgb.Dataset(X, label=y), 6, verbose_eval=False)
    bt = lgt.train(PARAMS, lgt.Dataset(X, label=y), 6, verbose_eval=False,
                   device="cpu")
    pj_file, pt_file = tmp_path / "jax.txt", tmp_path / "torch.txt"
    bj.save_model(str(pj_file))
    bt.save_model(str(pt_file))
    # a JAX model in the port: the text the JAX package writes after the
    # same reload, and the same predictions
    tj = lgt.Booster(model_file=str(pj_file), device="cpu")
    jj = lgb.Booster(model_file=str(pj_file))
    assert tj.model_to_string() == jj.model_to_string()
    _assert_same_predictions(tj, bj, Xv)
    # a port model in the JAX package
    jt = lgb.Booster(model_file=str(pt_file))
    tt = lgt.Booster(model_file=str(pt_file), device="cpu")
    assert jt.model_to_string() == tt.model_to_string()
    _assert_same_predictions(jt, bt, Xv)
    # interop: model text -> port Booster
    it = interop.booster_from_model_string(bj.model_to_string(),
                                           device="cpu")
    _assert_same_predictions(it, bj, Xv)


def test_reload_and_device_predict_are_bit_identical(tmp_path):
    """save_model -> Booster(model_file) predicts bit-identically, on the
    stacked device ensemble as on the host tree loop."""
    X, y, Xv, _ = _data(2, n=3000)
    bt = lgt.train(PARAMS, lgt.Dataset(X, label=y), 8, verbose_eval=False,
                   device="cpu")
    path = tmp_path / "m.txt"
    bt.save_model(str(path))
    re_ = lgt.Booster(model_file=str(path), device="cpu")
    np.testing.assert_array_equal(re_.predict(Xv), bt.predict(Xv))
    host = bt._gbdt.predict_raw(Xv)
    bt._gbdt.config.pred_device = "device"
    dev = bt._gbdt.predict_raw(Xv)
    np.testing.assert_allclose(dev, host, rtol=0, atol=1e-6)


def test_binary_objective_and_metrics_match_jax():
    rng = np.random.default_rng(0)
    n = 2000
    label = (rng.random(n) < 0.3).astype(np.float32)
    weight = rng.uniform(0.5, 2, n).astype(np.float32)
    score = rng.normal(size=n).astype(np.float32)
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import Metadata as JMeta
    from lightgbm_tpu_torch.io.dataset import Metadata as TMeta
    for params in ({}, {"is_unbalance": True}, {"scale_pos_weight": 2.0,
                                                "sigmoid": 1.5}):
        jm, tm = JMeta(n), TMeta(n)
        for md in (jm, tm):
            md.set_field("label", label)
            md.set_field("weight", weight)
        oj = JBinary(JConfig.from_params(dict(params)))
        ot = TBinary(TConfig.from_params(dict(params)))
        oj.init(jm, n)
        ot.init(tm, n)
        assert ot.boost_from_score() == oj.boost_from_score()
        gj, hj = oj.get_gradients(score, label, weight)
        gt, ht = ot.get_gradients(*map(torch.as_tensor,
                                       (score, label, weight)))
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-6)
        np.testing.assert_allclose(ot.convert_output(score.astype(np.float64)),
                                   np.asarray(oj.convert_output(score)),
                                   rtol=1e-6)
        cfg_j = JConfig.from_params({"metric": "auc,binary_logloss"})
        cfg_t = TConfig.from_params({"metric": "auc,binary_logloss"})
        for jcls, tcls in ((jmetric.AUCMetric, tmetric.AUCMetric),
                           (jmetric.BinaryLoglossMetric,
                            tmetric.BinaryLoglossMetric)):
            mj, mt = jcls(cfg_j), tcls(cfg_t)
            mj.init(jm, n)
            mt.init(tm, n)
            s64 = score.astype(np.float64)
            vj = mj.eval(s64, oj)[0][1]
            vt = mt.eval(s64, ot)[0][1]
            assert vt == pytest.approx(vj, rel=1e-6)


def test_device_none_means_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU error; this machine has a card")
    X, y, _, _ = _data(4, n=500)
    with pytest.raises(lgt.NoCudaDeviceError):
        lgt.train(PARAMS, lgt.Dataset(X, label=y), 2, verbose_eval=False)
    with pytest.raises(lgt.NoCudaDeviceError):
        lgt.Booster(model_str="tree\n")
    with pytest.raises(lgt.NoCudaDeviceError):
        lgt.Dataset(X, label=y).construct()


@pytest.mark.parametrize("params", [
    {"objective": "none"},
    {"monotone_constraints": [1, 0, 0, 0, 0, 0, 0, 0],
     "monotone_constraints_method": "intermediate", "tree_learner": "feature",
     "stream_rows": 256},
    {"interaction_constraints": [[0, 1], [2, 3]], "tree_learner": "voting",
     "stream_rows": 256},
    {"cegb_penalty_split": 0.5, "stream_rows": 256},
    {"tree_grower": "serial", "tree_learner": "data", "stream_rows": 256},
    {"tree_learner": "data", "max_bin_matrix_bytes": 1024},
    {"feature_contri": [1.0] * 8, "tree_learner": "feature",
     "stream_rows": 256},
    {"linear_tree": True, "max_bin_matrix_bytes": 1024}])
def test_untaken_paths_raise(params):
    X, y, _, _ = _data(5, n=800)
    # the serial grower's features are ported (tests/test_torch_serial.py,
    # test_torch_constraints.py, test_torch_linear_tree.py), and so are the
    # parallel tree learners in memory (tests/test_torch_parallel.py); over
    # out-of-core streaming a parallel learner is not ported yet (A21b) and
    # raises, never falling back, and streaming (ported:
    # tests/test_torch_stream.py) refuses the features it does not serve,
    # as the JAX package's does.  Objective "none" is ported (custom
    # gradients, test_torch_engine.py): without the caller's gradients it
    # raises as the JAX package does
    if params.get("objective") == "none":
        err, match = lgt.LightGBMError, "custom grad"
    elif "tree_learner" in params:
        err, match = NotPortedError, "A21b"
    else:
        err, match = lgt.LightGBMError, "streaming does not support"
    with pytest.raises(err, match=match):
        lgt.train({**PARAMS, **params}, lgt.Dataset(X, label=y), 2,
                  verbose_eval=False, device="cpu")


_IMPORT_CHECK = r"""
import sys
import lightgbm_tpu_torch
import lightgbm_tpu_torch.interop, lightgbm_tpu_torch.ops.frontier
import lightgbm_tpu_torch.ops.ensemble, lightgbm_tpu_torch.ops.shap
import lightgbm_tpu_torch.native, lightgbm_tpu_torch.io.loader
import lightgbm_tpu_torch.models.convert, lightgbm_tpu_torch.application
import lightgbm_tpu_torch.sklearn, lightgbm_tpu_torch.plotting
import lightgbm_tpu_torch.ops.linear
import lightgbm_tpu_torch.serve, lightgbm_tpu_torch.stream
import lightgbm_tpu_torch.parallel, lightgbm_tpu_torch.io.distributed
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "lightgbm_tpu" or m.startswith("lightgbm_tpu."))
print("BAD", bad)
assert not bad, bad
"""


def test_package_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if "PYTHONPATH" not in k}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    pat = re.compile(r"^\s*(import|from)\s+(jax\b|jaxlib\b|lightgbm_tpu\b"
                     r"(?!_torch))", re.M)
    offenders = []
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as fh:
                    if pat.search(fh.read()):
                        offenders.append(path)
    assert not offenders
