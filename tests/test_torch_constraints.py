"""PyTorch port, the features that need the split order -- interaction
constraints, forced splits, CEGB, monotone intermediate and advanced --
and ``feature_contri`` on both growers, against the JAX package on the CPU.

Each trains the JAX package's model (same model text apart from float
digits, split gains to 1e-4 of the largest, leaf values to 1e-5,
predictions to 5e-6 and the same ``pred_leaf``), as
``tests/test_torch_train.py`` holds the default path; the residue is the
JAX CPU's float32 row-order histogram sums against the port's float64
sums (ROADMAP.md queue C).  The monotone modes' port predictions are
monotone along their constrained features.  One JAX booster per setting
(its serial grower compiles per booster), shared by the module.
"""
import functools
import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops import grower as tgrow
from lightgbm_tpu_torch.utils.log import Log
from test_torch_objectives import _assert_same_models
from test_torch_train import PARAMS, _data

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ITERS = 5
# a forced root on feature 1 and three nested splits (BFS order: the
# root's left, its right, the left's right)
FORCED = {"feature": 1, "threshold": 0.2,
          "left": {"feature": 0, "threshold": -0.3,
                   "right": {"feature": 6, "threshold": 0.1}},
          "right": {"feature": 2, "threshold": 0.0}}
MONO = {"objective": "regression", "num_leaves": 15, "verbose": -1,
        "monotone_constraints": [1, 0, 0, -1], "min_data_in_leaf": 20}
SETTINGS = {
    "interaction_constraints": dict(
        interaction_constraints=[[0, 1], [2, 3, 4], [5, 6, 7]]),
    "forced_splits": dict(forcedsplits_filename="forced.json"),
    "cegb_split": dict(cegb_penalty_split=0.05),
    "cegb_coupled_lazy": dict(
        cegb_penalty_feature_coupled=[5.0, 0, 3.0, 0, 1.0, 0, 0, 2.0],
        cegb_penalty_feature_lazy=[0.01, 0, 0.02, 0, 0.01, 0, 0, 0.02]),
    "monotone_intermediate": dict(MONO,
                                  monotone_constraints_method="intermediate"),
    "monotone_advanced": dict(MONO, monotone_constraints_method="advanced"),
    "feature_contri": dict(
        feature_contri=[1.0, 0.5, 0.8, 1.0, 0.3, 1.0, 1.0, 0.9]),
    "feature_contri_serial": dict(
        feature_contri=[1.0, 0.5, 0.8, 1.0, 0.3, 1.0, 1.0, 0.9],
        tree_grower="serial"),
}


def _monotone_data(seed=0, n=3000):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, 4))
    y = (1.5 * X[:, 0] + np.sin(2 * X[:, 1]) + 0.3 * X[:, 2] ** 2
         - 0.8 * X[:, 3] + rng.normal(0, 0.2, n))
    return X, y, X[:600]


@functools.lru_cache(maxsize=None)
def _trained(name, tmp_dir):
    params = {**PARAMS, **SETTINGS[name]}
    if name.startswith("monotone"):
        params = dict(SETTINGS[name])
        X, y, Xv = _monotone_data()
    else:
        X, y, Xv, _ = _data(0)
    if "forcedsplits_filename" in params:
        path = f"{tmp_dir}/forced.json"
        with open(path, "w") as fh:
            json.dump(FORCED, fh)
        params["forcedsplits_filename"] = path
    bj = lgb.train(params, lgb.Dataset(X, label=y), ITERS, verbose_eval=False)
    bt = lgt.train(params, lgt.Dataset(X, label=y), ITERS, verbose_eval=False,
                   device="cpu")
    return bj, bt, X, Xv


@pytest.fixture(scope="module")
def tmp_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("forced"))


@pytest.mark.parametrize("name", list(SETTINGS))
def test_constraint_trains_like_jax(name, tmp_dir):
    bj, bt, _, Xv = _trained(name, tmp_dir)
    assert bt.num_trees() == bj.num_trees() == ITERS
    _assert_same_models(bj.model_to_string(), bt.model_to_string())
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), rtol=5e-6,
                               atol=5e-6)
    np.testing.assert_array_equal(bt.predict(Xv, pred_leaf=True),
                                  bj.predict(Xv, pred_leaf=True))


def test_forced_splits_land_and_a_failed_one_is_skipped(tmp_dir):
    """The forced splits are the tree's first nodes.  A forced split whose
    right child is empty gains nothing and is skipped (the reference's
    GatherInfoForThreshold sums that side to exactly zero), its forced
    child is dropped with it, and the forced split after them lands on the
    leaf it names, leaving no gap in the node arrays.  The JAX package
    takes the empty side as the leaf's total less the other side, and that
    rounding residue lands the split in one of the two trees (ROADMAP.md
    queue C): the difference is pinned on both sides."""
    _, bt, _, _ = _trained("forced_splits", tmp_dir)
    for info in bt.dump_model()["tree_info"]:
        root = info["tree_structure"]
        assert root["split_feature"] == 1
        assert root["left_child"]["split_feature"] == 0
        assert root["left_child"]["right_child"]["split_feature"] == 6
        assert root["right_child"]["split_feature"] == 2
    failing = {"feature": 1, "threshold": 0.2,
               "left": {"feature": 5, "threshold": 1e9,
                        "left": {"feature": 7, "threshold": 0.0}},
               "right": {"feature": 0, "threshold": -0.3}}
    path = f"{tmp_dir}/failing.json"
    with open(path, "w") as fh:
        json.dump(failing, fh)
    X, y, _, _ = _data(0)
    bst = lgt.train({**PARAMS, "forcedsplits_filename": path},
                    lgt.Dataset(X, label=y), 2, verbose_eval=False,
                    device="cpu")
    bj = lgb.train({**PARAMS, "forcedsplits_filename": path},
                   lgb.Dataset(X, label=y), 2, verbose_eval=False)
    assert any(info["tree_structure"]["left_child"].get("split_feature") == 5
               for info in bj.dump_model()["tree_info"])

    def count(node):
        if "split_index" not in node:
            return 0, 1
        left, right = count(node["left_child"]), count(node["right_child"])
        return left[0] + right[0] + 1, left[1] + right[1]
    for info in bst.dump_model()["tree_info"]:
        root = info["tree_structure"]
        assert root["split_feature"] == 1
        assert root["right_child"]["split_feature"] == 0
        assert root["split_index"] == 0 and \
            root["right_child"]["split_index"] == 1
        assert root["left_child"].get("split_feature") != 5
        internals, leaves = count(root)
        assert leaves == internals + 1 == info["num_leaves"] == \
            PARAMS["num_leaves"]


def _monotone_violation(bst, X, fidx, sign):
    """Max violation of sign-monotonicity in feature ``fidx`` over a sweep
    of the feature's range (the JAX package's test helper)."""
    base = X[:200].copy()
    prev, worst = None, 0.0
    for v in np.linspace(-2, 2, 50):
        b = base.copy()
        b[:, fidx] = v
        p = bst.predict(b)
        if prev is not None:
            worst = max(worst, float(np.max(sign * (prev - p))))
        prev = p
    return worst


@pytest.mark.parametrize("name", ["monotone_intermediate",
                                  "monotone_advanced"])
def test_monotone_modes_are_monotone(name, tmp_dir):
    _, bt, X, _ = _trained(name, tmp_dir)
    assert _monotone_violation(bt, X, 0, +1) <= 1e-10
    assert _monotone_violation(bt, X, 3, -1) <= 1e-10


def test_modes_differ(tmp_dir):
    """Intermediate and advanced are distinct modes, and each CEGB
    penalty changes the model."""
    _, inter, _, _ = _trained("monotone_intermediate", tmp_dir)
    _, adv, _, _ = _trained("monotone_advanced", tmp_dir)
    assert inter.model_to_string() != adv.model_to_string()
    X, y, Xv, _ = _data(0)
    base = lgt.train(PARAMS, lgt.Dataset(X, label=y), ITERS,
                     verbose_eval=False, device="cpu")
    for name in ("cegb_split", "cegb_coupled_lazy"):
        _, cegb, _, _ = _trained(name, tmp_dir)
        assert not np.allclose(cegb.predict(Xv), base.predict(Xv)), name
    # the split penalty grows smaller trees
    _, cegb, _, _ = _trained("cegb_split", tmp_dir)
    assert cegb.num_trees() == ITERS
    assert cegb.dump_model()["tree_info"][-1]["num_leaves"] < \
        PARAMS["num_leaves"]


def test_frontier_request_takes_the_serial_grower(monkeypatch):
    """``tree_grower=frontier`` with a feature only the sequential grower
    serves logs the JAX package's warning and trains serially."""
    cfg = tgrow.GrowerConfig(num_leaves=7, max_depth=-1, max_bin=16,
                             split=None, grower_mode="frontier")
    said = []
    monkeypatch.setattr(Log, "warning", lambda msg, *a: said.append(msg % a))
    assert not tgrow._frontier_eligible(cfg, 4, forced=((0, 0, 3, -1),))
    assert said == ["tree_grower=frontier is not compatible with the "
                    "requested features; using the serial grower"]
    assert tgrow._frontier_eligible(cfg, 4)
