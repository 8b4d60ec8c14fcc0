"""PyTorch port, the training knobs that draw rows and features, and the
boosting types, against the JAX package on the CPU.

The bag masks (bagging, pos/neg bagging, GOSS with its amplification) and
the compacted bag's row ids are exactly JAX's.  Trained models match per
setting as ``tests/test_torch_train.py`` holds them: the same model text
apart from float digits, leaf values within 1e-5 and predictions within
5e-6.  RF's leaves carry no shrinkage (``rf.hpp:48``), ten times a
``learning_rate=0.1`` leaf, so the same float32 summation residue (ROADMAP
queue C, "not faults") is held to 1e-5 on that scale: 1e-4.  A model
written by either package loads in the other, RF's ``average_output``
included.
"""
import functools

import jax
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.models.gbdt import bag_mask_from_uniform as jbag
from lightgbm_tpu.models.goss import goss_mask_from_importance as jgoss
from lightgbm_tpu.utils.random_gen import key_for_iteration as jkey
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.models.gbdt import bag_mask_from_uniform as tbag
from lightgbm_tpu_torch.models.goss import goss_mask_from_importance as tgoss
from lightgbm_tpu_torch.utils import random_gen as trng
from test_torch_train import PARAMS, _assert_same_model_text, _data

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

ITERS = 6
# each JAX run compiles its own grow program (~4 s here), so settings that
# touch different code share a run: the masked bag with feature_fraction,
# monotone-basic's bounds with its penalty.  The per-node draws
# (feature_fraction_bynode, extra_trees) train in tests/test_torch_rng.py
SETTINGS = {
    "bagging_masked_feature_fraction": dict(
        bagging_fraction=0.8, bagging_freq=2, feature_fraction=0.75),
    "bagging_compacted": dict(bagging_fraction=0.5, bagging_freq=1),
    "monotone_basic": dict(monotone_constraints=[1, 0, 0, 0, 0, 0, 0, -1],
                           monotone_penalty=1.5),
    "goss": dict(boosting="goss"),
    "dart": dict(boosting="dart", drop_rate=0.3),
    "rf": dict(boosting="rf", bagging_fraction=0.5, bagging_freq=1,
               feature_fraction=0.8),
}


@functools.lru_cache(maxsize=None)
def _trained(name):
    X, y, Xv, _ = _data(0)
    params = {**PARAMS, **SETTINGS[name]}
    bj = lgb.train(params, lgb.Dataset(X, label=y), ITERS, verbose_eval=False)
    bt = lgt.train(params, lgt.Dataset(X, label=y), ITERS, verbose_eval=False,
                   device="cpu")
    return bj, bt, Xv


@pytest.mark.parametrize("name", list(SETTINGS))
def test_sampling_trains_like_jax(name):
    bj, bt, Xv = _trained(name)
    assert bt.num_trees() == bj.num_trees() == ITERS
    tj, tt = bj.model_to_string(), bt.model_to_string()
    if name == "rf":
        # unshrunk leaves: 1e-5 on the learning_rate=0.1 scale
        def leaves(text):
            return [np.array(ln.split("=", 1)[1].split(), float)
                    for ln in text.splitlines()
                    if ln.startswith("leaf_value=")]
        for vj, vt in zip(leaves(tj), leaves(tt), strict=True):
            np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-4)

        def strip(text):
            return "\n".join(ln for ln in text.splitlines()
                             if not ln.startswith("leaf_value="))
        tj, tt = strip(tj), strip(tt)
    _assert_same_model_text(tj, tt)
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), rtol=0,
                               atol=5e-6)
    np.testing.assert_array_equal(bt.predict(Xv, pred_leaf=True),
                                  bj.predict(Xv, pred_leaf=True))


def _mask_inputs(n=5000):
    rng = np.random.default_rng(4)
    label = (rng.random(n) < 0.3).astype(np.float32)
    g = rng.normal(size=(2, n)).astype(np.float32)
    h = rng.uniform(0.1, 0.3, (2, n)).astype(np.float32)
    g[:, : n // 3] = 0.25                 # ties in |g*h|, as early on
    h[:, : n // 3] = 0.25
    return label, g, h


@pytest.mark.parametrize("case", ["bagging", "pos_neg", "goss"])
def test_bag_masks_match_jax(case):
    label, g, h = _mask_inputs()
    n = len(label)
    params = {"bagging_fraction": 0.6, "bagging_freq": 1}
    if case == "pos_neg":
        params = {"pos_bagging_fraction": 0.7, "neg_bagging_fraction": 0.4,
                  "bagging_freq": 1}
    if case == "goss":
        params = {"boosting": "goss", "top_rate": 0.2, "other_rate": 0.1}
    cj, ct = JConfig.from_params(params), TConfig.from_params(params)
    uj = jax.random.uniform(jkey(cj.bagging_seed, 3), (n,))
    ut = trng.uniform(trng.key_for_iteration(ct.bagging_seed, 3), n)
    if case != "goss":
        mj = np.asarray(jbag(cj, uj, label))
        mt = tbag(ct, ut, torch.as_tensor(label)).numpy()
        np.testing.assert_array_equal(mt, mj)
        assert 0 < mt.sum() < n
        return
    imp_j = np.asarray(np.sum(np.abs(g * h), axis=0))
    imp_t = torch.sum(torch.abs(torch.as_tensor(g) * torch.as_tensor(h)), 0)
    np.testing.assert_array_equal(imp_t.numpy(), imp_j)
    k_top = max(1, int(cj.top_rate * n))
    mj, aj = jgoss(cj, imp_j, uj, k_top)
    mt, at = tgoss(ct, imp_t, ut, k_top)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert (at.numpy() > 1).any()


@pytest.mark.parametrize("name", ["bagging_compacted", "goss"])
def test_compacted_bag_matches_jax(name):
    """The compacted bag: in-bag rows in order, then padding that repeats
    row n - 1 with weight 0 -- row ids, weights and bins all exact."""
    X, y, _, _ = _data(0)
    params = {**PARAMS, **SETTINGS[name]}
    bj = lgb.Booster(params, lgb.Dataset(X, label=y))
    bt = lgt.Booster(params, lgt.Dataset(X, label=y), device="cpu")
    cap = bt._gbdt._bag_subset_capacity()
    assert cap is not None and cap == bj._gbdt._bag_subset_capacity()
    n = len(y)
    mask = (np.random.default_rng(1).random(n) < 0.45).astype(np.float32)
    rj, wj, bbj = bj._gbdt._bag_compact_jit(mask, bj._gbdt._dd.bins, cap)
    rt, wt, bbt = bt._gbdt._bag_compact(torch.as_tensor(mask), cap)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(bbt.numpy(), np.asarray(bbj))
    k = int(mask.sum())
    assert k < cap and (rt.numpy()[k:] == n - 1).all()
    assert not wt.numpy()[k:].any()


def test_monotone_predictions_are_monotone():
    """Along a +1 (-1) feature, raising it never lowers (raises) the
    prediction of the port's model."""
    _, bt, Xv = _trained("monotone_basic")
    grid = np.linspace(-3, 3, 25)
    rows = np.repeat(Xv[:40], len(grid), axis=0)
    for feat, sign in ((0, 1), (7, -1)):
        r = rows.copy()
        r[:, feat] = np.tile(grid, 40)
        p = bt.predict(r, raw_score=True).reshape(40, len(grid))
        assert (sign * np.diff(p, axis=1) >= -1e-12).all()


def test_rf_models_load_across_packages(tmp_path):
    """RF's ``average_output`` survives the text both ways; the port's
    loader averages like the trained RF (the JAX package's loaded GBDT
    keeps the flag but sums: ROADMAP queue C)."""
    bj, bt, Xv = _trained("rf")
    pj, pt = tmp_path / "jax.txt", tmp_path / "torch.txt"
    bj.save_model(str(pj))
    bt.save_model(str(pt))
    tj = lgt.Booster(model_file=str(pj), device="cpu")
    assert "average_output" in tj.model_to_string().split("\n")[:8]
    assert tj.model_to_string() == lgb.Booster(model_file=str(pj)).model_to_string()
    np.testing.assert_array_equal(tj.predict(Xv, raw_score=True),
                                  bj.predict(Xv, raw_score=True))
    jt = lgb.Booster(model_file=str(pt))
    tt = lgt.Booster(model_file=str(pt), device="cpu")
    assert jt.model_to_string() == tt.model_to_string()
    np.testing.assert_array_equal(jt.predict(Xv, pred_leaf=True),
                                  tt.predict(Xv, pred_leaf=True))
    np.testing.assert_array_equal(tt.predict(Xv), bt.predict(Xv))
