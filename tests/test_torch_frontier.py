"""PyTorch port, frontier grower: the same trees as the JAX frontier.

Both packages bin the same data (made from a seed) and grow one tree from
the same gradients; the JAX frontier runs on the CPU, where it takes the
scatter histogram.  Tree structure (features, thresholds, missing
directions, children, leaf count) and the node assignment must be
identical; float fields agree to 1e-4 relative.  The JAX histograms are
float32 sums in row order, the port's float64 sums rounded once, and each
child's sums are its parent's minus its sibling's, so a float32 error at
the root grows relative to the smaller sums down the tree (measured up to
4.4e-5 on a 31-leaf tree).  The data has
a strong signal and no near-tie gains, so that order cannot flip a split.
"""
import functools

import jax
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.ops import frontier as jfront
from lightgbm_tpu.ops import grower as jgrow
from lightgbm_tpu.ops import predict as jpred
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch import interop
from lightgbm_tpu_torch.device import NotPortedError
from lightgbm_tpu_torch.ops import grower as tgrow
from lightgbm_tpu_torch.ops import predict as tpred
from lightgbm_tpu_torch.ops import split as tsplit

pytestmark = pytest.mark.torch_port
# one intra-op thread each: the suite runs in several worker processes
torch.set_num_threads(1)

SPLIT = dict(lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=20,
             min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0,
             max_delta_step=0.0, path_smooth=0.0, cat_smooth=10.0,
             cat_l2=10.0, max_cat_to_onehot=4)


def _problem(seed, n=4000, f=8, weights=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[rng.random(n) < 0.05, 2] = np.nan
    logit = 1.5 * X[:, 0] - X[:, 1] + np.nan_to_num(X[:, 2]) * X[:, 3]
    y = (logit + 0.5 * rng.normal(size=n) > 0).astype(np.float32)
    ds = lgb.Dataset(X, label=y, params={"verbose": -1}).construct()._inner
    p = 1.0 / (1.0 + np.exp(-0.3))
    g = (p - y).astype(np.float32)
    h = np.full(n, p * (1 - p), np.float32)
    rw = np.ones(n, np.float32)
    if weights:
        rw = np.where(rng.random(n) < 0.2, 0.0,
                      rng.uniform(0.5, 2.0, n)).astype(np.float32)
    return ds, g, h, rw


def _jax_tree(ds, g, h, rw, L, k, BR, max_depth):
    dd = ds.device_data()
    f = ds.num_features
    cfg = jgrow.GrowerConfig(
        num_leaves=L, max_depth=max_depth, max_bin=dd_max_bin(ds),
        split=jsplit.SplitParams(**SPLIT), feature_fraction_bynode=1.0,
        hist_method="scatter", hist_chunk_rows=65536, sorted_cat=False,
        frontier_k=k, frontier_block_rows=BR)
    fn = jax.jit(functools.partial(
        jfront.grow_tree_frontier, num_bins=dd.num_bins,
        default_bins=dd.default_bins, nan_bins=dd.nan_bins,
        is_categorical=dd.is_categorical, monotone=dd.monotone,
        key=jax.random.key(0), cfg=cfg))
    tree, assign = fn(dd.bins, g, h, rw, np.ones(f, np.float32))
    return jax.device_get(tree), np.asarray(assign), cfg


def dd_max_bin(ds):
    """The boosting loop's histogram width (gbdt.py _make_grower_cfg)."""
    nb = max(ds.num_bin(i) for i in range(ds.num_features))
    return max(4, min(255 + 1, -(-nb // 4) * 4))


def _torch_tree(ds, g, h, rw, L, k, BR, max_depth):
    from lightgbm_tpu_torch.io.bin import BinMapper
    dd_bins = torch.as_tensor(ds.bins)
    mappers = [BinMapper.from_state(ds.bin_mappers[r].to_state())
               for r in ds.used_features]
    nb = torch.as_tensor([m.num_bin for m in mappers], dtype=torch.int32)
    nan_bins = torch.as_tensor(np.array(ds.device_data().nan_bins))
    cfg = tgrow.GrowerConfig(
        num_leaves=L, max_depth=max_depth, max_bin=dd_max_bin(ds),
        split=tsplit.SplitParams(**SPLIT), frontier_k=k,
        frontier_block_rows=BR)
    return tgrow.grow_tree(dd_bins, *map(torch.as_tensor, (g, h, rw)),
                           torch.ones(ds.num_features), nb, nan_bins, cfg)


STRUCT = ("split_feature", "threshold", "default_left", "is_cat_split",
          "cat_bits", "left_child", "right_child", "num_leaves")
FLOATS = ("split_gain", "leaf_value", "leaf_count", "leaf_weight",
          "internal_value", "internal_count")


@pytest.mark.parametrize("case", [
    dict(seed=0, L=15, k=16, BR=512, max_depth=-1),
    dict(seed=1, L=31, k=4, BR=128, max_depth=-1),
    dict(seed=2, L=31, k=8, BR=256, max_depth=4, weights=True),
], ids=["L15_k16", "L31_k4_rounds", "L31_depth4_weighted"])
def test_frontier_matches_jax(case):
    ds, g, h, rw = _problem(case["seed"], weights=case.get("weights", False))
    args = (case["L"], case["k"], case["BR"], case["max_depth"])
    tj, aj, _ = _jax_tree(ds, g, h, rw, *args)
    tt, at, host = _torch_tree(ds, g, h, rw, *args)
    assert int(tj.num_leaves) == case["L"] or case["max_depth"] > 0
    assert int(tj.num_leaves) > 8
    for name in STRUCT:
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(tj, name)),
                                      err_msg=name)
        np.testing.assert_array_equal(np.asarray(getattr(host, name)),
                                      np.asarray(getattr(tj, name)),
                                      err_msg=name)
    for name in FLOATS:
        np.testing.assert_allclose(getattr(tt, name).numpy(),
                                   np.asarray(getattr(tj, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(at.numpy(), aj)


def test_predict_leaf_binned_matches_jax_through_interop():
    """A JAX tree carried across with ``tree_arrays_from_numpy`` routes
    every training row (NaN bins included) to the same leaf."""
    ds, g, h, rw = _problem(5)
    tj, aj, _ = _jax_tree(ds, g, h, rw, 31, 16, 512, -1)
    tree = interop.tree_arrays_from_numpy(tj._asdict(), device="cpu")
    back = interop.tree_arrays_to_numpy(tree)
    for name in tgrow.TreeArrays._fields:
        np.testing.assert_array_equal(back[name], np.asarray(getattr(tj, name)))
    dd = ds.device_data()
    ref = np.asarray(jax.jit(jpred.predict_leaf_binned)(tj, dd.bins,
                                                        dd.nan_bins))
    bins = torch.as_tensor(ds.bins)
    nan_bins = torch.as_tensor(np.array(dd.nan_bins))
    got = tpred.predict_leaf_binned(tree, bins, nan_bins)
    depth = tpred.tree_depth(back["left_child"], back["right_child"],
                             int(back["num_leaves"]))
    got_d = tpred.predict_leaf_binned(tree, bins, nan_bins, depth=depth)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got_d.numpy(), ref)
    np.testing.assert_array_equal(ref, aj)


def test_single_leaf_when_nothing_splits():
    ds, g, h, rw = _problem(3, n=600)
    cfg = tgrow.GrowerConfig(
        num_leaves=7, max_depth=-1, max_bin=dd_max_bin(ds),
        split=tsplit.SplitParams(**{**SPLIT, "min_data_in_leaf": 400}))
    tree, assign, host = tgrow.grow_tree(
        torch.as_tensor(ds.bins), *map(torch.as_tensor, (g, h, rw)),
        torch.ones(ds.num_features),
        torch.as_tensor(np.array(ds.device_data().num_bins)),
        torch.as_tensor(np.array(ds.device_data().nan_bins)), cfg)
    assert int(host.num_leaves) == 1
    assert float(host.leaf_count[0]) == 600.0
    assert not assign.any()


@pytest.mark.parametrize("field,value", [
    ("grower_mode", "serial"), ("has_monotone", True),
    ("extra_trees", True), ("feature_fraction_bynode", 0.5),
    ("cegb_split_penalty", 1.0)])
def test_ineligible_configs_raise(field, value):
    cfg = tgrow.GrowerConfig(num_leaves=7, max_depth=-1, max_bin=16,
                             split=tsplit.SplitParams(**SPLIT))
    assert tgrow._frontier_eligible(cfg, 4)
    bad = cfg._replace(**{field: value})
    assert not tgrow._frontier_eligible(bad, 4)
    z = torch.zeros(64)
    with pytest.raises(NotPortedError):
        tgrow.grow_tree(torch.zeros(64, 4, dtype=torch.uint8), z, z, z,
                        torch.ones(4), torch.full((4,), 16), torch.full(
                            (4,), -1), bad)


def test_eligibility_budget_is_shared_memory():
    """One feature's [B, 3] f32 histogram must fit a CTA's shared memory."""
    cfg = tgrow.GrowerConfig(num_leaves=7, max_depth=-1, max_bin=256,
                             split=tsplit.SplitParams(**SPLIT))
    assert tgrow._frontier_eligible(cfg, 10_000)
    too_wide = cfg._replace(max_bin=20_000)
    assert not tgrow._frontier_eligible(too_wide, 4)
