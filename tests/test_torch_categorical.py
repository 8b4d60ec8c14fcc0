"""PyTorch port, categorical features against the JAX package on the CPU.

- The split search on handmade histograms (numpy, from a seed, consistent
  across features): the one-hot categorical split (a feature of at most
  ``max_cat_to_onehot`` bins, ``bin == t`` left) and the sorted
  many-category split (bins ordered by ``sum_g / (sum_h + cat_smooth)``,
  prefixes from both ends) give the JAX package's feature, threshold and
  bin bitset, gains and sums to 1e-5 relative.
- Categorical bin mappers and bins are the JAX package's.
- Training with a one-hot and a sorted categorical feature grows the JAX
  package's trees: the same model text (``cat_threshold`` included) and
  predictions within 5e-6.  The data keep the sorted scan away from exact
  ties: the two ends of a scan over ``u`` used categories reach
  complementary left sets when their prefixes add up to ``u``, whose gains
  are equal but for float32 rounding, so which one wins is noise in both
  packages; a small ``max_cat_threshold`` with many used categories and
  few leaves keeps every scan's prefixes short of that.
- A categorical model written by either package loads in the other and
  predicts the same, on the host tree loop and on the stacked ensemble.
"""
import jax
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.ops import split as tsplit
from test_torch_objectives import _assert_same_models

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

# features: numeric, one-hot categorical (4 bins), sorted categorical (24
# bins), numeric
NUM_BINS = np.array([32, 4, 24, 16], np.int32)
IS_CAT = np.array([False, True, True, False])
F, B = 4, 32


def _params(**kw):
    base = dict(lambda_l1=0.0, lambda_l2=1.0, min_data_in_leaf=20,
                min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0,
                max_delta_step=0.0, path_smooth=0.0, cat_smooth=10.0,
                cat_l2=10.0, max_cat_to_onehot=4, max_cat_threshold=6,
                min_data_per_group=30)
    base.update(kw)
    return jsplit.SplitParams(**base), tsplit.SplitParams(**base)


def _leaves(seed, n_leaves=3):
    """Consistent histograms of random rows whose gradient depends on the
    categorical features' bins."""
    rng = np.random.default_rng(seed)
    eff1 = rng.normal(size=4)
    eff2 = rng.normal(size=24) * 1.5
    hists, tots = [], []
    for _ in range(n_leaves):
        n = int(rng.integers(1500, 3000))
        bins = np.stack([rng.integers(0, nb, n) for nb in NUM_BINS], 1)
        g = (rng.normal(size=n) + eff1[bins[:, 1]]
             + eff2[bins[:, 2]]).astype(np.float32)
        h = rng.uniform(0.1, 0.25, n).astype(np.float32)
        hist = np.zeros((F, B, 3), np.float32)
        for f in range(F):
            np.add.at(hist[f], bins[:, f], np.stack([g, h, np.ones(n)], 1))
        hists.append(hist)
        tots.append((np.float32(g.sum()), np.float32(h.sum()),
                     np.float32(n)))
    return np.stack(hists), np.array(tots, np.float32)


@pytest.mark.parametrize("case,allowed", [("all", [0, 1, 2, 3]),
                                          ("onehot", [1]),
                                          ("sorted", [2])])
def test_categorical_split_search_matches_jax(case, allowed):
    pj, pt = _params()
    hists, tots = _leaves(len(case))
    fmask = np.zeros(F, np.float32)
    fmask[allowed] = 1.0
    nan_bins = np.full(F, -1, np.int32)
    got = tsplit.find_best_split(
        torch.as_tensor(hists), torch.as_tensor(NUM_BINS),
        torch.as_tensor(nan_bins), torch.as_tensor(tots[:, 0]),
        torch.as_tensor(tots[:, 1]), torch.as_tensor(tots[:, 2]), pt,
        torch.as_tensor(fmask), is_categorical=torch.as_tensor(IS_CAT),
        sorted_cat=torch.tensor([2]))
    kinds = set()
    for s in range(hists.shape[0]):
        ref = jax.device_get(jsplit.find_best_split(
            hists[s], NUM_BINS, np.zeros(F, np.int32), nan_bins, IS_CAT,
            np.zeros(F, np.int8), tots[s, 0], tots[s, 1], tots[s, 2], pj,
            fmask, sorted_cat=True))
        assert ref.gain > jsplit.NEG_INF / 2
        assert int(got.feature[s]) == int(ref.feature)
        assert int(got.threshold[s]) == int(ref.threshold)
        assert bool(got.default_left[s]) == bool(ref.default_left)
        np.testing.assert_array_equal(got.cat_bits[s].numpy(),
                                      np.asarray(ref.cat_bits))
        for name in ("gain", "left_sum_g", "left_sum_h", "left_count",
                     "right_sum_g", "right_sum_h", "right_count",
                     "left_output", "right_output"):
            np.testing.assert_allclose(float(getattr(got, name)[s]),
                                       float(getattr(ref, name)),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
        nbits = int(np.unpackbits(np.asarray(ref.cat_bits).view(np.uint8)
                                  ).sum())
        kinds.add("numeric" if not IS_CAT[int(ref.feature)]
                  else "onehot" if nbits == 1 else "sorted")
    if case != "all":
        assert kinds == {case}


def test_pack_bin_bitset_matches_jax():
    rng = np.random.default_rng(0)
    member = rng.random((5, 70)) < 0.4
    member[0, 31] = member[0, 63] = True             # the sign bits
    want = np.asarray(jsplit.pack_bin_bitset(member))
    got = tsplit.pack_bin_bitset(torch.as_tensor(member))
    np.testing.assert_array_equal(got.numpy(), want)
    idx = torch.arange(70).repeat(5)
    rows = torch.arange(5).repeat_interleave(70)
    np.testing.assert_array_equal(
        tsplit.bitset_contains(got, idx, rows).numpy().reshape(5, 70),
        member)
    for r in range(5):
        np.testing.assert_array_equal(
            tsplit.bitset_contains(got[r], torch.arange(70)).numpy(),
            member[r])


def _cat_data(seed, n=3000):
    """A one-hot categorical column (4 levels), a sorted one (40 levels,
    one of them rare, codes up to 60 with gaps), NaN categories, and
    numeric columns."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6))
    X[:, 0] = rng.integers(0, 4, n)
    codes = rng.choice(np.arange(0, 60, 3)[:20].tolist()
                       + list(range(1, 40, 2)), n)
    X[:, 1] = codes
    X[rng.random(n) < 0.02, 1] = np.nan
    eff = np.sin(np.arange(61) * 1.3) * 1.5
    lat = (eff[np.nan_to_num(X[:, 1], nan=0).astype(int)]
           + 1.2 * (X[:, 0] == 2) + X[:, 2] + 0.5 * X[:, 3] * X[:, 4])
    y = (lat + 0.5 * rng.normal(size=n) > 0.3).astype(np.float32)
    return X, y


CAT_PARAMS = {"objective": "binary", "num_leaves": 7, "verbose": -1,
              "max_cat_to_onehot": 4, "max_cat_threshold": 4,
              "cat_smooth": 5, "min_data_per_group": 30}


@pytest.mark.parametrize("onehot", [4, 64], ids=["sorted", "all_onehot"])
def test_categorical_trains_like_jax(onehot):
    X, y = _cat_data(0)
    Xv, _ = _cat_data(1, n=1000)
    params = dict(CAT_PARAMS, max_cat_to_onehot=onehot)
    dj = lgb.Dataset(X, label=y, categorical_feature=[0, 1])
    dt = lgt.Dataset(X, label=y, categorical_feature=[0, 1])
    bj = lgb.train(params, dj, 5, verbose_eval=False)
    bt = lgt.train(params, dt, 5, verbose_eval=False, device="cpu")
    # the same categorical mappers and bins
    for mj, mt in zip(dj._inner.bin_mappers, dt._inner.bin_mappers):
        assert mt.to_state() == mj.to_state()
    np.testing.assert_array_equal(dt._inner.bins, dj._inner.bins)
    assert dt._inner.device_data("cpu").is_categorical.tolist() == \
        [True, True, False, False, False, False]
    tj, tt = bj.model_to_string(), bt.model_to_string()
    assert "cat_threshold=" in tj
    _assert_same_models(tj, tt)
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), rtol=0,
                               atol=5e-6)
    np.testing.assert_array_equal(bt.predict(Xv, pred_leaf=True),
                                  bj.predict(Xv, pred_leaf=True))


def test_categorical_models_load_across_packages(tmp_path):
    X, y = _cat_data(2)
    Xv, _ = _cat_data(3, n=1000)
    Xv[:5, 1] = [100.0, -3.0, 1.5, np.inf, 7.0]     # unseen / odd values
    bj = lgb.train(CAT_PARAMS, lgb.Dataset(X, label=y,
                                           categorical_feature=[0, 1]), 5,
                   verbose_eval=False)
    bt = lgt.train(CAT_PARAMS, lgt.Dataset(X, label=y,
                                           categorical_feature=[0, 1]), 5,
                   verbose_eval=False, device="cpu")
    pj, pt = tmp_path / "jax.txt", tmp_path / "torch.txt"
    bj.save_model(str(pj))
    bt.save_model(str(pt))
    # the JAX model in the port, on the host loop and the stacked ensemble
    tj = lgt.Booster(model_file=str(pj), device="cpu")
    assert tj.model_to_string() == lgb.Booster(model_file=str(pj)
                                               ).model_to_string()
    np.testing.assert_allclose(tj.predict(Xv), bj.predict(Xv), rtol=0,
                               atol=5e-6)
    host = tj._gbdt.predict_raw(Xv)
    tj._gbdt.config.pred_device = "device"
    np.testing.assert_allclose(tj._gbdt.predict_raw(Xv), host, rtol=0,
                               atol=1e-6)
    # the port's model in the JAX package
    jt = lgb.Booster(model_file=str(pt))
    np.testing.assert_allclose(jt.predict(Xv), bt.predict(Xv), rtol=0,
                               atol=5e-6)


def test_dataframe_names_and_categorical_names_match_jax():
    """A DataFrame's column names are the features' names, and a
    categorical feature given by column name trains as categorical: the
    JAX package's model text (``feature_names=``, ``decision_type``) and
    predictions within 5e-6."""
    import pandas as pd
    X, y = _cat_data(4)
    Xv, _ = _cat_data(5, n=1000)
    cols = ["lvl4", "code", "x2", "x3", "x4", "x5"]
    df, dfv = pd.DataFrame(X, columns=cols), pd.DataFrame(Xv, columns=cols)
    cats = ["lvl4", "code"]
    bj = lgb.train(CAT_PARAMS, lgb.Dataset(df, label=y,
                                           categorical_feature=cats), 5,
                   verbose_eval=False)
    dt = lgt.Dataset(df, label=y, categorical_feature=cats)
    bt = lgt.train(CAT_PARAMS, dt, 5, verbose_eval=False, device="cpu")
    assert dt._inner.device_data("cpu").is_categorical.tolist() == \
        [True, True, False, False, False, False]
    tj, tt = bj.model_to_string(), bt.model_to_string()
    assert "feature_names=" + " ".join(cols) in tt
    assert "cat_threshold=" in tt
    _assert_same_models(tj, tt)
    np.testing.assert_allclose(bt.predict(dfv), bj.predict(dfv), rtol=0,
                               atol=5e-6)
