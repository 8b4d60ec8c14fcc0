"""PyTorch port, data breadth against the JAX package on the CPU: the u16
bin matrix, forced bins, EFB bundling and scipy sparse input.

- ``max_bin=1023`` gives a byte-identical uint16 bin matrix, and
  ``forcedbins_filename`` the same bin bounds and bins.
- EFB finds the JAX package's bundles, offsets and widths, on dense data
  and on a CSR matrix (binned one densified row block at a time), and the
  bundled matrices are byte-identical; validation data adopt the training
  set's bundles; ``unbundled_bins`` decodes to the per-feature matrix.
- Binned prediction through the bundle columns (``predict_leaf_binned``
  with the EFB layout) routes rows as the JAX function does.
- A u16 run and an EFB run on sparse one-hot data grow the JAX package's
  trees (the same model text; predictions within 5e-6), and a CSR input
  predicts exactly as its dense twin.  The one-hot run keeps leaves of at
  least 100 rows: a split that peels one rare level off a large leaf gives
  the small child the parent's totals less the other side, so the JAX
  package's float32 summation residue in those totals (ROADMAP.md queue C;
  the port sums in float64) moves a 35-row leaf's value by ~2e-5, above
  the 1e-5 that the model-text comparison holds leaf values to.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops import grower as jgrow
from lightgbm_tpu.ops import predict as jpred
from lightgbm_tpu_torch import interop
from lightgbm_tpu_torch.ops import predict as tpred
from test_torch_objectives import _assert_same_models

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


def _dense(seed, n=3000, f=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[rng.random(n) < 0.05, 1] = np.nan
    y = (X[:, 0] + 0.7 * X[:, 1] ** 2 - 0.5 * X[:, 2] * X[:, 3]
         + 0.3 * rng.normal(size=n) > 0.4).astype(np.float32)
    return X, y


def _one_hot(seed, n=3000, groups=(24, 20, 12), dense=2):
    """Sparse one-hot blocks (mutually exclusive within a block, one level
    of each block rare), a few dense columns; CSR, 58 columns."""
    rng = np.random.default_rng(seed)
    cols, rows, vals, off = [], [], [], 0
    lvl = []
    for g in groups:
        p = np.ones(g)
        p[-1] = 0.05
        c = rng.choice(g, n, p=p / p.sum())
        lvl.append(c)
        rows.append(np.arange(n))
        cols.append(off + c)
        vals.append(np.ones(n))
        off += g
    Xd = rng.normal(size=(n, dense))
    for j in range(dense):
        rows.append(np.arange(n))
        cols.append(np.full(n, off + j))
        vals.append(Xd[:, j])
    X = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                              np.concatenate(cols))),
                      shape=(n, off + dense))
    eff = [np.sin(np.arange(g) * 1.7 + i) for i, g in enumerate(groups)]
    lat = sum(e[c] for e, c in zip(eff, lvl)) + 0.8 * Xd[:, 0]
    y = (lat + 0.3 * rng.normal(size=n) > 0.2).astype(np.float32)
    return X, y


def _inner_pair(X, y, params, **kw):
    dj = lgb.Dataset(X, label=y, params=dict(params), **kw).construct()
    dt = lgt.Dataset(X, label=y, params=dict(params), **kw).construct(
        device="cpu")
    return dj._inner, dt._inner


def test_u16_bins_match_jax():
    X, y = _dense(0)
    ij, it = _inner_pair(X, y, {"max_bin": 1023, "verbose": -1})
    assert it.bins.dtype == ij.bins.dtype == np.uint16
    assert int(it.bins.max()) > 255
    np.testing.assert_array_equal(it.bins, ij.bins)
    for mj, mt in zip(ij.bin_mappers, it.bin_mappers):
        assert mt.to_state() == mj.to_state()


def test_forced_bins_match_jax(tmp_path):
    X, y = _dense(1)
    path = tmp_path / "forced.json"
    path.write_text(json.dumps([
        {"feature": 0, "bin_upper_bound": [-1.0, 0.0, 0.5, 2.0]},
        {"feature": 3, "bin_upper_bound": [0.25]}]))
    params = {"forcedbins_filename": str(path), "max_bin": 31,
              "verbose": -1}
    ij, it = _inner_pair(X, y, params)
    for mj, mt in zip(ij.bin_mappers, it.bin_mappers):
        assert mt.to_state() == mj.to_state()
    np.testing.assert_array_equal(it.bins, ij.bins)
    ub = it.bin_mappers[0].bin_upper_bound
    assert all(any(abs(u - b) < 1e-12 for u in ub) for b in (-1.0, 0.5))


@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_bundles_match_jax(kind):
    X, y = _one_hot(2)
    Xv, yv = _one_hot(3, n=700)
    if kind == "dense":
        X, Xv = X.toarray(), Xv.toarray()
    ij, it = _inner_pair(X, y, {"verbose": -1})
    assert ij.bundles is not None and it.bundles == ij.bundles
    assert len(it.bundles) < it.num_features
    for name in ("feat_bundle", "feat_off", "bundle_widths"):
        np.testing.assert_array_equal(getattr(it, name), getattr(ij, name))
    assert it.bins.dtype == ij.bins.dtype
    np.testing.assert_array_equal(it.bins, ij.bins)
    np.testing.assert_array_equal(it.unbundled_bins(), ij.unbundled_bins())
    # validation data take the training set's bundles
    vj = lgb.Dataset(Xv, label=yv, reference=lgb.Dataset(
        X, label=y, params={"verbose": -1})).construct()._inner
    dtr = lgt.Dataset(X, label=y, params={"verbose": -1})
    vt = dtr.create_valid(Xv, yv).construct(device="cpu")._inner
    assert vt.bundles is it.bundles or vt.bundles == it.bundles
    np.testing.assert_array_equal(vt.bins, vj.bins)
    ddj, ddt = ij.device_data(), it.device_data("cpu")
    assert ddt.bundle_bins == ddj.bundle_bins > 0
    for a, b in zip(interop.efb_layout_from_numpy(ddj.efb), ddt.efb):
        np.testing.assert_array_equal(a, b)


def test_bundled_binned_prediction_matches_jax():
    """A tree grown on bundle columns routes the training rows through the
    bundles (decode, then threshold) as the JAX function does."""
    X, y = _one_hot(4)
    bt = lgt.train({"objective": "binary", "num_leaves": 15, "verbose": -1},
                   lgt.Dataset(X, label=y), 2, verbose_eval=False,
                   device="cpu")
    dd = bt._gbdt._dd
    assert dd.efb is not None
    for tree in bt._gbdt._device_trees:
        arrays = interop.tree_arrays_to_numpy(tree)
        jt = jgrow.TreeArrays(**{k: jnp.asarray(v) for k, v in
                                 arrays.items()})
        want = jax.device_get(jpred.predict_leaf_binned(
            jt, jnp.asarray(dd.bins.numpy()), jnp.asarray(
                dd.nan_bins.numpy()), efb=dd.efb))
        got = tpred.predict_leaf_binned(
            interop.tree_arrays_from_numpy(arrays, "cpu"), dd.bins,
            dd.nan_bins, efb=dd.efb)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["u16", "efb_sparse"])
def test_data_breadth_trains_like_jax(case):
    if case == "u16":
        X, y = _dense(5)
        Xv, _ = _dense(6, n=1000)
        params = {"max_bin": 1023}
    else:
        X, y = _one_hot(7)
        Xv = _one_hot(8, n=1000)[0]
        params = {"min_data_in_leaf": 100}
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
              **params}
    bj = lgb.train(params, lgb.Dataset(X, label=y), 5, verbose_eval=False)
    bt = lgt.train(params, lgt.Dataset(X, label=y), 5, verbose_eval=False,
                   device="cpu")
    if case == "efb_sparse":
        assert bt._gbdt._grower_cfg.bundle_bins > 0
    _assert_same_models(bj.model_to_string(), bt.model_to_string())
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), rtol=0,
                               atol=5e-6)
    if case == "efb_sparse":
        dense = Xv.toarray()
        np.testing.assert_array_equal(bt.predict(Xv), bt.predict(dense))
        np.testing.assert_array_equal(bt.predict(Xv.tocsc(), raw_score=True),
                                      bt.predict(dense, raw_score=True))
        np.testing.assert_array_equal(bt.predict(Xv, pred_leaf=True),
                                      bj.predict(dense, pred_leaf=True))


def test_kernel_width_gates_the_grower():
    """The grower decides on the kernel width (the widest bundle, else
    the widest feature): the atomic kernels take every u16 width (in bin
    tiles where one feature's histogram does not fit a CTA), and
    force_row_wise takes the same widths, u16 bins included (the one-hot
    kernels' u16 instantiations); a tree over u16 bins grows through the
    one-hot path."""
    from lightgbm_tpu_torch.ops import grower as tgrow
    from lightgbm_tpu_torch.ops import split as tsplit
    sp_ = tsplit.SplitParams(
        lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=20,
        min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0,
        max_delta_step=0.0, path_smooth=0.0, cat_smooth=10.0, cat_l2=10.0,
        max_cat_to_onehot=4)
    cfg = tgrow.GrowerConfig(num_leaves=7, max_depth=-1, max_bin=16,
                             split=sp_, bundle_bins=4096)
    assert tgrow.kernel_width(cfg) == 4096
    assert tgrow._frontier_eligible(cfg, 40)
    assert tgrow._frontier_eligible(cfg._replace(bundle_bins=20_000), 4)
    for ok in (cfg._replace(hist_method="onehot", bundle_bins=300),
               cfg._replace(hist_method="onehot"),
               cfg._replace(hist_method="onehot", bundle_bins=0,
                            max_bin=1024)):
        assert tgrow._frontier_eligible(ok, 4)
    assert tgrow._frontier_eligible(
        cfg._replace(hist_method="onehot", bundle_bins=20_000), 4)
    rng = np.random.default_rng(0)
    n = 512
    bins = torch.as_tensor(rng.integers(0, 1024, (n, 4)).astype(np.uint16))
    grad = torch.as_tensor(rng.normal(size=n).astype(np.float32))
    one = torch.ones(n)
    u16 = cfg._replace(hist_method="onehot", hist_variant="staged",
                       bundle_bins=0, max_bin=1024)
    tree, _, _ = tgrow.grow_tree(bins, grad, one, one, torch.ones(4),
                                 torch.full((4,), 1024, dtype=torch.int32),
                                 torch.full((4,), -1, dtype=torch.int32),
                                 u16)
    assert int(tree.num_leaves) == 7


_ROW_WISE_SCRIPT = r"""
import sys, numpy as np, jax
from unittest import mock
jax.config.update("jax_platforms", "cpu")
import lightgbm_tpu as lgb
d = np.load(sys.argv[1])
p = {"objective": "binary", "num_leaves": 15, "verbose": -1,
     "min_data_in_leaf": 100, "force_row_wise": True,
     "hist_variant": "staged"}
ds = lgb.Dataset(d["X"], label=d["y"], params=p)
# force_row_wise picks the Pallas kernels only on a TPU backend; they then
# run in interpret mode once the patch is gone
with mock.patch.object(jax, "default_backend", return_value="tpu"):
    bst = lgb.Booster(params=p, train_set=ds)
cfg = bst._gbdt._grower_cfg
assert (cfg.hist_method, cfg.hist_variant) == ("pallas", "staged"), cfg
for _ in range(int(d["iters"])):
    bst.update()
np.savez(sys.argv[2], model=np.array(bst.model_to_string()),
         pred=bst.predict(d["Xv"]), bundle_bins=cfg.bundle_bins)
"""


def test_row_wise_on_a_wide_bundle_trains_like_jax(monkeypatch, tmp_path):
    """force_row_wise on EFB bundles whose widest is above 256 bins (a
    300-level one-hot group: u16 bundle columns): with the port dispatching
    as on the card (the one-hot path, its plain versions here) and the JAX
    trainer seeing a TPU (its Pallas kernels in interpret mode), ``staged``
    grows the JAX package's trees."""
    from test_torch_onehot import _run_clean
    from lightgbm_tpu_torch.models import gbdt as tgbdt
    X, y = _one_hot(9, groups=(300, 20, 12))
    Xv = _one_hot(10, n=1000, groups=(300, 20, 12))[0]
    X, Xv = X.toarray(), Xv.toarray()
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, X=X, y=y, Xv=Xv, iters=4)
    _run_clean(_ROW_WISE_SCRIPT, [str(src), str(dst)])
    ref = dict(np.load(dst))
    monkeypatch.setattr(tgbdt, "kernel_backend", lambda device: "cuda")
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
              "min_data_in_leaf": 100, "force_row_wise": True,
              "hist_variant": "staged"}
    bt = lgt.train(params, lgt.Dataset(X, label=y), 4, verbose_eval=False,
                   device="cpu")
    cfg = bt._gbdt._grower_cfg
    assert (cfg.hist_method, cfg.hist_variant) == ("onehot", "staged")
    assert cfg.bundle_bins == int(ref["bundle_bins"]) > 256
    assert bt._gbdt._dd.bins.dtype == torch.uint16
    _assert_same_models(str(ref["model"]), bt.model_to_string())
    np.testing.assert_allclose(bt.predict(Xv), ref["pred"], rtol=0,
                               atol=5e-6)
