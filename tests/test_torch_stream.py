"""PyTorch port, out-of-core training (``lightgbm_tpu_torch/stream``) on
the CPU.

The properties ``tests/test_stream.py`` asserts for the JAX package, held
by the port: the plan's block math (the same plan as the JAX package's
``plan_streaming``) and the fake-cap seam (``STREAM_FAKE_DEVICE_BYTES``,
the port's name for ``STREAM_FAKE_HBM_BYTES``); EFB off under a configured
budget; the pipeline's order, padding, peak and skip list; file loads and
the binary cache reaching the same plan.  Streamed trees against the
port's in-memory sequential grower (``tree_grower=serial``): the same
structure (split features, thresholds, children, leaf counts) on tie-free
data and predictions within 1e-5 (block-wise float32 histogram sums
reassociate against one pass), at two block sizes, with bagging, GOSS,
categorical features and multiclass + L1; two shards in one process equal
to one; validation sets that stream, ``continue_from`` and
``rollback_one_iter``; the refusals.  Against the JAX package: one module
fixture trains the JAX ``StreamGBDT`` and the port's on the same data,
2,048-row blocks, 3 iterations: the same structure, predictions within
1e-5.  On the card, the copy-streamed block is held bit for bit against
the plain histogram by ``tests/test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.stream import host_matrix as jhm
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.stream import booster as sbooster
from lightgbm_tpu_torch.stream.grower import StreamTreeGrower, make_shards
from lightgbm_tpu_torch.stream.host_matrix import (HostBinMatrix,
                                                   plan_streaming)
from lightgbm_tpu_torch.stream.pipeline import (PipelineStats,
                                                RowBlockPipeline)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

PRED_ATOL = 1e-5
_STRUCT_KEYS = ("split_feature=", "threshold=", "left_child=",
                "right_child=", "leaf_count=")


def _structure(model_str):
    return [ln for ln in model_str.splitlines()
            if ln.startswith(_STRUCT_KEYS)]


def _reg_data(n=8000, f=10, seed=3, nan=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] * 2 + np.sin(X[:, 1] * 3) + X[:, 2] * X[:, 3]
         + 0.1 * rng.normal(size=n)).astype(np.float64)
    if nan:                      # a missing-value bin to route
        X[rng.random(n) < 0.05, 0] = np.nan
    return X, y


def _train(params, X, y, rounds=3, valid=None, **ds_kw):
    ds = lgt.Dataset(X, label=y, params=params, **ds_kw)
    kw = {}
    if valid is not None:
        kw = {"valid_sets": [lgt.Dataset(valid[0], label=valid[1],
                                         reference=ds)],
              "evals_result": {}, "verbose_eval": False}
    bst = lgt.train(params, ds, rounds, device="cpu", **kw)
    return bst, kw.get("evals_result")


def _parity(params, X, y, rounds=3, stream_rows=2048, valid=None, **ds_kw):
    """The in-memory sequential grower's booster and the streamed one."""
    base = dict(params, tree_grower="serial")
    ref, ref_ev = _train(base, X, y, rounds, valid, **ds_kw)
    st, st_ev = _train(dict(base, stream_rows=stream_rows), X, y, rounds,
                       valid, **ds_kw)
    assert isinstance(st._gbdt, sbooster.StreamGBDT)
    return ref, st, ref_ev, st_ev


def _assert_same(ref, st, X):
    assert _structure(ref.model_to_string()) == \
        _structure(st.model_to_string())
    np.testing.assert_allclose(st.predict(X), ref.predict(X), rtol=0,
                               atol=PRED_ATOL)


# ---------------------------------------------------------------------------
# the budget decision
@pytest.mark.parametrize("n,cols,item,params", [
    (10_000, 10, 1, {}),
    (100_000, 10, 1, {"max_bin_matrix_bytes": 200_000}),
    (100_000, 10, 2, {"max_bin_matrix_bytes": 300_000,
                      "stream_prefetch": 3}),
    (10_000, 10, 1, {"stream_rows": 1024}),
    (1_000, 10, 1, {"stream_rows": 4096}),
    (100_000, 28, 1, {"max_bin_matrix_bytes": 1_000}),
])
def test_plan_matches_jax(n, cols, item, params):
    """The port's plan is the JAX package's, field for field."""
    got = plan_streaming(n, cols, item, Config.from_params(params))
    want = jhm.plan_streaming(n, cols, item, lgb.Config.from_params(params))
    assert (got is None) == (want is None)
    if got is not None:
        assert tuple(got) == tuple(want)
        assert got.block_rows % 128 == 0


def test_plan_budget_and_fake_cap(monkeypatch):
    cfg = Config.from_params({"max_bin_matrix_bytes": 200_000})
    plan = plan_streaming(100_000, 10, 1, cfg)
    # 200,000 // (3 * (10 + 16)) = 2,564 -> 2,560 rows, 40 blocks
    assert plan.reason == "budget" and plan.block_rows == 2560
    assert plan.num_blocks == 40 and plan.total_bytes == 1_000_000
    assert plan_streaming(100_000, 10, 1, Config()) is None
    # the seam overrides the configured budget, and 0 disables it
    monkeypatch.setenv("STREAM_FAKE_DEVICE_BYTES", "100000")
    monkeypatch.setenv("STREAM_FAKE_HBM_BYTES", "100000")
    assert plan_streaming(100_000, 10, 1, Config()).budget_bytes == 100_000
    assert tuple(plan_streaming(100_000, 10, 1, Config())) == tuple(
        jhm.plan_streaming(100_000, 10, 1, lgb.Config()))
    monkeypatch.setenv("STREAM_FAKE_DEVICE_BYTES", "0")
    assert plan_streaming(100_000, 10, 1, cfg).budget_bytes == 200_000


def test_efb_off_under_budget_and_same_plan_from_files(tmp_path):
    rng = np.random.default_rng(0)
    X = np.zeros((4000, 6))
    for j in range(6):
        rows = np.arange(j * 600, j * 600 + 400)       # disjoint columns
        X[rows, j] = rng.integers(1, 5, size=400)
    y = (np.arange(4000) % 2).astype(np.float64)
    base = {"verbose": -1}
    d0 = lgt.Dataset(X, label=y, params=base).construct(device="cpu")
    assert d0._inner.bundles is not None               # EFB unbudgeted
    sp = dict(base, max_bin_matrix_bytes=10_000)
    d1 = lgt.Dataset(X, label=y, params=sp).construct(device="cpu")
    assert d1._inner.bundles is None                   # plain columns
    plan = d1._inner.stream_plan()
    assert plan is not None and not d1._inner._device  # bins stay on host
    # a data file and the binary cache reach the same plan
    path = tmp_path / "train.csv"
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.17g")
    df = lgt.Dataset(str(path), params=sp).construct(device="cpu")
    assert df._inner.stream_plan() == plan
    cache = str(tmp_path / "train.bin")
    d1.save_binary(cache)
    from lightgbm_tpu_torch.io.dataset import Dataset as Inner
    loaded = Inner.load_binary(cache, Config.from_params(sp))
    assert loaded.stream_plan() == plan


# ---------------------------------------------------------------------------
# the pipeline's mechanics
def test_pipeline_order_padding_and_peak():
    rng = np.random.default_rng(1)
    bins = rng.integers(0, 63, size=(10_000, 4), dtype=np.uint8)
    m = HostBinMatrix(bins, 1024)
    stats = PipelineStats()
    pipe = RowBlockPipeline(m, prefetch=2, stats=stats, device="cpu")
    g = np.arange(10_000, dtype=np.float32)
    leaf = np.arange(10_000, dtype=np.int32) % 7
    seen = []
    for _ in range(2):                   # two passes reuse the ring
        for blk in pipe.blocks({"g": g, "leafv": leaf}):
            seen.append(blk.index)
            assert blk.bins.shape == (1024, 4)     # uniform padded shape
            sl = slice(blk.start, blk.start + blk.rows)
            assert np.array_equal(blk.bins[:blk.rows].numpy(), bins[sl])
            assert not blk.bins[blk.rows:].any()
            assert np.array_equal(blk.extras["g"][:blk.rows].numpy(), g[sl])
            assert blk.extras["leafv"].dtype == torch.int32
            assert np.array_equal(blk.extras["leafv"][:blk.rows].numpy(),
                                  leaf[sl])
            assert not blk.extras["g"][blk.rows:].any()
    assert seen == list(range(m.num_blocks)) * 2
    assert m.num_blocks == 10 and m.block_rows_actual(9) == 10_000 - 9 * 1024
    # at most prefetch+1 blocks (bins and sidecar) live at once
    assert stats.peak_block_bytes == 3 * (m.block_nbytes + 8 * 1024)
    assert stats.puts == 20 and stats.passes == 2
    assert stats.bytes_h2d == 20 * (m.block_nbytes + 8 * 1024)


def test_pipeline_skip_list():
    m = HostBinMatrix(np.zeros((4096, 2), np.uint8), 1024)
    stats = PipelineStats()
    pipe = RowBlockPipeline(m, prefetch=1, stats=stats, device="cpu")
    assert [b.index for b in pipe.blocks(only=[0, 3])] == [0, 3]
    assert stats.blocks_skipped == 2 and stats.puts == 2
    with pytest.raises(lgt.NoCudaDeviceError):
        RowBlockPipeline(m)              # the default device is the card


# ---------------------------------------------------------------------------
# streamed trees against the in-memory sequential grower
@pytest.mark.parametrize("stream_rows", [2048, 4096])
def test_parity_block_sizes(stream_rows):
    """The same trees and valid metrics at two block sizes, the valid set
    itself streamed (it is over the fake budget too)."""
    X, y = _reg_data(nan=True)
    params = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
              "verbose": -1, "seed": 7, "metric": "l2"}
    ref, st, ref_ev, st_ev = _parity(params, X, y, stream_rows=stream_rows,
                                     valid=(X[:3000], y[:3000]))
    _assert_same(ref, st, X)
    np.testing.assert_allclose(st_ev["valid_0"]["l2"],
                               ref_ev["valid_0"]["l2"], rtol=1e-6)
    stats = st._gbdt.stream_stats
    assert stats.passes >= 3 * 15         # the root and every split
    assert stats.puts + stats.blocks_skipped == \
        stats.passes * st._gbdt._matrix.num_blocks


@pytest.mark.parametrize("case", ["bagging", "goss", "bynode_extra"])
def test_parity_row_and_node_sampling(case):
    X, y = _reg_data(6000, 8)
    yb = (y > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "verbose": -1, "seed": 7,
              **{"bagging": {"bagging_fraction": 0.6, "bagging_freq": 2},
                 "goss": {"boosting": "goss"},
                 "bynode_extra": {"feature_fraction": 0.8,
                                  "feature_fraction_bynode": 0.6,
                                  "extra_trees": True}}[case]}
    ref, st, _, _ = _parity(params, X, yb)
    if case == "goss":
        assert isinstance(st._gbdt, sbooster.StreamGOSS)
    _assert_same(ref, st, X)


def test_parity_categorical():
    X, y = _reg_data(6000, 8)
    rng = np.random.default_rng(11)
    Xc = X.copy()
    Xc[:, 2] = rng.integers(0, 12, size=len(X))
    Xc[:, 5] = rng.integers(0, 30, size=len(X))
    yc = (y + (Xc[:, 2] % 3) - 0.1 * (Xc[:, 5] % 7)).astype(np.float64)
    params = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
              "verbose": -1, "seed": 7}
    ref, st, _, _ = _parity(params, Xc, yc, categorical_feature=[2, 5])

    # the same MODEL (splits, predictions): the pop order may differ where
    # two leaves' best gains tie to the last float bit (the block sums
    # reassociate), renumbering leaves without changing the partition, so
    # each tree's splits compare as a sorted multiset (as the JAX
    # package's test_stream.py compares them)
    def split_multisets(bst):
        return [sorted(zip(t.split_feature.tolist(),
                           [round(float(v), 6) for v in t.threshold]))
                for t in bst._gbdt.models]
    assert split_multisets(ref) == split_multisets(st)
    np.testing.assert_allclose(st.predict(Xc), ref.predict(Xc), rtol=0,
                               atol=PRED_ATOL)


def test_parity_multiclass_and_renew():
    X, y = _reg_data(5000, 6)
    params = {"objective": "regression_l1", "num_leaves": 7, "max_bin": 63,
              "verbose": -1, "seed": 7}
    ref, st, _, _ = _parity(params, X, y)
    _assert_same(ref, st, X)
    ym = np.digitize(y, [-1.0, 1.0]).astype(np.float64)
    params = {"objective": "multiclass", "num_class": 3, "num_leaves": 7,
              "max_bin": 63, "verbose": -1, "seed": 7}
    ref, st, _, _ = _parity(params, X, ym)
    _assert_same(ref, st, X)


def test_two_shards_equal_one():
    """Two host shards in one process (no cross_reduce: their partials
    sum) grow the one-shard tree."""
    X, y = _reg_data(6000, 6)
    params = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
              "verbose": -1, "stream_rows": 1024}
    bst, _ = _train(params, X, y, rounds=1)
    eng = bst._gbdt
    bins = eng.train_data.bins
    g = (np.asarray(y, np.float32) - np.float32(y.mean())) * -1
    h = np.ones_like(g)
    rw = np.ones_like(g)
    fmask = np.ones(bins.shape[1], np.float32)
    meta = {k: getattr(eng._dd, k).numpy() for k in
            ("num_bins", "default_bins", "nan_bins", "is_categorical",
             "monotone")}

    def grow(parts):
        mats = [HostBinMatrix(bins[a:b], 1024) for a, b in parts]
        gr = StreamTreeGrower(make_shards(mats, 2, device="cpu"), meta,
                              eng._grower_cfg, device="cpu")
        return gr.grow(g, h, rw, fmask)
    one, a1 = grow([(0, 6000)])
    two, a2 = grow([(0, 3500), (3500, 6000)])
    for name in ("split_feature", "threshold", "left_child", "right_child",
                 "leaf_count"):
        np.testing.assert_array_equal(getattr(two, name),
                                      getattr(one, name), err_msg=name)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_allclose(two.leaf_value, one.leaf_value, rtol=1e-5,
                               atol=1e-6)


def test_continue_and_rollback():
    """``init_model`` warms the host scores (the continued run grows the
    one run's trees), and ``rollback_one_iter`` restores them."""
    X, y = _reg_data(5000, 6)
    params = {"objective": "regression", "num_leaves": 7, "max_bin": 63,
              "verbose": -1, "stream_rows": 1024}
    full, _ = _train(params, X, y, rounds=4)
    ds = lgt.Dataset(X, label=y, params=params)
    first = lgt.train(params, ds, 2, device="cpu")
    cont = lgt.train(params, lgt.Dataset(X, label=y, params=params), 2,
                     init_model=first, device="cpu")
    assert isinstance(cont._gbdt, sbooster.StreamGBDT)
    assert _structure(cont.model_to_string()) == \
        _structure(full.model_to_string())
    np.testing.assert_allclose(cont.predict(X), full.predict(X), rtol=0,
                               atol=PRED_ATOL)
    before = first._gbdt._train_score.clone()
    first.update()
    assert first.num_trees() == 3
    first.rollback_one_iter()
    assert first.num_trees() == 2
    assert torch.equal(first._gbdt._train_score, before)


def test_refusals():
    X, y = _reg_data(3000, 4)
    for extra, err in (({"linear_tree": True}, lgt.LightGBMError),
                       ({"boosting": "dart"}, lgt.LightGBMError),
                       ({"monotone_constraints": [1, 0, 0, 0],
                         "monotone_constraints_method": "intermediate"},
                        lgt.LightGBMError),
                       ({"tree_learner": "data"}, lgt.NotPortedError)):
        params = {"objective": "regression", "verbose": -1,
                  "stream_rows": 1024, **extra}
        with pytest.raises(err):
            lgt.train(params, lgt.Dataset(X, label=y, params=params), 1,
                      device="cpu")
    q = np.full(30, 100)
    params = {"objective": "lambdarank", "verbose": -1, "stream_rows": 1024}
    with pytest.raises(lgt.LightGBMError, match="ranking"):
        lgt.train(params, lgt.Dataset(X, label=(y > 0).astype(float),
                                      group=q, params=params), 1,
                  device="cpu")
    with pytest.raises(lgt.NoCudaDeviceError):
        lgt.train({"stream_rows": 1024, "verbose": -1},
                  lgt.Dataset(X, label=y), 1)


# ---------------------------------------------------------------------------
# against the JAX package's streaming engine
@pytest.fixture(scope="module")
def jax_and_port_stream():
    X, y = _reg_data(6000, 8, seed=5)
    params = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
              "verbose": -1, "seed": 7, "stream_rows": 2048}
    bj = lgb.train(params, lgb.Dataset(X, label=y, params=params), 3)
    bt, _ = _train(params, X, y, rounds=3)
    return X, bj, bt


def test_stream_matches_jax_stream(jax_and_port_stream):
    from lightgbm_tpu.stream.booster import StreamGBDT as JaxStreamGBDT
    X, bj, bt = jax_and_port_stream
    assert isinstance(bj._gbdt, JaxStreamGBDT)
    assert isinstance(bt._gbdt, sbooster.StreamGBDT)
    assert _structure(bt.model_to_string()) == \
        _structure(bj.model_to_string())
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=0,
                               atol=PRED_ATOL)
