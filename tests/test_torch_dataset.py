"""PyTorch port, binning and Dataset: identical bins to the JAX package.

The same numpy inputs (made from a seed) go through both packages' dense
Dataset construction; the bin mappers must agree exactly (upper bounds,
missing handling) and the bin matrix must be byte-identical, for training
and validation data.  Out-of-core streaming, which the port has not taken
yet, must raise, never run another path.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import interop

pytestmark = pytest.mark.torch_port
# one intra-op thread each: the suite runs in several worker processes
torch.set_num_threads(1)


def _data(seed=0, n=3000, f=9):
    """Dense floats plus the awkward columns: NaNs, a zero-heavy column, a
    low-cardinality column and a constant (trivial) one."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[rng.random(n) < 0.1, 1] = np.nan
    X[rng.random(n) < 0.6, 2] = 0.0
    X[:, 3] = rng.integers(0, 5, n)
    X[:, 4] = 7.0
    X[:, 5] = np.round(X[:, 5], 1)
    y = (X[:, 0] + rng.normal(size=n) > 0).astype(np.float32)
    return X, y


def _both(X, y, params, Xv=None):
    dj = lgb.Dataset(X, label=y, params=params).construct()
    dt = lgt.Dataset(X, label=y, params=params).construct(device="cpu")
    out = [dj, dt]
    if Xv is not None:
        out.append(dj.create_valid(Xv).construct())
        out.append(dt.create_valid(Xv).construct(device="cpu"))
    return out


@pytest.mark.parametrize("params", [
    {"verbose": -1},
    {"verbose": -1, "max_bin": 63, "min_data_in_bin": 5},
    {"verbose": -1, "zero_as_missing": True},
], ids=["default", "max_bin63", "zero_as_missing"])
def test_bin_mappers_and_matrix_identical(params):
    X, y = _data()
    Xv, _ = _data(seed=9, n=700)
    dj, dt, vj, vt = _both(X, y, params, Xv)
    ij, it = dj._inner, dt._inner
    assert ij.used_features == it.used_features
    if not params.get("zero_as_missing"):
        assert 4 not in it.used_features                 # trivial feature
    for mj, mt in zip(ij.bin_mappers, it.bin_mappers):
        assert mj.to_state() == mt.to_state()
    assert ij.bins.dtype == np.uint8 and it.bins.dtype == np.uint8
    assert np.array_equal(ij.bins, it.bins)
    assert np.array_equal(vj._inner.bins, vt._inner.bins)
    ddj, ddt = ij.device_data(), it.device_data(torch.device("cpu"))
    # dense Higgs-like data forms no EFB bundle in the JAX package
    assert ddj.efb is None
    assert np.array_equal(np.asarray(ddj.bins), ddt.bins.numpy())
    for name in ("num_bins", "bin_offsets", "default_bins", "nan_bins"):
        assert np.array_equal(np.asarray(getattr(ddj, name)),
                              getattr(ddt, name).numpy()), name
    assert ddt.bins.device.type == "cpu"
    assert np.array_equal(ij.metadata.label, it.metadata.label)


def test_bin_mappers_from_state_round_trip():
    X, y = _data(seed=4)
    dj = lgb.Dataset(X, label=y, params={"verbose": -1}).construct()
    mappers = interop.bin_mappers_from_state(
        [m.to_state() for m in dj._inner.bin_mappers])
    for f, (mj, mt) in enumerate(zip(dj._inner.bin_mappers, mappers)):
        assert mt.to_state() == mj.to_state()
        np.testing.assert_array_equal(mt.value_to_bin(X[:, f]),
                                      mj.value_to_bin(X[:, f]))


def test_untaken_paths_raise(tmp_path):
    """Streaming, data files, pandas category columns, the binary cache
    and ``subset`` are ported and give the JAX package's Dataset (their
    parity tests: test_torch_stream.py, test_torch_loader.py,
    test_torch_pandas.py); a streamed dataset keeps its bin matrix in
    host RAM."""
    import pandas as pd
    X, y = _data(seed=1)
    ds = lgt.Dataset(X, label=y, params={"stream_rows": 1024}).construct(
        device="cpu")
    plan = ds._inner.stream_plan()
    assert plan.block_rows == 1024 and plan.reason == "stream_rows"
    assert not ds._inner._device
    path = tmp_path / "train.csv"
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.17g")
    dt = lgt.Dataset(str(path)).construct(device="cpu")
    dj = lgb.Dataset(str(path)).construct()
    np.testing.assert_array_equal(dt._inner.bins, dj._inner.bins)
    np.testing.assert_array_equal(dt.get_label(), y)
    df = pd.DataFrame({"a": X[:, 0], "c": pd.Categorical(
        np.where(X[:, 3] > 0, "x", "y"))})
    dt = lgt.Dataset(df, label=y).construct(device="cpu")
    assert dt.pandas_categorical == [["x", "y"]]
    assert dt._inner.bins.tobytes() == \
        lgb.Dataset(df, label=y).construct()._inner.bins.tobytes()
    cache = str(tmp_path / "train.bin")
    full = lgt.Dataset(X, label=y, device="cpu").save_binary(cache)
    from lightgbm_tpu_torch.io.dataset import Dataset as TInner
    loaded = TInner.load_binary(cache)
    assert loaded.bins.tobytes() == full._inner.bins.tobytes()
    sub = full.subset([0, 1, 2]).construct(device="cpu")
    np.testing.assert_array_equal(sub._inner.bins, full._inner.bins[:3])
    np.testing.assert_array_equal(sub.get_label(), y[:3])
    # mutually exclusive zero-heavy columns: both packages bundle them,
    # and neither does when bundling is off
    rng = np.random.default_rng(0)
    n = 4000
    sparse = np.zeros((n, 6))
    for j in range(6):
        rows = np.arange(j, n, 6)
        sparse[rows, j] = rng.uniform(1, 2, rows.size)
    ys = (rng.random(n) < 0.5).astype(np.float32)
    dj = lgb.Dataset(sparse, label=ys, params={"verbose": -1}).construct()
    assert dj._inner.device_data().efb is not None
    dt = lgt.Dataset(sparse, label=ys, params={"verbose": -1}).construct(
        device="cpu")
    assert dt._inner.bundles == dj._inner.bundles
    np.testing.assert_array_equal(dt._inner.bins, dj._inner.bins)
    dt = lgt.Dataset(sparse, label=ys,
                     params={"verbose": -1, "enable_bundle": False}
                     ).construct(device="cpu")
    assert dt._inner.bins.shape == (n, 6)


def test_construct_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU error; this machine has a card")
    X, y = _data(seed=2, n=500)
    with pytest.raises(lgt.NoCudaDeviceError):
        lgt.Dataset(X, label=y).construct()
