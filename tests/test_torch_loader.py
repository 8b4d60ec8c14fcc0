"""PyTorch port, file input: the native parser and binner, the loader's
role columns and sidecar files, training from a file, the binary cache and
``Dataset.subset``, against the JAX package.

The port builds its own copy of ``parser.cpp``; on the cases of
``tests/test_native.py`` (CSV, TSV with a header, scientific notation,
LibSVM, blank lines, section boundaries) it must give the JAX package's
bytes, and its numpy fallback the same values.  Files, sidecars and caches
written once are read by both packages; models trained from them must have
the same model text (leaf values to 1e-5, as ``test_torch_train.py``
holds).
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu import native as jnative
from lightgbm_tpu.io.bin import BinMapper as JBinMapper, BinType as JBinType
from lightgbm_tpu_torch import native as tnative
from lightgbm_tpu_torch.io import loader as tloader
from lightgbm_tpu_torch.io.bin import BinMapper as TBinMapper, \
    BinType as TBinType
from lightgbm_tpu_torch.io.dataset import Dataset as TInner

from test_torch_train import _assert_same_model_text

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

PARAMS = {"objective": "binary", "num_leaves": 15, "verbose": -1}
# one shape and iteration count for every JAX run here: its compiled
# programs are reused across the tests
N, ITERS = 2000, 5


@pytest.fixture(scope="module", autouse=True)
def libs():
    if tnative.get_lib() is None or jnative.get_lib() is None:
        pytest.fail("the native parser did not build (g++ is needed)")


def _write_cases(tmp_path):
    """The parser cases of tests/test_native.py: path -> (delimiter or
    'libsvm', header rows)."""
    rng = np.random.default_rng(0)
    data = rng.normal(size=(500, 7))
    data[rng.random((500, 7)) < 0.05] = np.nan
    np.savetxt(tmp_path / "data.csv", data, delimiter=",", fmt="%.10g")
    with open(tmp_path / "header.tsv", "w") as f:
        f.write("a\tb\tc\td\n")
        np.savetxt(f, rng.normal(size=(100, 4)) * 1e3, delimiter="\t",
                   fmt="%.10g")
    (tmp_path / "sci.csv").write_text("1e-3,2.5E4,-3.25e+2\n-0.5,nan,1250\n")
    (tmp_path / "blank.csv").write_text("1,2\n\n3,4\n\n\n5,6\n")
    (tmp_path / "data.svm").write_text(
        "1 0:1.5 3:2.25\n0 1:-4.5\n1 0:0.125 2:8 3:-1\n")
    return {"data.csv": (",", 0), "header.tsv": ("\t", 1),
            "sci.csv": (",", 0), "blank.csv": (",", 0),
            "data.svm": ("libsvm", 0)}


@pytest.mark.parametrize("section", [0, 4, 37, 4096])
def test_native_parser_matches_jax_byte_for_byte(tmp_path, section):
    """Every case, at the default section size and at sections that cut
    lines everywhere (the pipelined reader's boundaries)."""
    libs = (tnative.get_lib(), jnative.get_lib())
    for name, (delim, skip) in _write_cases(tmp_path).items():
        path = str(tmp_path / name)
        for lib in libs:
            lib.SetParserSectionBytes(section)
        try:
            if delim == "libsvm":
                got, want = tnative.parse_libsvm(path), jnative.parse_libsvm(path)
                pairs = list(zip(got, want))
            else:
                pairs = [(tnative.parse_delimited(path, delim, skip),
                          jnative.parse_delimited(path, delim, skip))]
        finally:
            for lib in libs:
                lib.SetParserSectionBytes(0)
        for got, want in pairs:
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert got.tobytes() == want.tobytes(), name


def _mappers(pkg_mapper, pkg_bintype, data):
    return [pkg_mapper.find_bin(
        data[:500, f], 500, max_bin=63, min_data_in_bin=3, min_split_data=1,
        pre_filter=False,
        bin_type=pkg_bintype.CATEGORICAL if f == 3 else pkg_bintype.NUMERICAL)
        for f in range(data.shape[1])]


def test_native_binner_matches_jax_and_numpy():
    rng = np.random.default_rng(2)
    n, F = 2000, 5
    data = rng.normal(size=(n, F)) * np.array([1, 10, 0.1, 100, 1])
    data[rng.random(n) < 0.1, 2] = np.nan
    data[:, 3] = rng.integers(0, 12, n)
    tm = _mappers(TBinMapper, TBinType, data)
    jm = _mappers(JBinMapper, JBinType, data)
    used = [f for f in range(F) if not tm[f].is_trivial]
    got = tnative.bin_values(data, tm, used)
    want = jnative.bin_values(data, jm, used)
    assert got.tobytes() == want.tobytes()
    for i, f in enumerate(used):
        np.testing.assert_array_equal(got[:, i],
                                      tm[f].value_to_bin(data[:, f]))


def test_numpy_fallback_matches_native(tmp_path, monkeypatch, capsys):
    """Without the library the loader and binner take numpy, give the same
    values, and say so once."""
    cases = _write_cases(tmp_path)
    native = {n: tloader.load_file(str(tmp_path / n), lgt.Config.from_params(
        {"header": skip == 1})) for n, (_, skip) in cases.items()}
    X = np.random.default_rng(3).normal(size=(800, 6))
    X[::7, 1] = np.nan
    y = (X[:, 0] > 0).astype(np.float32)
    bins_native = lgt.Dataset(X, label=y).construct("cpu")._inner.bins
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_failed", True)
    monkeypatch.setattr(tnative, "_warned", False)
    calls = dict(tnative.native_calls)
    capsys.readouterr()
    for n, (_, skip) in cases.items():
        fb = tloader.load_file(str(tmp_path / n), lgt.Config.from_params(
            {"header": skip == 1}))
        np.testing.assert_allclose(fb[0], native[n][0], rtol=1e-14,
                                   atol=0, equal_nan=True, err_msg=n)
        np.testing.assert_array_equal(fb[1], native[n][1], err_msg=n)
    bins_numpy = lgt.Dataset(X, label=y).construct("cpu")._inner.bins
    assert tnative.native_calls == calls
    assert bins_numpy.tobytes() == bins_native.tobytes()
    assert capsys.readouterr().out.count("native parser unavailable") == 1


def _roles_file(tmp_path):
    rng = np.random.default_rng(0)
    n = 400
    X = rng.normal(size=(n, 4))
    y = (X[:, 0] + 0.5 * rng.normal(size=n) > 0).astype(np.float64)
    w = rng.uniform(0.5, 2.0, n).round(3)
    qid = np.repeat(np.arange(n // 20), 20)
    mat = np.column_stack([y, X, w, qid, np.full(n, 7.0)])
    path = tmp_path / "roles.csv"
    np.savetxt(path, mat, delimiter=",", fmt="%.6g",
               header="target,f0,f1,f2,f3,w,qid,junk", comments="")
    np.savetxt(tmp_path / "roles2.csv", mat, delimiter=",", fmt="%.6g")
    return path, w


@pytest.mark.parametrize("by", ["name", "index"])
def test_role_columns_match_jax(tmp_path, by):
    path, w = _roles_file(tmp_path)
    if by == "name":
        params = {"header": True, "label_column": "name:target",
                  "weight_column": "name:w", "group_column": "name:qid",
                  "ignore_column": "name:junk", "verbose": -1}
    else:
        path = tmp_path / "roles2.csv"
        params = {"label_column": "0", "weight_column": "4",
                  "group_column": "5", "ignore_column": "6", "verbose": -1}
    dj = lgb.Dataset(str(path), params=params).construct()
    dt = lgt.Dataset(str(path), params=params).construct("cpu")
    assert dt.num_feature() == dj.num_feature() == 4
    assert dt.get_feature_name() == dj.get_feature_name()
    for getter in ("get_label", "get_weight", "get_group"):
        np.testing.assert_array_equal(getattr(dt, getter)(),
                                      getattr(dj, getter)(), err_msg=getter)
    np.testing.assert_allclose(dt.get_weight(), w, rtol=1e-5)
    np.testing.assert_array_equal(dt._inner.bins, dj._inner.bins)


def _examples_tsv(tmp_path, n=N, seed=7):
    """examples/generate_data.py's layout: TSV, label in column 0."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 8)).astype(np.float32)
    y = (1.3 * X[:, 0] - 0.9 * X[:, 1] + X[:, 2] * X[:, 3]
         + rng.logistic(size=n) > 0).astype(np.float32)
    path = tmp_path / "binary.train"
    np.savetxt(path, np.column_stack([y, X]), delimiter="\t", fmt="%.9g")
    return path, X, y, rng


def test_sidecar_files_match_jax(tmp_path):
    path, X, y, rng = _examples_tsv(tmp_path, n=1200)
    w = rng.uniform(0.5, 1.5, len(y)).astype(np.float32)
    init = rng.normal(scale=0.1, size=len(y))
    np.savetxt(str(path) + ".weight", w, fmt="%.9g")
    np.savetxt(str(path) + ".query", np.full(60, 20), fmt="%d")
    np.savetxt(str(path) + ".init", init, fmt="%.17g")
    dj = lgb.Dataset(str(path)).construct()
    dt = lgt.Dataset(str(path)).construct("cpu")
    for getter in ("get_label", "get_weight", "get_group", "get_init_score"):
        np.testing.assert_array_equal(getattr(dt, getter)(),
                                      getattr(dj, getter)(), err_msg=getter)
    np.testing.assert_array_equal(dt.get_weight(), w)
    np.testing.assert_array_equal(dt.get_label(), y)
    # the file's float32 values parse back exactly: the same bins as the
    # arrays themselves
    np.testing.assert_array_equal(
        dt._inner.bins, lgt.Dataset(X, label=y).construct("cpu")._inner.bins)


def test_model_from_file_matches_jax(tmp_path):
    """The binary example's knobs (bagging, feature_fraction) and a
    ``.weight`` sidecar."""
    path, X, _, rng = _examples_tsv(tmp_path)
    np.savetxt(str(path) + ".weight", rng.uniform(0.5, 1.5, len(X)),
               fmt="%.4f")
    params = dict(PARAMS, feature_fraction=0.8, bagging_freq=2,
                  bagging_fraction=0.8)
    bj = lgb.train(params, lgb.Dataset(str(path)), ITERS, verbose_eval=False)
    bt = lgt.train(params, lgt.Dataset(str(path)), ITERS, verbose_eval=False,
                   device="cpu")
    _assert_same_model_text(bj.model_to_string(), bt.model_to_string())
    # predicting from the file: the same as from its matrix
    np.testing.assert_array_equal(bt.predict(str(path)), bt.predict(X))


def test_predict_from_libsvm_pads_missing_trailing_features(tmp_path):
    """A LibSVM file's width is its greatest index seen: the prediction
    pads the absent trailing features with zeros, in both packages."""
    rng = np.random.default_rng(4)
    X = rng.normal(size=(600, 5))
    X[:, 4] = 0.0
    X[::3, 4] = 1.0
    y = (X[:, 0] + X[:, 4] > 0.5).astype(np.float32)
    bt = lgt.train(PARAMS, lgt.Dataset(X, label=y), 3, verbose_eval=False,
                   device="cpu")
    bj = lgb.Booster(model_str=bt.model_to_string())
    Xp = X[:4].copy()
    Xp[:, 4] = 0.0
    path = tmp_path / "pred.svm"
    path.write_text("".join(
        "0 " + " ".join(f"{j}:{float(v)!r}" for j, v in enumerate(r[:4])) + "\n"
        for r in Xp))
    np.testing.assert_array_equal(bt.predict(str(path), raw_score=True),
                                  bt.predict(Xp, raw_score=True))
    np.testing.assert_array_equal(bt.predict(str(path), raw_score=True),
                                  bj.predict(str(path), raw_score=True))


def test_binary_cache_round_trips_across_packages(tmp_path):
    """Each package writes a cache of the same data; each reads the other's
    byte for byte, and the caches train the trees of the arrays."""
    path, X, y, rng = _examples_tsv(tmp_path)
    Xn = X.astype(np.float64)
    Xn[rng.random(len(y)) < 0.05, 2] = np.nan
    w = rng.uniform(0.5, 2.0, len(y))
    pj, pt = str(tmp_path / "jax.bin.npz"), str(tmp_path / "torch.bin.npz")
    lgb.Dataset(Xn, label=y, weight=w, params=PARAMS).save_binary(pj)
    lgt.Dataset(Xn, label=y, weight=w, params=PARAMS,
                device="cpu").save_binary(pt)
    from lightgbm_tpu.io.dataset import Dataset as JInner
    caches = {}
    for writer, path in (("jax", pj), ("torch", pt)):
        ij, it = JInner.load_binary(path), TInner.load_binary(path)
        caches[writer] = (ij, it)
        assert it.bins.tobytes() == ij.bins.tobytes(), writer
        assert [m.to_state() for m in it.bin_mappers] == \
            [m.to_state() for m in ij.bin_mappers], writer
        for field in ("label", "weight"):
            np.testing.assert_array_equal(getattr(it.metadata, field),
                                          getattr(ij.metadata, field))
    assert caches["jax"][1].bins.tobytes() == caches["torch"][0].bins.tobytes()
    # the port trains from the JAX package's cache, the JAX package from
    # the port's: the same trees, and the port's those of the arrays
    dj = lgb.Dataset(None, params=PARAMS)
    dt = lgt.Dataset(None, params=PARAMS)
    dj._inner, dt._inner = caches["torch"][0], caches["jax"][1]
    bj = lgb.train(PARAMS, dj, ITERS, verbose_eval=False)
    bt = lgt.train(PARAMS, dt, ITERS, verbose_eval=False, device="cpu")
    _assert_same_model_text(bj.model_to_string(), bt.model_to_string())
    ba = lgt.train(PARAMS, lgt.Dataset(Xn, label=y, weight=w), ITERS,
                   verbose_eval=False, device="cpu")
    assert ba.model_to_string() == bt.model_to_string()


def test_subset_trains_like_jax(tmp_path):
    """``test_engine.py::test_dataset_subset_training`` on both packages."""
    _, X, y, _ = _examples_tsv(tmp_path, n=2 * N)
    idx = np.arange(0, len(y), 2)
    fj = lgb.Dataset(X, label=y)
    fj.construct()
    ft = lgt.Dataset(X, label=y).construct("cpu")
    sj, st = fj.subset(idx), ft.subset(idx)
    bj = lgb.train(PARAMS, sj, ITERS, verbose_eval=False)
    bt = lgt.train(PARAMS, st, ITERS, verbose_eval=False, device="cpu")
    assert bt.num_trees() == ITERS and st.num_data() == len(idx)
    np.testing.assert_array_equal(st.get_label(), y[idx])
    # the subset's bins are the full set's rows, under its mappers
    assert st._inner.bin_mappers is ft._inner.bin_mappers
    np.testing.assert_array_equal(st._inner.bins, ft._inner.bins[idx])
    _assert_same_model_text(bj.model_to_string(), bt.model_to_string())
    assert bt.predict(X[idx]).shape == (len(idx),)
