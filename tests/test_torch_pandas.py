"""PyTorch port, pandas frames with category columns, against the JAX
package: ``tests/test_pandas.py``'s CPU cases that need no ``sklearn.py``.

Category columns train as their codes against the training frame's
category lists, which the model text carries on its ``pandas_categorical``
line; validation and prediction frames are coded against those lists
(another level order, or an unseen level as missing).  A frame makes the
JAX package's binned Dataset, and a model saved by either package predicts
a frame in the other as in its own.
"""
import numpy as np
import pytest
import torch

pd = pytest.importorskip("pandas")

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lgt  # noqa: E402
from lightgbm_tpu_torch.models.model_io import parse_pandas_categorical  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

PARAMS = {"objective": "binary", "num_leaves": 15, "verbose": -1,
          "min_data_in_leaf": 5}
NAMES = ["num0", "color", "num1", "size"]


def _frame(n=800, seed=0):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "num0": rng.normal(size=n),
        "color": pd.Categorical(rng.choice(["red", "green", "blue"], n)),
        "num1": rng.normal(size=n),
        "size": pd.Categorical(rng.choice(["s", "m", "l", "xl"], n)),
    })
    logit = (df["num0"].to_numpy()
             + (df["color"] == "green") * 1.5
             + (df["size"].isin(["l", "xl"])) * 1.0
             + 0.5 * df["num1"].to_numpy())
    y = (logit + rng.logistic(size=n) > 1.0).astype(np.float64)
    return df, y


def _codes_matrix(df):
    out = np.empty(df.shape, np.float64)
    for j, c in enumerate(df.columns):
        col = df[c]
        if isinstance(col.dtype, pd.CategoricalDtype):
            codes = col.cat.codes.to_numpy().astype(np.float64)
            codes[codes < 0] = np.nan
            out[:, j] = codes
        else:
            out[:, j] = col.to_numpy()
    return out


def _train(df, y, rounds=10):
    return lgt.train(PARAMS, lgt.Dataset(df, label=y), rounds,
                     verbose_eval=False, device="cpu")


@pytest.fixture(scope="module")
def jax_model():
    df, y = _frame()
    return lgb.train(PARAMS, lgb.Dataset(df, label=y), 10, verbose_eval=False)


def test_frame_bins_like_jax_and_trains_the_codes_model(jax_model):
    """The frame's Dataset is the JAX package's (names, category lists,
    categorical features, mappers, bins, byte for byte), and the port's
    model from the frame is its model from the codes.  Tree-for-tree parity
    of categorical training is ``test_torch_categorical.py``'s: a 4-level
    column takes the sorted scan, whose half-split tie (ROADMAP.md, queue C)
    residues decide."""
    df, y = _frame()
    dj = lgb.Dataset(df, label=y).construct()
    dt = lgt.Dataset(df, label=y).construct("cpu")
    assert dt.get_feature_name() == dj.get_feature_name() == NAMES
    assert dt.pandas_categorical == dj.pandas_categorical == \
        jax_model.pandas_categorical == [["blue", "green", "red"],
                                         ["l", "m", "s", "xl"]]
    assert dt.categorical_feature == dj.categorical_feature == [1, 3]
    assert [m.to_state() for m in dt._inner.bin_mappers] == \
        [m.to_state() for m in dj._inner.bin_mappers]
    assert dt._inner.bins.tobytes() == dj._inner.bins.tobytes()
    bt = _train(df, y)
    assert bt.feature_name() == NAMES
    assert bt.pandas_categorical == dt.pandas_categorical
    manual = lgt.train(PARAMS, lgt.Dataset(
        _codes_matrix(df), label=y, categorical_feature=[1, 3],
        feature_name=NAMES), 10, verbose_eval=False, device="cpu")
    text = bt.model_to_string()
    assert text.split("\npandas_categorical:")[0] == \
        manual.model_to_string().split("\npandas_categorical:")[0]
    np.testing.assert_array_equal(bt.predict(df),
                                  manual.predict(_codes_matrix(df)))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_pandas_categorical_models_load_across_packages(jax_model, tmp_path,
                                                        writer):
    df, y = _frame()
    src = jax_model if writer == "jax" else _train(df, y)
    path = tmp_path / "model.txt"
    src.save_model(str(path))
    assert "\npandas_categorical:" in path.read_text()
    loaded_t = lgt.Booster(model_file=str(path), device="cpu")
    loaded_j = lgb.Booster(model_file=str(path))
    assert loaded_t.pandas_categorical == loaded_j.pandas_categorical \
        == src.pandas_categorical
    base = src.predict(df, raw_score=True)
    np.testing.assert_array_equal(loaded_t.predict(df, raw_score=True), base)
    np.testing.assert_array_equal(loaded_j.predict(df, raw_score=True), base)
    assert loaded_t.model_to_string() == loaded_j.model_to_string()
    # another level order is re-coded against the stored lists
    df2 = df.copy()
    df2["color"] = df2["color"].cat.reorder_categories(
        ["blue", "red", "green"])
    np.testing.assert_array_equal(loaded_t.predict(df2, raw_score=True), base)


def test_unseen_category_is_missing():
    df, y = _frame()
    bt = _train(df, y)
    df2 = df.head(50).copy()
    df2["color"] = pd.Categorical(["purple"] * 50,
                                  categories=["purple", "red"])
    codes = _codes_matrix(df.head(50))
    codes[:, 1] = np.nan
    np.testing.assert_array_equal(bt.predict(df2), bt.predict(codes))


def test_valid_sets_use_the_training_categories():
    """A validation frame with its own level order, constructed before the
    training set or after it, is coded against the training lists."""
    df, y = _frame()
    dfv = df.tail(200).copy()
    dfv["color"] = dfv["color"].cat.reorder_categories(
        ["blue", "red", "green"])
    evals = []
    for frame, early in ((dfv, True), (df.tail(200), False)):
        train = lgt.Dataset(df.head(600), label=y[:600], params=PARAMS)
        valid = train.create_valid(frame, label=y[600:])
        if early:
            valid.construct("cpu")
        bt = lgt.train(dict(PARAMS, metric="auc"), train, 5,
                       valid_sets=[valid], verbose_eval=False, device="cpu")
        evals.append(bt.eval_valid()[0][2])
    assert evals[0] == evals[1] > 0.5


def test_frames_that_cannot_be_coded_raise():
    df, y = _frame()
    bad = df.copy()
    bad["bad"] = ["a"] * len(df)
    with pytest.raises(ValueError, match="non-numeric"):
        lgt.Dataset(bad, label=y).construct("cpu")
    bt = lgt.train(PARAMS, lgt.Dataset(_codes_matrix(df), label=y,
                                       categorical_feature=[1, 3]), 3,
                   verbose_eval=False, device="cpu")
    with pytest.raises(lgt.LightGBMError, match="pandas_categorical"):
        bt.predict(df)


def test_all_numeric_frame_and_lookalikes():
    rng = np.random.default_rng(1)
    num = pd.DataFrame(rng.normal(size=(300, 4)), columns=list("abcd"))
    yn = (num["a"] > 0).astype(float)
    bt = _train(num, yn, rounds=5)
    assert bt.pandas_categorical is None and bt.feature_name() == list("abcd")
    np.testing.assert_array_equal(bt.predict(num), bt.predict(num.to_numpy()))
    df, y = _frame()
    arr = _codes_matrix(df)

    class FakeFrame:
        """A duck-typed frame that is not pandas: it takes ``.values``."""
        dtypes = df.dtypes
        columns = list(df.columns)
        values = arr
        shape = arr.shape

    ba = lgt.train(PARAMS, lgt.Dataset(arr, label=y), 3, verbose_eval=False,
                   device="cpu")
    np.testing.assert_array_equal(ba.predict(FakeFrame()), ba.predict(arr))


def test_dump_model_and_payload_parsing(jax_model):
    df, y = _frame()
    bt = _train(df, y, rounds=3)
    dump = bt.dump_model()
    assert dump["pandas_categorical"] == bt.pandas_categorical
    assert dump["pandas_categorical"][0] == ["blue", "green", "red"]
    assert parse_pandas_categorical("tree\n...\npandas_categorical:") is None
    assert parse_pandas_categorical("x\npandas_categorical:\n") is None
    assert parse_pandas_categorical(
        "x\npandas_categorical:[[\"a\"]]\n") == [["a"]]
