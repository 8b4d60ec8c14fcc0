"""PyTorch port, the train/cv/Booster surface against the JAX package.

The same seeded data goes through both packages' ``train`` with a custom
objective and metric, ``init_model`` (a file and a ``Booster``),
``learning_rates`` and the ``reset_parameter`` callback (a ``num_leaves``
change included), ``keep_training_booster`` and ``snapshot_freq``
(``cv`` is in ``test_torch_cv.py``, the ``Booster`` and ``Dataset``
methods in ``test_torch_booster.py``).  Model texts are held as
``test_torch_train.py`` holds them (leaf values to 1e-5).  The JAX package
compiles its grower for each booster (~4.5 s on the CPU), so each test
trains as few JAX boosters as it can.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

from test_torch_train import _assert_same_model_text, _data as _train_data

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

PARAMS = {"objective": "binary", "num_leaves": 15, "verbose": -1}
N, NV, ITERS = 4000, 1000, 5


def _data(seed=0):
    """``test_torch_train.py``'s data: no near-tie gain that the two
    packages' summation orders could break differently."""
    return _train_data(seed, n=N, nv=NV)


def _pair(params, rounds, seed=0, **kw):
    """The same ``train`` call in both packages, with a valid set: (jax
    booster, port booster, data); each booster's ``evals`` is its
    ``evals_result``."""
    X, y, Xv, yv = _data(seed)
    out = []
    for pkg, extra in ((lgb, {}), (lgt, {"device": "cpu"})):
        ds = pkg.Dataset(X, label=y)
        vs = ds.create_valid(Xv, label=yv)
        evals = {}
        b = pkg.train(dict(params), ds, rounds, valid_sets=[vs],
                      verbose_eval=False, **dict(kw, evals_result=evals),
                      **extra)
        b.evals = evals
        out.append(b)
    return out[0], out[1], (X, y, Xv, yv)


def _logloss_obj(y):
    def fobj(score, dataset):
        p = 1.0 / (1.0 + np.exp(-score))
        return p - y, p * (1.0 - p)
    return fobj


def _error_rate(score, dataset):
    y = dataset.get_label()
    return "error_rate", float(np.mean((score > 0) != (y > 0))), False


def test_fobj_and_feval_match_jax():
    X, y, _, _ = _data()
    ej, et = {}, {}
    bj, bt, (_, _, Xv, _) = _pair(
        {"num_leaves": 15, "verbose": -1, "metric": "auc"}, ITERS,
        fobj=_logloss_obj(y), feval=_error_rate)
    assert bt._gbdt.objective is None and bt._gbdt.config.objective == "none"
    _assert_same_model_text(bj.model_to_string(), bt.model_to_string())
    np.testing.assert_allclose(bt.predict(Xv, raw_score=True),
                               bj.predict(Xv, raw_score=True), rtol=0,
                               atol=2e-5)
    ej, et = bj.evals, bt.evals
    assert et.keys() == ej.keys() and et["valid_0"].keys() == ej["valid_0"].keys()
    assert set(et["valid_0"]) == {"auc", "error_rate"}
    for m in ej["valid_0"]:
        np.testing.assert_allclose(et["valid_0"][m], ej["valid_0"][m],
                                   rtol=0, atol=1e-6)
    for rj, rt in zip(bj.eval_valid(_error_rate), bt.eval_valid(_error_rate)):
        assert rt[:2] == rj[:2] and rt[2] == pytest.approx(rj[2], abs=1e-6)


def test_objective_none_without_fobj_raises():
    X, y, _, _ = _data()
    for pkg, extra in ((lgb, {}), (lgt, {"device": "cpu"})):
        with pytest.raises(pkg.LightGBMError, match="custom grad"):
            pkg.train({"objective": "none", "verbose": -1},
                      pkg.Dataset(X, label=y), 2, verbose_eval=False, **extra)


def test_init_model_matches_jax_and_single_run(tmp_path):
    """3 + 3 iterations from a model file, in both packages, and from the
    port's ``Booster`` itself: the JAX package's model, and the port's
    model of 6 iterations in one run."""
    X, y, Xv, _ = _data()
    boosters = {}
    for name, pkg, extra in (("jax", lgb, {}), ("torch", lgt, {"device": "cpu"})):
        first = pkg.train(PARAMS, pkg.Dataset(X, label=y), 3,
                          verbose_eval=False, **extra)
        path = str(tmp_path / f"{name}.txt")
        first.save_model(path)
        boosters[name] = pkg.train(PARAMS, pkg.Dataset(X, label=y), 3,
                                   init_model=path, verbose_eval=False,
                                   **extra)
    bj, bt = boosters["jax"], boosters["torch"]
    assert bt.num_trees() == bt.current_iteration() == 6
    _assert_same_model_text(bj.model_to_string(), bt.model_to_string())
    first = lgt.train(PARAMS, lgt.Dataset(X, label=y), 3, verbose_eval=False,
                      device="cpu")
    from_booster = lgt.train(PARAMS, lgt.Dataset(X, label=y), 3,
                             init_model=first, verbose_eval=False,
                             device="cpu")
    assert from_booster.model_to_string() == bt.model_to_string()
    # the port replays the single run's float32 score updates: the same
    # trees as 6 iterations in one run
    whole = lgt.train(PARAMS, lgt.Dataset(X, label=y), 6, verbose_eval=False,
                      device="cpu")
    assert bt.model_to_string() == whole.model_to_string()
    np.testing.assert_array_equal(bt.predict(Xv), whole.predict(Xv))


def test_snapshot_freq_writes_checkpoints(tmp_path):
    X, y, Xv, _ = _data()
    out = str(tmp_path / "m.txt")
    bt = lgt.train(dict(PARAMS, snapshot_freq=2, output_model=out),
                   lgt.Dataset(X, label=y), 4, verbose_eval=False,
                   device="cpu")
    snap = lgt.Booster(model_file=out + ".snapshot_iter_2", device="cpu")
    assert snap.num_trees() == 2
    np.testing.assert_array_equal(
        snap.predict(Xv, raw_score=True),
        bt.predict(Xv, raw_score=True, num_iteration=2))
    assert lgt.Booster(model_file=out + ".snapshot_iter_4",
                       device="cpu").num_trees() == 4


@pytest.mark.parametrize("kind", ["callable", "list_and_num_leaves"])
def test_learning_rates_and_reset_parameter_match_jax(kind):
    """``learning_rates`` runs through the reset_parameter callback, which
    calls ``Booster.reset_parameter`` (fault C8: that method was
    missing); a ``num_leaves`` change must reach the grower."""
    if kind == "callable":
        kw = {"learning_rates": lambda it: 0.1 * (0.9 ** it)}
        want = [0.1 * (0.9 ** i) for i in range(ITERS)]
    else:
        want = [0.1, 0.05, 0.3, 0.3, 0.2]
        kw = {"callbacks": [lgb.reset_parameter(
            num_leaves=lambda it: 15 if it < 2 else 4, learning_rate=want)]}
    bj, bt, _ = _pair(PARAMS, ITERS, **kw)
    _assert_same_model_text(bj.model_to_string(), bt.model_to_string())
    # tree 0 carries the boost-from-average bias at shrinkage 1
    np.testing.assert_allclose([t.shrinkage for t in bt._gbdt.models][1:],
                               want[1:])
    if kind != "callable":
        leaves = [t.num_leaves for t in bt._gbdt.models]
        assert leaves[0] > 4 and max(leaves[2:]) <= 4, leaves


@pytest.fixture(scope="module")
def models():
    """A model trained by each package on the same data, and its data."""
    bj, bt, data = _pair(PARAMS, ITERS)
    return bj, bt, data


@pytest.mark.parametrize("keep", [False, True])
def test_keep_training_booster(models, keep):
    bj, bt0, (X, y, Xv, yv) = models
    ds = lgt.Dataset(X, label=y)
    bt = lgt.train(PARAMS, ds, ITERS, valid_sets=[ds.create_valid(Xv, yv)],
                   keep_training_booster=keep, verbose_eval=False,
                   device="cpu")
    _assert_same_model_text(bj.model_to_string(), bt.model_to_string())
    assert bt.model_to_string() == bt0.model_to_string()
    # the returned booster trains on
    bt.update()
    assert bt.num_trees() == ITERS + 1




def test_init_model_from_a_file_with_a_constant_feature(tmp_path):
    """A text-loaded tree names real features: on data with a constant
    (dropped) feature the warm maps them to the inner columns, so 3 + 3
    iterations from a file are still 6 in one run."""
    X, y, Xv, _ = _data()
    X = np.column_stack([np.full(len(X), 2.0), X])
    Xv = np.column_stack([np.full(len(Xv), 2.0), Xv])
    first = lgt.train(PARAMS, lgt.Dataset(X, label=y), 3, verbose_eval=False,
                      device="cpu")
    assert 0 not in first._gbdt.train_data.used_features
    path = str(tmp_path / "m.txt")
    first.save_model(path)
    cont = lgt.train(PARAMS, lgt.Dataset(X, label=y), 3, init_model=path,
                     verbose_eval=False, device="cpu")
    whole = lgt.train(PARAMS, lgt.Dataset(X, label=y), 6, verbose_eval=False,
                      device="cpu")
    assert cont.model_to_string() == whole.model_to_string()


def test_new_entry_points_default_to_cuda(tmp_path):
    """``cv``, a Dataset from a file and a Booster from a model file take
    ``device=None`` as the card: without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU error; this machine has a card")
    X, y, _, _ = _data()
    path = tmp_path / "train.tsv"
    np.savetxt(path, np.column_stack([y[:200], X[:200]]), delimiter="\t")
    model = tmp_path / "m.txt"
    lgt.train(PARAMS, lgt.Dataset(X, label=y), 1, verbose_eval=False,
              device="cpu").save_model(str(model))
    with pytest.raises(lgt.NoCudaDeviceError):
        lgt.cv(PARAMS, lgt.Dataset(X, label=y), 2, nfold=2)
    with pytest.raises(lgt.NoCudaDeviceError):
        lgt.Dataset(str(path)).construct()
    with pytest.raises(lgt.NoCudaDeviceError):
        lgt.Booster(model_file=str(model))
