"""PyTorch port, the ``Booster`` and ``Dataset`` surface against the JAX
package: ``reset_parameter`` (fault C8), ``rollback_one_iter`` (the scores
restored bit for bit), ``refit`` (leaf values within 5e-6), the methods of
``tests/test_booster_api.py``, ``dump_model``, ``trees_to_dataframe`` and
``get_split_value_histogram``, and the refusals of what stays unported.
Model texts are held as ``test_torch_train.py`` holds them.
"""
import pickle

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.device import NotPortedError

from test_torch_engine import ITERS, N, PARAMS, _data, _error_rate, _pair
from test_torch_train import _assert_same_model_text

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


def test_booster_reset_parameter_applies_structure():
    X, y, _, _ = _data()
    bst = lgt.Booster(params={"objective": "binary", "num_leaves": 31,
                              "min_data_in_leaf": 5, "verbose": -1},
                      train_set=lgt.Dataset(X, label=y), device="cpu")
    for _ in range(2):
        bst.update()
    bst.reset_parameter({"num_leaves": 4, "min_data_in_leaf": 40})
    assert bst._gbdt._grower_cfg.num_leaves == 4
    assert bst._gbdt._grower_cfg.split.min_data_in_leaf == 40
    for _ in range(2):
        bst.update()
    counts = [t["num_leaves"] for t in bst.dump_model()["tree_info"]]
    assert counts[0] > 4 and counts[-1] <= 4, counts
    with pytest.raises(lgt.LightGBMError, match="dataset parameters"):
        bst.reset_parameter({"max_bin": 63})
    with pytest.raises(ValueError, match="list and callable"):
        lgt.train(PARAMS, lgt.Dataset(X, label=y), 2, learning_rates=0.05,
                  verbose_eval=False, device="cpu")


def test_rollback_one_iter_restores_scores_and_matches_jax():
    X, y, Xv, yv = _data()
    boosters = []
    for pkg, extra in ((lgb, {}), (lgt, {"device": "cpu"})):
        ds = pkg.Dataset(X, label=y)
        b = pkg.Booster(params=dict(PARAMS, bagging_freq=2,
                                    bagging_fraction=0.7),
                        train_set=ds, **extra)
        b.add_valid(ds.create_valid(Xv, label=yv), "valid")
        for _ in range(3):
            b.update()
        boosters.append(b)
    bj, bt = boosters
    g = bt._gbdt
    before = (g._train_score.clone(), g._valid_scores[0].clone())
    text3 = bt.model_to_string()
    bt.update()
    bj.update()
    text4 = bt.model_to_string()
    for b in (bt, bj):
        b.rollback_one_iter()
    assert bt.num_trees() == bt.current_iteration() == 3
    assert torch.equal(g._train_score, before[0])
    assert torch.equal(g._valid_scores[0], before[1])
    assert bt.model_to_string() == text3
    _assert_same_model_text(bj.model_to_string(), bt.model_to_string())
    # the same iteration again: the same tree
    bt.update()
    assert bt.model_to_string() == text4
    # the history holds one step
    bt.rollback_one_iter()
    with pytest.raises(lgt.LightGBMError, match="rollback"):
        bt.rollback_one_iter()


def test_refit_matches_jax():
    X, y, Xv, yv = _data()
    bt = lgt.train(PARAMS, lgt.Dataset(X, label=y), ITERS,
                   verbose_eval=False, device="cpu")
    # both refit the same trees: the JAX package's from the port's text
    bj = lgb.Booster(model_str=bt.model_to_string())
    feats = [t.split_feature.copy() for t in bt._gbdt.models]
    before = [t.leaf_value.copy() for t in bt._gbdt.models]
    bt.refit(Xv, yv, decay_rate=0.5)
    bj.refit(Xv, yv, decay_rate=0.5)
    for tt, tj, f0, b0 in zip(bt._gbdt.models, bj._gbdt.models, feats,
                              before):
        np.testing.assert_array_equal(tt.split_feature, f0)
        np.testing.assert_allclose(tt.leaf_value, tj.leaf_value, rtol=0,
                                   atol=5e-6)
        assert not np.allclose(tt.leaf_value, b0)
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), rtol=0,
                               atol=5e-6)


@pytest.fixture(scope="module")
def models():
    """A model trained by each package on the same data, and its data."""
    bj, bt, data = _pair(PARAMS, ITERS)
    return bj, bt, data


def test_booster_methods_match_jax(models):
    """``tests/test_booster_api.py``'s surface on both packages."""
    bj0, bt0, (X, y, Xv, yv) = models
    text = bt0.model_to_string()
    bj = lgb.Booster(model_str=text)
    bt = lgt.Booster(model_str=text, device="cpu")
    assert bt.attr("missing") is None
    bt.set_attr(run="42", note="hello")
    bt.set_attr(run=None)
    assert bt.attr("run") is None and bt.attr("note") == "hello"
    assert bt.lower_bound() == bj.lower_bound()
    assert bt.upper_bound() == bj.upper_bound()
    raw = bt.predict(Xv, raw_score=True)
    assert bt.lower_bound() <= raw.min() and raw.max() <= bt.upper_bound()
    for tree, leaf in ((0, 0), (2, 5), (ITERS - 1, 3)):
        assert bt.get_leaf_output(tree, leaf) == bj.get_leaf_output(tree, leaf)
    other = lgt.Booster(model_str=bj0.model_to_string(), device="cpu")
    other.model_from_string(text)
    assert other.model_to_string() == bt.model_to_string()
    bt.shuffle_models()
    bj.shuffle_models()
    assert bt.model_to_string() == bj.model_to_string() != text
    np.testing.assert_allclose(bt.predict(Xv), bt0.predict(Xv), rtol=1e-6)
    clone = pickle.loads(pickle.dumps(bt0))
    assert clone.model_to_string() == lgt.Booster(
        model_str=bt0.model_to_string(), device="cpu").model_to_string()
    assert clone.device == bt0.device
    # eval_train / eval_valid with a feval, and on a loaded model
    for tj, tt in zip(bj0.eval_train(_error_rate),
                      bt0.eval_train(_error_rate)):
        assert tt[:2] == tj[:2] and tt[2] == pytest.approx(tj[2], abs=1e-6)
    assert bt.eval_train(feval=_error_rate) == []
    assert [r[:2] for r in bt0.eval(feval=_error_rate)] == \
        [r[:2] for r in bj0.eval(feval=_error_rate)]
    p = bt0.predict(Xv)
    bt0.free_dataset()
    assert bt0.train_set is None
    np.testing.assert_array_equal(bt0.predict(Xv), p)


def test_dump_model_and_trees_to_dataframe_match_jax(models):
    bj, bt, (X, _, _, _) = models
    dj, dt = bj.dump_model(), bt.dump_model()
    assert dt.keys() == dj.keys()
    for key in dj:
        if key != "tree_info":
            assert dt[key] == dj[key], key
    for tj, tt in zip(dj["tree_info"], dt["tree_info"]):
        _assert_same_node(tj, tt)
    fj, ft = bj.trees_to_dataframe(), bt.trees_to_dataframe()
    assert list(ft.columns) == list(fj.columns) and ft.shape == fj.shape
    for col in fj.columns:
        a, b = ft[col].to_numpy(), fj[col].to_numpy()
        if col in ("split_gain", "value", "weight", "count", "threshold"):
            a = np.array([np.nan if v is None else v for v in a], float)
            b = np.array([np.nan if v is None else v for v in b], float)
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                       equal_nan=True, err_msg=col)
        else:
            assert list(a) == list(b), col
    for feat in (0, "Column_1"):
        hj = bj.get_split_value_histogram(feat)
        ht = bt.get_split_value_histogram(feat)
        np.testing.assert_array_equal(ht[0], hj[0])
        np.testing.assert_array_equal(ht[1], hj[1])
    xj = bj.get_split_value_histogram(0, xgboost_style=True)
    xt = bt.get_split_value_histogram(0, xgboost_style=True)
    np.testing.assert_array_equal(xt.to_numpy(), xj.to_numpy())


def _assert_same_node(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], dict):
            _assert_same_node(a[key], b[key])
        elif isinstance(a[key], float):
            assert b[key] == pytest.approx(a[key], rel=1e-4, abs=1e-5), key
        else:
            assert b[key] == a[key], key


def test_dataset_methods_match_jax():
    """``tests/test_booster_api.py``'s Dataset surface on both packages."""
    X, y, Xv, yv = _data()
    names = [f"f{i}" for i in range(X.shape[1])]
    out = {}
    for pkg, extra in ((lgb, {}), (lgt, {"device": "cpu"})):
        train = pkg.Dataset(X, label=y, **extra)
        valid = pkg.Dataset(Xv, label=yv, **extra)
        valid.set_reference(train)
        assert valid.get_ref_chain() == {train, valid}
        train.set_feature_name(names)
        train.construct(*extra.values())
        assert train.get_feature_name() == names
        assert train.get_params() == {} and train.get_data() is X
        with pytest.raises(pkg.LightGBMError):
            valid.construct(*extra.values()).set_reference(train)
        w = np.linspace(0.5, 1.5, N)
        train.set_weight(w)
        train.set_init_score(np.full(N, 0.25))
        train.set_label(1.0 - y)
        left = pkg.Dataset(X[:, :4], label=y)
        left.add_features_from(pkg.Dataset(X[:, 4:], categorical_feature=[1]))
        assert left.categorical_feature == [5]
        left.construct(*extra.values())
        with pytest.raises(pkg.LightGBMError):
            pkg.Dataset("some_file.csv").add_features_from(left)
        out[pkg.__name__] = (train, left)
    (tj, lj), (tt, lt) = out["lightgbm_tpu"], out["lightgbm_tpu_torch"]
    for getter in ("get_label", "get_weight", "get_init_score"):
        np.testing.assert_array_equal(getattr(tt, getter)(),
                                      getattr(tj, getter)(), err_msg=getter)
    assert tt.num_bins_total() == tj.num_bins_total()
    assert lt.num_feature() == lj.num_feature() == X.shape[1]
    np.testing.assert_array_equal(lt._inner.bins, lj._inner.bins)
    bt = lgt.train(PARAMS, lt, 3, verbose_eval=False, device="cpu")
    assert bt.num_trees() == 3


def test_unported_paths_raise(tmp_path, capsys):
    """What stays unported raises NotPortedError: multi-process training.
    The obs-report subcommand is ported: it renders a small journal and
    exits 0.  Refit and pred_contrib of a linear-tree model raise the JAX
    package's LightGBMError: neither package has that path (continued
    training from one is ported, tests/test_torch_linear_tree.py)."""
    from lightgbm_tpu_torch.application import main
    X, y, _, _ = _data()
    bt = lgt.train(PARAMS, lgt.Dataset(X, label=y), 2, verbose_eval=False,
                   device="cpu")
    with pytest.raises(NotPortedError, match="set_network"):
        bt.set_network(["127.0.0.1:12400"])
    with pytest.raises(NotPortedError, match="free_network"):
        bt.free_network()
    journal = tmp_path / "journal.jsonl"
    journal.write_text('{"metric": "m", "value": 1.0}\n')
    assert main(["obs-report", "--path", str(journal), "--no-metrics"]) == 0
    assert "1 legacy" in capsys.readouterr().out
    linear = lgb.train(dict(PARAMS, linear_tree=True),
                       lgb.Dataset(X[:500], label=y[:500]), 1,
                       verbose_eval=False)
    lin = lgt.Booster(model_str=linear.model_to_string(), device="cpu")
    with pytest.raises(lgt.LightGBMError, match="linear-tree"):
        lin.refit(X, y)
    with pytest.raises(lgt.LightGBMError, match="linear trees"):
        lin.predict(X, pred_contrib=True)


def test_positional_order_is_the_jax_packages():
    """``Dataset`` and ``Booster`` take their arguments in the JAX
    package's (the reference's) positional order, ``device`` last."""
    import inspect
    for jcls, tcls in ((lgb.Dataset, lgt.Dataset), (lgb.Booster, lgt.Booster)):
        jp = list(inspect.signature(jcls.__init__).parameters)
        tp = list(inspect.signature(tcls.__init__).parameters)
        assert tp == jp + ["device"], (tp, jp)
    for jf, tf in ((lgb.train, lgt.train), (lgb.cv, lgt.cv)):
        jp = list(inspect.signature(jf).parameters)
        assert list(inspect.signature(tf).parameters) == jp + ["device"]
    X, y, _, _ = _data()
    names = [f"c{i}" for i in range(X.shape[1])]
    ds = lgt.Dataset(X, y, None, None, None, None, True, names)
    assert ds.silent is True and ds.feature_name == names
    bst = lgt.train(PARAMS, ds, 2, verbose_eval=False, device="cpu")
    assert bst.feature_name() == names and ds.params["verbose"] == -1
    b2 = lgt.Booster(None, None, None, bst.model_to_string(), True, "cpu")
    assert b2.silent is True
    np.testing.assert_array_equal(b2.predict(X), bst.predict(X))
