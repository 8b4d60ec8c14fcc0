"""PyTorch port, the plotting helpers (``lightgbm_tpu_torch.plotting``) on
the CPU: what applies of ``tests/test_plotting.py``, run against the port,
and the same drawings as the JAX package's for the same model (the helpers
read the model dump, so a model carried across by its text draws the same
bars, histogram and graph).
"""
import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lgt  # noqa: E402

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trained(binary_data):
    X, y, _, _ = binary_data
    ds = lgt.Dataset(X, label=y)
    evals = {}
    bst = lgt.train({"objective": "binary", "num_leaves": 7, "verbose": -1},
                    ds, num_boost_round=10, valid_sets=[ds],
                    valid_names=["train"],
                    callbacks=[lgt.record_evaluation(evals)], device="cpu")
    return bst, evals


def test_plot_importance(trained):
    bst, _ = trained
    ax = lgt.plot_importance(bst)
    assert ax.get_title() == "Feature importance"
    assert ax.get_xlabel() == "Feature importance"
    assert len(ax.patches) >= 1
    ax2 = lgt.plot_importance(bst, importance_type="gain",
                              max_num_features=3, title="t", xlabel="x",
                              ylabel="y")
    assert len(ax2.patches) <= 3
    assert ax2.get_title() == "t"
    # the JAX package's helper draws the same bars from the same model
    bj = lgb.Booster(model_str=bst.model_to_string())
    axj = lgb.plot_importance(bj)
    assert [p.get_width() for p in ax.patches] == \
        [p.get_width() for p in axj.patches]
    assert [t.get_text() for t in ax.get_yticklabels()] == \
        [t.get_text() for t in axj.get_yticklabels()]


def test_plot_metric(trained, binary_data):
    _, evals = trained
    ax = lgt.plot_metric(evals)
    assert ax.get_xlabel() == "Iterations"
    lines = ax.get_lines()
    assert len(lines) == 1
    assert len(lines[0].get_xdata()) == 10
    with pytest.raises(TypeError):
        lgt.plot_metric(trained[0])
    X, y, Xt, yt = binary_data
    clf = lgt.LGBMClassifier(n_estimators=5, num_leaves=7, verbose=-1,
                             device="cpu")
    clf.fit(X, y, eval_set=[(Xt, yt)])
    assert len(lgt.plot_metric(clf).get_lines()) == 1


def test_plot_split_value_histogram(trained):
    bst, _ = trained
    imp = bst.feature_importance("split")
    feat = int(np.argmax(imp))
    ax = lgt.plot_split_value_histogram(bst, feat)
    assert ax.get_xlabel() == "Feature split value"
    bj = lgb.Booster(model_str=bst.model_to_string())
    axj = lgb.plot_split_value_histogram(bj, feat)
    assert [p.get_height() for p in ax.patches] == \
        [p.get_height() for p in axj.patches]
    unused = int(np.argmin(imp))
    if imp[unused] == 0:
        with pytest.raises(ValueError):
            lgt.plot_split_value_histogram(bst, unused)


def test_get_split_value_histogram(trained):
    bst, _ = trained
    imp = bst.feature_importance("split")
    feat = int(np.argmax(imp))
    hist, edges = bst.get_split_value_histogram(feat)
    assert hist.sum() == imp[feat]
    assert len(edges) == len(hist) + 1
    df = bst.get_split_value_histogram(feat, xgboost_style=True)
    assert df["Count"].sum() == imp[feat]


def test_create_tree_digraph(trained):
    bst, _ = trained
    show = ["split_gain", "internal_count", "leaf_count"]
    g = lgt.plotting.create_tree_digraph(bst, tree_index=1, show_info=show)
    s = g.source
    assert "graph" in s or "digraph" in s
    assert "split1" in s or "split0" in s
    with pytest.raises(IndexError):
        lgt.plotting.create_tree_digraph(bst, tree_index=10**6)
    # a model loaded from text dumps no feature names in either package
    text = bst.model_to_string()
    gj = lgb.plotting.create_tree_digraph(lgb.Booster(model_str=text),
                                          tree_index=1, show_info=show)
    gt = lgt.plotting.create_tree_digraph(
        lgt.Booster(model_str=text, device="cpu"), tree_index=1,
        show_info=show)
    assert gt.source == gj.source


def test_trees_to_dataframe(trained):
    bst, _ = trained
    df = bst.trees_to_dataframe()
    assert set(df.columns) >= {"tree_index", "node_depth", "node_index",
                               "split_feature", "threshold", "value", "count"}
    assert df["tree_index"].nunique() == 10
    t0 = df[df.tree_index == 0]
    leaves = t0[t0.split_feature.isna()]
    internals = t0[~t0.split_feature.isna()]
    assert len(leaves) == len(internals) + 1
    assert leaves["count"].sum() == 1500
