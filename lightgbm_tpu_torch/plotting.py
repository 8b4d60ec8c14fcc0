"""Plotting (reference ``python-package/lightgbm/plotting.py:26-547``).

A copy of the JAX package's ``plotting.py`` on this package's ``Booster``:
``plot_importance`` / ``plot_split_value_histogram`` / ``plot_metric`` /
``plot_tree`` / ``create_tree_digraph``, rendered on the host from the
model dump; matplotlib and graphviz are optional and imported at call time
like the reference's ``compat.py`` shims.
"""
from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from .basic import Booster
from .utils.log import LightGBMError

__all__ = ["plot_importance", "plot_split_value_histogram", "plot_metric",
           "plot_tree", "create_tree_digraph"]


def _check_not_tuple_of_2_elements(obj, obj_name):
    if not isinstance(obj, tuple) or len(obj) != 2:
        raise TypeError(f"{obj_name} must be a tuple of 2 elements.")


def _import_matplotlib():
    try:
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:  # pragma: no cover
        raise ImportError("You must install matplotlib to plot.") from e


def _to_booster(booster) -> Booster:
    from .sklearn import LGBMModel
    if isinstance(booster, LGBMModel):
        return booster.booster_
    if isinstance(booster, Booster):
        return booster
    raise TypeError("booster must be Booster or LGBMModel.")


def plot_importance(booster, ax=None, height: float = 0.2,
                    xlim: Optional[tuple] = None, ylim: Optional[tuple] = None,
                    title: str = "Feature importance",
                    xlabel: str = "Feature importance",
                    ylabel: str = "Features",
                    importance_type: str = "split",
                    max_num_features: Optional[int] = None,
                    ignore_zero: bool = True, figsize=None, dpi=None,
                    grid: bool = True, precision: Optional[int] = 3, **kwargs):
    """Horizontal bar chart of feature importance (reference plotting.py:26)."""
    plt = _import_matplotlib()
    booster = _to_booster(booster)

    importance = booster.feature_importance(importance_type=importance_type)
    feature_name = booster.feature_name()
    if not len(importance):
        raise ValueError("Booster's feature_importance is empty.")

    tuples = sorted(zip(feature_name, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [x for x in tuples if x[1] > 0]
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    if not tuples:
        raise ValueError("No features with importance > 0 to plot.")
    labels, values = zip(*tuples)

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)

    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        if importance_type == "gain":
            val = f"{x:.{precision}f}" if precision is not None else str(float(x))
        else:
            val = str(int(x))
        ax.text(x + 1, y, val, va="center")

    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
    else:
        xlim = (0, max(values) * 1.1)
    ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
    else:
        ylim = (-1, len(values))
    ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_split_value_histogram(booster, feature, bins=None, ax=None,
                               width_coef: float = 0.8,
                               xlim=None, ylim=None,
                               title: Optional[str] = "Split value histogram for feature with @feature@ @index/name@",
                               xlabel: Optional[str] = "Feature split value",
                               ylabel: Optional[str] = "Count",
                               figsize=None, dpi=None, grid: bool = True,
                               **kwargs):
    """Split-value histogram for one feature (reference plotting.py:143)."""
    plt = _import_matplotlib()
    booster = _to_booster(booster)
    hist, split_bins = booster.get_split_value_histogram(
        feature=feature, bins=bins, xgboost_style=False)
    if np.count_nonzero(hist) == 0:
        raise ValueError(f"Cannot plot split value histogram, "
                         f"because feature {feature} was not used in splitting")
    width = width_coef * (split_bins[1] - split_bins[0])
    centred = (split_bins[:-1] + split_bins[1:]) / 2

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)

    ax.bar(centred, hist, align="center", width=width, **kwargs)
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
    else:
        range_result = split_bins[-1] - split_bins[0]
        xlim = (split_bins[0] - range_result * 0.2, split_bins[-1] + range_result * 0.2)
    ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
    else:
        ylim = (0, max(hist) * 1.1)
    ax.set_ylim(ylim)
    if title is not None:
        title = title.replace("@feature@", str(feature)) \
            .replace("@index/name@", "name" if isinstance(feature, str) else "index")
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster, metric: Optional[str] = None,
                dataset_names: Optional[List[str]] = None,
                ax=None, xlim=None, ylim=None,
                title: Optional[str] = "Metric during training",
                xlabel: Optional[str] = "Iterations",
                ylabel: Optional[str] = "@metric@",
                figsize=None, dpi=None, grid: bool = True):
    """Plot a recorded eval metric over iterations (reference plotting.py:249).

    Takes the dict produced by the ``record_evaluation`` callback (or an
    LGBMModel with ``evals_result_``).
    """
    plt = _import_matplotlib()
    from .sklearn import LGBMModel
    if isinstance(booster, LGBMModel):
        eval_results = deepcopy(booster.evals_result_)
    elif isinstance(booster, dict):
        eval_results = deepcopy(booster)
    elif isinstance(booster, Booster):
        raise TypeError("booster must be dict or LGBMModel. To use plot_metric with Booster "
                        "type, first record the metrics using record_evaluation callback "
                        "then pass that to plot_metric as argument `booster`")
    else:
        raise TypeError("booster must be dict or LGBMModel.")
    if not eval_results:
        raise ValueError("eval results cannot be empty.")

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)

    if dataset_names is None:
        dataset_names_iter = iter(eval_results.keys())
    elif not isinstance(dataset_names, (list, tuple, set)) or not dataset_names:
        raise ValueError("dataset_names should be iterable and cannot be empty")
    else:
        dataset_names_iter = iter(dataset_names)

    name = next(dataset_names_iter)  # take one as sample
    metrics_for_one = eval_results[name]
    num_metric = len(metrics_for_one)
    if metric is None:
        if num_metric > 1:
            raise ValueError("Expected only one metric, got more. Please specify the metric.")
        metric, results = metrics_for_one.popitem()
    else:
        if metric not in metrics_for_one:
            raise KeyError("No given metric in eval results.")
        results = metrics_for_one[metric]
    num_iteration = len(results)
    max_result = max(results)
    min_result = min(results)
    x_ = range(num_iteration)
    ax.plot(x_, results, label=name)

    for name in dataset_names_iter:
        metrics_for_one = eval_results[name]
        results = metrics_for_one[metric]
        max_result = max(*results, max_result)
        min_result = min(*results, min_result)
        ax.plot(x_, results, label=name)

    ax.legend(loc="best")
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
    else:
        xlim = (0, num_iteration)
    ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
    else:
        range_result = max_result - min_result
        ylim = (min_result - range_result * 0.2, max_result + range_result * 0.2)
    ax.set_ylim(ylim)
    if ylabel is not None:
        ylabel = ylabel.replace("@metric@", metric)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def _float2str(value, precision: Optional[int] = None) -> str:
    return (f"{value:.{precision}f}" if precision is not None
            and not isinstance(value, str) else str(value))


def create_tree_digraph(booster, tree_index: int = 0,
                        show_info: Optional[List[str]] = None,
                        precision: Optional[int] = 3,
                        orientation: str = "horizontal", **kwargs):
    """Graphviz Digraph of one tree (reference plotting.py:334)."""
    try:
        from graphviz import Digraph
    except ImportError as e:  # pragma: no cover
        raise ImportError("You must install graphviz to plot tree.") from e
    booster = _to_booster(booster)
    model = booster.dump_model()
    tree_infos = model["tree_info"]
    feature_names = model.get("feature_names") or None
    if tree_index >= len(tree_infos):
        raise IndexError("tree_index is out of range.")
    tree_info = tree_infos[tree_index]
    if "split_index" not in tree_info["tree_structure"]:
        raise ValueError("Cannot plot trees with no split.")
    if show_info is None:
        show_info = []

    graph = Digraph(**kwargs)
    rankdir = "LR" if orientation == "horizontal" else "TB"
    graph.attr("graph", nodesep="0.05", ranksep="0.3", rankdir=rankdir)

    def add(node, parent=None, decision=None):
        if "split_index" in node:  # internal
            name = f"split{node['split_index']}"
            feat_idx = node["split_feature"]
            feature = (feature_names[feat_idx] if feature_names
                       else f"feature {feat_idx}")
            label = f"<B>{feature}</B>"
            if node["decision_type"] == "==":
                label += " = "
            else:
                label += " &#8804; "  # <=
            label += f"<B>{_float2str(node['threshold'], precision)}</B>"
            for info in ("split_gain", "internal_value", "internal_count"):
                if info in show_info:
                    label += f"<br/>{_float2str(node[info], precision)} {info.split('_')[-1]}"
            graph.node(name, label=f"<{label}>")
            add(node["left_child"], name, "yes")
            add(node["right_child"], name, "no")
        else:  # leaf
            name = f"leaf{node['leaf_index']}"
            label = f"leaf {node['leaf_index']}: "
            label += f"<B>{_float2str(node['leaf_value'], precision)}</B>"
            if "leaf_weight" in show_info and "leaf_weight" in node:
                label += f"<br/>{_float2str(node['leaf_weight'], precision)} weight"
            if "leaf_count" in show_info and "leaf_count" in node:
                label += f"<br/>count: {node['leaf_count']}"
            graph.node(name, label=f"<{label}>")
        if parent is not None:
            graph.edge(parent, name, decision)

    add(tree_info["tree_structure"])
    return graph


def plot_tree(booster, ax=None, tree_index: int = 0, figsize=None, dpi=None,
              show_info: Optional[List[str]] = None,
              precision: Optional[int] = 3,
              orientation: str = "horizontal", **kwargs):
    """Render one tree via graphviz into a matplotlib axis (reference plotting.py:480)."""
    plt = _import_matplotlib()
    import matplotlib.image as mpimg
    graph = create_tree_digraph(booster=booster, tree_index=tree_index,
                                show_info=show_info, precision=precision,
                                orientation=orientation, **kwargs)
    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    from io import BytesIO
    s = BytesIO(graph.pipe(format="png"))
    img = mpimg.imread(s)
    ax.imshow(img)
    ax.axis("off")
    return ax
