"""Data-parallel GBDT training step: rows sharded over the ranks.

Port of the JAX package's ``parallel/data_parallel.py``
(``DataParallelTreeLearner``, ``src/treelearner/
data_parallel_tree_learner.cpp``): each rank holds a block of the rows,
builds its histograms, and the grower's collectives join them
(``ops/grower.py``: per split the histograms are reduce-scattered so each
rank receives, stores and searches its block of features, and the ranks'
best splits ride one all-gather, ``_reduce_split_global``; the frontier
grower sums the full histograms).  Every rank applies the identical split
to its own rows.  Paths that need full-width histograms on every rank (EFB
bundles, forced splits, CEGB-lazy) sum them in full.

A step is a plain function that runs this rank's part and its
collectives: the JAX package's calling conventions, where each argument
is the block ``shard_map`` would hand this rank.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ops.grower import GrowerConfig, TreeArrays, grow_tree
from ..utils.random_gen import fold_in
from .mesh import DATA_AXIS, ProcessMesh


def _grow_all(cfg: GrowerConfig, fm: dict, learning_rate: float, K: int,
              efb, grads, hesses, bins, score, row_weight, fmask, key):
    """``num_class`` trees on this rank's block: ``(score + the shrunk
    leaf values of each row's leaf, TreeArrays)``, the tree fields gaining
    a leading class axis when ``K > 1`` (each class's tree keyed by
    ``fold_in(key, k)``)."""
    new_score = score.clone()
    trees = []
    for k in range(K):
        g, h = (grads, hesses) if K == 1 else (grads[k], hesses[k])
        kk = key if (K == 1 or key is None) else fold_in(key, k)
        tree, node_assign, _ = grow_tree(
            bins, g, h, row_weight, fmask, fm["num_bins"], fm["nan_bins"],
            cfg, key=kk, monotone=fm.get("monotone"),
            is_categorical=fm.get("is_categorical"), efb=efb)
        if int(tree.num_leaves) > 1:
            delta = tree.leaf_value * learning_rate
            if K == 1:
                new_score += delta[node_assign]
            else:
                new_score[k] += delta[node_assign]
        trees.append(tree)
    if K == 1:
        return new_score, trees[0]
    return new_score, TreeArrays(*[torch.stack(f) for f in zip(*trees)])


def _check_equal_rows(mesh: ProcessMesh, n_local: int, axis_name: str):
    """The ranks' blocks must be equal, as ``shard_map``'s are."""
    counts = mesh.gather_np(np.array([n_local], np.int64)).reshape(-1)
    if counts.min() != counts.max():
        raise ValueError(
            f"row count {int(counts.sum())} is not divisible by the "
            f"{mesh.size}-way '{axis_name}' mesh axis (blocks of "
            f"{counts.tolist()} rows); pad rows with pad_rows_to_multiple() "
            f"and zero row_weight for pad rows")


def make_dp_train_step(grower_cfg: GrowerConfig,
                       feature_meta: dict,
                       grad_fn: Optional[Callable],
                       learning_rate: float,
                       mesh: ProcessMesh,
                       axis_name: str = DATA_AXIS,
                       num_class: int = 1,
                       external_grads: bool = False,
                       efb=None):
    """Build a data-parallel one-iteration training step.

    Args:
      grower_cfg: the grower's config; its parallel fields are set here.
      feature_meta: every feature's ``num_bins``, ``nan_bins`` (and
        optionally ``monotone``, ``is_categorical``; ``default_bins`` is
        accepted and unused), replicated.
      grad_fn: the objective's gradients on this rank's rows,
        ``(score[n], label[n], weight[n]|None) -> (grad, hess)``, or
        ``(score[K, n], label, weight) -> ([K, n], [K, n])`` when
        ``num_class > 1``.
      learning_rate: shrinkage of the leaf values in the score update.
      mesh: the ranks (``parallel.mesh.default_mesh``).

    Returns ``step(bins[n, F], label[n], score[n] or [K, n], row_weight[n],
    fmask[F], key, weight=None) -> (new_score, TreeArrays)`` over this
    rank's rows (``row_weight`` carries the pad/bag mask, ``weight`` the
    sample weights); with ``external_grads`` it is ``step(bins, grads,
    hesses, score, row_weight, fmask, key)``.  The tree is the same on
    every rank.
    """
    cfg = grower_cfg._replace(parallel_mode="data", num_shards=mesh.size,
                              mesh=mesh)
    K = num_class
    fm = feature_meta

    if external_grads:
        def step_ex(bins, grads, hesses, score, row_weight, fmask, key):
            _check_equal_rows(mesh, bins.shape[0], axis_name)
            return _grow_all(cfg, fm, learning_rate, K, efb, grads, hesses,
                             bins, score, row_weight, fmask, key)
        return step_ex

    def step(bins, label, score, row_weight, fmask, key, weight=None):
        _check_equal_rows(mesh, bins.shape[0], axis_name)
        if weight is None:
            weight = torch.ones_like(label)
        grads, hesses = grad_fn(score, label, weight)
        return _grow_all(cfg, fm, learning_rate, K, efb, grads, hesses, bins,
                         score, row_weight, fmask, key)
    return step


def shard_rows(mesh: ProcessMesh, axis_name: str = DATA_AXIS):
    """A function taking an ``[N, ...]`` array (N a multiple of the ranks)
    to this rank's block of rows, the block ``P(axis_name)`` places on it."""
    def take(a):
        n = a.shape[0]
        if n % mesh.size:
            raise ValueError(
                f"row count {n} is not divisible by the {mesh.size}-way "
                f"'{axis_name}' mesh axis; pad rows with "
                f"pad_rows_to_multiple()")
        m = n // mesh.size
        return a[mesh.rank * m:(mesh.rank + 1) * m]
    return take


def pad_rows_to_multiple(n: int, k: int) -> int:
    """Rows must divide the mesh axis; pad count (weights 0 for pad rows)."""
    return (-n) % k
