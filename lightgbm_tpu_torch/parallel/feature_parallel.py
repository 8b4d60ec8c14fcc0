"""Feature-parallel GBDT training step: features sharded over the ranks.

Port of the JAX package's ``parallel/feature_parallel.py``
(``FeatureParallelTreeLearner``, ``src/treelearner/
feature_parallel_tree_learner.cpp``): every rank holds every row and a
block of the feature columns, searches its block, and the ranks' best
splits ride one all-gather (``ops.grower._reduce_split_global``) so every
rank applies the identical split.  The columns are sharded (the reference
replicates them), so the rank holding the split's column decides the rows'
sides and shares them: one broadcast a split in the sequential grower, one
``[N]`` sum a round in the frontier.
"""
from __future__ import annotations

from typing import Callable

from ..ops.grower import GrowerConfig
from .data_parallel import _grow_all
from .mesh import FEATURE_AXIS, ProcessMesh


def make_fp_train_step(grower_cfg: GrowerConfig,
                       feature_meta: dict,
                       grad_fn: Callable,
                       learning_rate: float,
                       mesh: ProcessMesh,
                       axis_name: str = FEATURE_AXIS):
    """Build a feature-parallel one-iteration training step.

    At call time: ``bins [N, F / W]`` (this rank's block of the columns),
    label/score/row_weight ``[N]`` (replicated), ``fmask [F]`` full-width
    (replicated), key.  ``feature_meta`` stays full-width (``F`` a
    multiple of the ranks: pad features with one bin).  Returns
    ``(new_score[N], TreeArrays)``, both replicated.
    """
    n_shards = mesh.size
    cfg = grower_cfg._replace(parallel_mode="feature", num_shards=n_shards,
                              mesh=mesh)
    fm = feature_meta

    def step(bins, label, score, row_weight, fmask, key):
        f = int(fm["num_bins"].shape[0])
        if f % n_shards or bins.shape[1] * n_shards != f:
            raise ValueError(
                f"feature count {f} is not divisible by the "
                f"{n_shards}-way '{axis_name}' mesh axis (or this rank's "
                f"block is not {f} / {n_shards} columns); pad features "
                f"(all-constant columns bin to a single bin and are never "
                f"chosen)")
        # the shared grad_fn convention (score, label, weight); sample
        # weights are not wired through this learner's step
        grad, hess = grad_fn(score, label, None)
        return _grow_all(cfg, fm, learning_rate, 1, None, grad, hess, bins,
                         score, row_weight, fmask, key)
    return step


def pad_features_to_multiple(f: int, k: int) -> int:
    """Features must divide the mesh axis; number of pad columns needed."""
    return (-f) % k
