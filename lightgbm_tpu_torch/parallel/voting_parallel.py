"""Voting-parallel GBDT training step: data parallel with ~constant comm.

Port of the JAX package's ``parallel/voting_parallel.py``
(``VotingParallelTreeLearner``, ``src/treelearner/
voting_parallel_tree_learner.cpp``): rows are sharded; each rank proposes
its local ``top_k`` split features, a global vote elects ``2 top_k``
features per leaf (``GlobalVoting``, ``:151``), and only the elected
features' histograms are summed over the ranks (``:184,345``), shrinking
a split's communication from ``F x B`` to ``2k x B`` histogram rows.  The
vote is a sum all-reduce of one-hot ballots (``split.voting_elect``); the
local min-data/min-hessian gates are scaled by ``1 / num_shards`` (``:61-63``).
"""
from __future__ import annotations

from typing import Callable

from ..ops.grower import GrowerConfig
from .data_parallel import _check_equal_rows, _grow_all
from .mesh import DATA_AXIS, ProcessMesh


def make_voting_train_step(grower_cfg: GrowerConfig,
                           feature_meta: dict,
                           grad_fn: Callable,
                           learning_rate: float,
                           mesh: ProcessMesh,
                           top_k: int = 20,
                           axis_name: str = DATA_AXIS):
    """Build a voting-parallel one-iteration training step: the calling
    convention of ``make_dp_train_step`` (this rank's rows); only the
    elected histograms cross between the ranks."""
    cfg = grower_cfg._replace(parallel_mode="voting", top_k=top_k,
                              num_shards=mesh.size, mesh=mesh)
    fm = feature_meta

    def step(bins, label, score, row_weight, fmask, key):
        _check_equal_rows(mesh, bins.shape[0], axis_name)
        # the shared grad_fn convention (score, label, weight); sample
        # weights are not wired through this learner's step
        grad, hess = grad_fn(score, label, None)
        return _grow_all(cfg, fm, learning_rate, 1, None, grad, hess, bins,
                         score, row_weight, fmask, key)
    return step
