"""Distributed training over ``torch.distributed`` process groups.

Port of the JAX package's ``parallel`` package, which replaces the
reference's ``src/network/`` layer (Bruck all-gather and recursive-halving
reduce-scatter over TCP sockets or MPI) and its three parallel tree
learners (``src/treelearner/{data,feature,voting}_parallel_tree_learner.
cpp``).  Each shard is a process, one card a process; the communication
patterns are single collectives of the process group (``nccl`` between
cards, ``gloo`` on the CPU):

- histogram ReduceScatter        -> ``reduce_scatter`` / sum ``all_reduce``
- best-split Allreduce (max)     -> one ``all_gather`` of the packed records
- scalar GlobalSum / SyncUpBy*   -> sum / min / max ``all_reduce``

Bring-up (the reference's machine list and port handshake,
``linkers_socket.cpp``) is ``set_network`` or ``init_distributed``.
"""
from .mesh import (default_mesh, free_network, init_distributed, mesh_2d,
                   set_network)
from ..io.distributed import distributed_dataset
from .trainer import train_distributed
from .data_parallel import make_dp_train_step, pad_rows_to_multiple, shard_rows
from .feature_parallel import make_fp_train_step, pad_features_to_multiple
from .voting_parallel import make_voting_train_step
from .estimators import DistLGBMClassifier, DistLGBMRegressor

__all__ = ["default_mesh", "mesh_2d", "init_distributed", "set_network",
           "free_network", "distributed_dataset", "train_distributed",
           "make_dp_train_step",
           "make_fp_train_step", "make_voting_train_step",
           "pad_rows_to_multiple", "pad_features_to_multiple", "shard_rows",
           "DistLGBMClassifier", "DistLGBMRegressor"]
