"""Distributed (multi-process) binning: sharded ingest with globally
consistent bin mappers.

Port of the JAX package's ``io/distributed.py`` (reference analog: with
``pre_partition=true`` each rank samples its own partition and the ranks
pool their samples so every machine constructs IDENTICAL bin boundaries,
``src/io/dataset_loader.cpp:950``).  The pooling collective is an
all-gather over the ``torch.distributed`` group (``parallel.mesh``), in
float64, exactly, one block of features at a time.  Every rank then runs
the same deterministic ``_find_bin_one`` and EFB planning on the pooled
sample, so the mappers and the bundle layout are identical with no
broadcast; each rank bins only its own rows.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..config import Config
from ..utils.log import Log, check
from ..utils.random_gen import Random
from .dataset import (Dataset, Metadata, _is_sparse, _resolve_categorical,
                      _sanitize_feature_names)

# the densified float64 bytes of one pooled block of features
_POOL_BLOCK_BYTES = 128 * 1024 * 1024


def _allgather_block(mesh, block: np.ndarray, counts: np.ndarray
                     ) -> np.ndarray:
    """Pool one per-rank ``[rows, FB]`` float64 sample block: pad the rows
    to the largest rank's count, all-gather (float64 travels exactly), and
    drop each rank's padding."""
    cap = int(counts.max())
    padded = np.zeros((cap, block.shape[1]), np.float64)
    padded[:block.shape[0]] = block
    gathered = mesh.gather_np(padded)                     # [W, cap, FB]
    return np.concatenate([gathered[r, :int(counts[r])]
                           for r in range(mesh.size)], axis=0)


def distributed_dataset(data, config: Optional[Config] = None, label=None,
                        weight=None, group=None, init_score=None,
                        categorical_feature: Optional[Sequence[int]] = None,
                        feature_names: Optional[Sequence[str]] = None,
                        mesh=None) -> Dataset:
    """Build this rank's ``Dataset`` (``data`` is its row partition: a dense
    array or scipy sparse) whose bin mappers and EFB bundle layout are
    identical on every rank of the process group
    (``parallel.mesh.init_distributed``).  Each rank draws its local sample
    by ``Random(data_random_seed + rank)``, sized by its share of
    ``bin_construct_sample_cnt``.  With one process it is the ordinary
    single-host constructor."""
    from ..parallel.mesh import default_mesh
    mesh = mesh or default_mesh()
    config = config or Config()
    if mesh.size == 1:
        return Dataset.from_data(
            data, config, label=label, weight=weight, group=group,
            init_score=init_score, categorical_feature=categorical_feature,
            feature_names=feature_names)

    self = Dataset(config)
    sparse = _is_sparse(data)
    if sparse:
        data = data.tocsr()
        check(not config.linear_tree,
              "linear_tree with sparse input is not supported")
    else:
        data = np.ascontiguousarray(np.asarray(data, np.float64))
        if data.ndim == 1:
            data = data.reshape(-1, 1)
    n_local, n_feat = data.shape
    self.num_data = n_local
    self.num_total_features = n_feat
    self.feature_names = _sanitize_feature_names(
        list(feature_names)) if feature_names else [
        f"Column_{i}" for i in range(n_feat)]

    # --- shard agreement: every rank brings the same feature count (a
    # mismatch would otherwise fail deep inside a collective, or hang it)
    shape = mesh.gather_np(np.array([n_feat, n_local], np.int64))
    check(int(shape[:, 0].min()) == int(shape[:, 0].max()),
          "distributed shards disagree on feature count: %s" %
          shape[:, 0].tolist())

    # --- local sample, sized by this shard's share of the global budget
    n_global = int(shape[:, 1].sum())
    budget = min(n_global, config.bin_construct_sample_cnt)
    local_cnt = max(1, min(n_local, int(round(
        budget * (n_local / max(1, n_global))))))
    rng = Random(config.data_random_seed + mesh.rank)
    idx = rng.sample(n_local, local_cnt)
    local_sample = data[idx]          # sparse stays sparse until blocked
    if sparse:
        local_sample = local_sample.tocsc()
    counts = mesh.gather_np(np.array([local_cnt], np.int64)).reshape(-1)
    s_global = int(counts.sum())
    Log.info("distributed binning: pooling %d sample rows from %d processes",
             s_global, mesh.size)

    # --- identical mappers everywhere, pooled one block of features at a
    # time so the pooled dense sample never exists whole; each pooled block
    # also feeds the EFB planning sample while it is alive
    cats = set(_resolve_categorical(categorical_feature, self.feature_names,
                                    config))
    fb_cols = max(1, min(n_feat, _POOL_BLOCK_BYTES // max(1, 8 * s_global)))
    sb = efb_rows = None
    if Dataset._efb_config_allows(config, n_feat):
        # planning rows STRIDED over the whole pooled sample (a prefix
        # would be rank 0's rows only, biased for shards that differ)
        efb_rows = np.arange(s_global)[::max(1, -(-s_global // 50_000))]
        sb = np.empty((len(efb_rows), n_feat), np.uint16)
    self.bin_mappers = []
    for f0 in range(0, n_feat, fb_cols):
        f1 = min(n_feat, f0 + fb_cols)
        blk = local_sample[:, f0:f1]
        blk = np.asarray(blk.toarray() if sparse else blk, np.float64)
        pooled = _allgather_block(mesh, np.ascontiguousarray(blk), counts)
        for j in range(f0, f1):
            self.bin_mappers.append(self._find_bin_one(
                j, pooled[:, j - f0], s_global, cats))
            if sb is not None:
                sb[:, j] = self.bin_mappers[j].value_to_bin(
                    pooled[efb_rows, j - f0]).astype(np.uint16)
    self._finalize_used_features()

    # --- EFB layout from the pooled binned sample (deterministic, so
    # identical on every rank)
    if sb is not None and self.used_features:
        self._plan_bundles_from_binned(
            np.ascontiguousarray(sb[:, self.used_features]))
    if sparse:
        # self as the layout reference: the binner adopts the bundles just
        # planned (or none) instead of planning from the local rows, which
        # would differ between ranks
        self._bin_data_sparse(data, self)
    else:
        self._bin_data(data)
        if self.bundles is not None:
            from .efb import build_bundle_matrix
            self.bins = build_bundle_matrix(
                self.bins, self.bundles, self.feat_off, self.bundle_widths)
    if config.linear_tree and not sparse:
        self.raw_data = np.asarray(data, np.float32)

    md = Metadata(n_local)
    self.metadata = md
    for name, val in (("label", label), ("weight", weight), ("group", group),
                      ("init_score", init_score)):
        if val is not None:
            md.set_field(name, val)
    return self
