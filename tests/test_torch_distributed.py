"""PyTorch port, multi-process training (``parallel.train_distributed``,
``io.distributed.distributed_dataset``, the distributed estimators)
against the JAX package on the CPU.

Each rank holds only its partition of the rows; the ranks pool their
binning samples, agree on the mappers and train one model.  The bar is the
JAX package's multi-process tests' (tests/test_distributed.py, which skip
where its CPU collectives are missing): every rank writes the same model
text, and the model is ``lightgbm_tpu.train``'s on the concatenated rows,
in structure, with predictions within 5e-6.  One launch of two ``gloo``
ranks runs binary (unequal shards), weighted multiclass, GOSS, lambdarank
with a pooled NDCG and early stopping, a pooled AUC over unequal
validation shards, EFB bundles, ``DistLGBMClassifier``, the mappers of a
sample smaller than the data and the streamed plan's refusal; one launch
of three ranks trains with bagging over unequal shards, one rank holding
forty rows.  The JAX models train in helper processes beside the ranks
(``test_torch_parallel.JaxRefs``).
"""
import json
import os

import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.utils.random_gen import Random as JRandom
from test_torch_parallel import JaxRefs, Ranks, structure

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

# the data, made the same way in the test process and in each rank
_DATA = r"""
import numpy as np

P = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
     "max_bin": 63, "verbose": -1, "seed": 5}


def binary_data():
    rng = np.random.default_rng(21)
    X = rng.normal(size=(3000, 8))
    y = (X[:, 0] + 0.5 * X[:, 1] ** 2 - 1.0 * (X[:, 2] > 0.5)
         + rng.logistic(size=3000) * 0.3 > 0).astype(np.float32)
    return X, y, [0, 1400, 3000]


def multiclass_data():
    rng = np.random.default_rng(31)
    X = rng.normal(size=(2400, 6))
    w = rng.uniform(0.5, 1.5, 2400).astype(np.float32)
    # noisy classes: a class that is a step function of the features
    # leaves only zero-gain (tied) splits after the first few
    z = X[:, :2] + 0.4 * rng.logistic(size=(2400, 2))
    y = (z[:, 0] > 0.4).astype(int) + (z[:, 1] > 0.2).astype(int)
    return X, y, w, [0, 1000, 2400]


def goss_data():
    rng = np.random.default_rng(78)
    X = rng.normal(size=(3000, 8))
    y = (X[:, 0] - 0.7 * X[:, 2] + rng.logistic(size=3000) * 0.3 > 0
         ).astype(np.float32)
    return X, y, [0, 1500, 3000]


def rank_data():
    rng = np.random.default_rng(79)
    nq, qsize = 60, 25
    X = rng.normal(size=(nq * qsize, 6))
    rel = np.clip((X[:, 0] + 0.8 * X[:, 1]
                   + rng.normal(size=nq * qsize) * 0.4) * 1.2 + 1.5, 0, 4)
    return X, np.floor(rel).astype(np.float32), nq, qsize


def auc_data():
    rng = np.random.default_rng(80)
    X = rng.normal(size=(2400, 6))
    y = (X[:, 0] + 0.6 * X[:, 1] + rng.logistic(size=2400) * 0.5 > 0
         ).astype(np.float32)
    return X, y, [0, 1200, 2400], [300, 200]


def efb_data():
    rng = np.random.default_rng(83)
    n, fd, fs = 3000, 4, 6
    X = np.zeros((n, fd + fs), np.float64)
    X[:, :fd] = rng.normal(size=(n, fd))
    cat = rng.integers(-1, fs, size=n)          # -1: an all-zero row
    rows = np.arange(n)[cat >= 0]
    X[rows, fd + cat[cat >= 0]] = rng.uniform(0.5, 2.0, size=len(rows))
    y = (X[:, 0] + 0.8 * (cat == 2) - 0.6 * (cat == 4)
         + rng.logistic(size=n) * 0.4 > 0).astype(np.float32)
    return X, y, [0, 1500, 3000]


def three_data():
    rng = np.random.default_rng(91)
    X = rng.normal(size=(3000, 7))
    y = (X[:, 0] - 0.8 * X[:, 1] + rng.logistic(size=3000) * 0.4 > 0
         ).astype(np.float32)
    return X, y, [0, 1460, 1500, 3000]


RANK_P = dict(P, objective="lambdarank", min_data_in_leaf=3,
              metric=["ndcg"], eval_at=[5],
              label_gain=list(np.power(2.0, np.arange(32)) - 1))
GOSS_P = dict(P, boosting="goss", top_rate=0.25, other_rate=0.15,
              bagging_seed=3)
BAG_P = dict(P, bagging_fraction=0.7, bagging_freq=1, bagging_seed=11)
SAMPLE_CFG = {"max_bin": 63, "min_data_in_bin": 1,
              "bin_construct_sample_cnt": 700}
"""
exec(_DATA)

_WORKER = _DATA + r"""
import json, sys
import torch
torch.set_num_threads(1)
rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.parallel import (DistLGBMClassifier,
                                         distributed_dataset, free_network,
                                         init_distributed, train_distributed)
init_distributed(f"127.0.0.1:{port}", world, rank, timeout_secs=60,
                 backend="gloo")
assert "jax" not in sys.modules
res = {}


def save(name, booster):
    with open(f"{out}/{name}_{rank}.txt", "w") as fh:
        fh.write(booster.model_to_string())


def part(cuts):
    return slice(cuts[rank], cuts[rank + 1])


if world == 3:
    X, y, cuts = three_data()
    save("three", train_distributed(BAG_P, X[part(cuts)], y[part(cuts)],
                                    num_boost_round=5, device="cpu"))
else:
    X, y, cuts = binary_data()
    save("binary", train_distributed(P, X[part(cuts)], y[part(cuts)],
                                     num_boost_round=5, device="cpu"))

    X, y, w, cuts = multiclass_data()
    save("multiclass", train_distributed(
        dict(P, objective="multiclass", num_class=3, seed=2),
        X[part(cuts)], y[part(cuts)], num_boost_round=4,
        weight=w[part(cuts)], device="cpu"))

    X, y, cuts = goss_data()
    save("goss", train_distributed(GOSS_P, X[part(cuts)], y[part(cuts)],
                                   num_boost_round=5, device="cpu"))

    X, y, nq, qsize = rank_data()
    half = nq // 2 * qsize
    lo, hi = (0, half) if rank == 0 else (half, nq * qsize)
    vrows = 10 * qsize
    ev = {}
    bst = train_distributed(
        RANK_P, X[lo:hi], y[lo:hi], num_boost_round=6,
        group=np.full(nq // 2, qsize, np.int64),
        valid_data=(X[hi - vrows:hi], y[hi - vrows:hi]),
        valid_group=np.full(10, qsize, np.int64), early_stopping_rounds=2,
        evals_result=ev, device="cpu")
    save("rank", bst)
    res["rank"] = [ev["valid"], bst.best_iteration]

    X, y, cuts, vsz = auc_data()
    hi = cuts[rank + 1]
    ev = {}
    save("auc", train_distributed(
        dict(P, metric=["auc"]), X[part(cuts)], y[part(cuts)],
        num_boost_round=5, valid_data=(X[hi - vsz[rank]:hi],
                                       y[hi - vsz[rank]:hi]),
        evals_result=ev, device="cpu"))
    res["auc"] = ev["valid"]["auc"]

    X, y, cuts = efb_data()
    ds = distributed_dataset(X[part(cuts)], Config.from_params(dict(P)),
                             label=y[part(cuts)])
    res["bundles"] = len(ds.bundles)
    save("efb", train_distributed(P, X[part(cuts)], y[part(cuts)],
                                  num_boost_round=5, device="cpu"))

    X, y, cuts = binary_data()
    clf = DistLGBMClassifier(n_estimators=5, num_leaves=15,
                             min_child_samples=5, max_bin=63, verbose=-1,
                             random_state=5, device="cpu")
    clf.fit(X[part(cuts)], y[part(cuts)].astype(int) + 3)
    save("classifier", clf.booster_)
    res["classes"] = clf.classes_.tolist()

    ds = distributed_dataset(X[part(cuts)], Config.from_params(SAMPLE_CFG),
                             label=y[part(cuts)])
    res["mappers"] = [m.to_state() for m in ds.bin_mappers]

    try:
        train_distributed(dict(P, stream_rows=256), X[part(cuts)],
                          y[part(cuts)], num_boost_round=1, device="cpu")
        res["stream"] = "trained"
    except lgt.NotPortedError as e:
        res["stream"] = str(e)
with open(f"{out}/res_{rank}.json", "w") as fh:
    json.dump(res, fh)
free_network()
"""


# lightgbm_tpu.train on the concatenated rows of each case
_REF_SETUP = _DATA + r"""


def jax_single(params, X, y, rounds, **ds_kw):
    return lgb.train(dict(params), lgb.Dataset(X, label=y, params=dict(params),
                                               **ds_kw),
                     num_boost_round=rounds), X


def multiclass_single():
    X, y, w, _ = multiclass_data()
    return jax_single(dict(P, objective="multiclass", num_class=3, seed=2),
                      X, y, 4, weight=w)


def rank_single():
    X, y, nq, qsize = rank_data()
    return jax_single(RANK_P, X, y, 6, group=np.full(nq, qsize, np.int64))


def efb_single():
    booster, X = jax_single(P, *efb_data()[:2], 5)
    assert booster._gbdt.train_data.bundles is not None
    return booster, X
"""
_REFS = {
    "binary": ("jax_single(P, *binary_data()[:2], 5)", None),
    "multiclass": ("multiclass_single()", None),
    "goss": ("jax_single(GOSS_P, *goss_data()[:2], 5)", None),
    # early stopping picks the rank run's length: every length of six
    "rank": ("rank_single()", list(range(1, 7))),
    "efb": ("efb_single()", None),
    "three": ("jax_single(BAG_P, *three_data()[:2], 5)", None),
}


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Both launches and the JAX references, started together."""
    out = {w: Ranks(tmp_path_factory.mktemp(f"dist{w}"), _WORKER, w)
           for w in (2, 3)}
    out["refs"] = JaxRefs(tmp_path_factory.mktemp("refs"), _REF_SETUP,
                          _REFS, procs=3)
    return out


@pytest.fixture
def two(launches):
    return launches[2]


@pytest.fixture
def three(launches):
    return launches[3]


@pytest.fixture
def refs(launches):
    return launches["refs"]


def _rank_model(ranks, name, world=2):
    texts = [ranks.text(f"{name}_{r}.txt") for r in range(world)]
    assert all(t == texts[0] for t in texts[1:])
    import lightgbm_tpu_torch as lgt
    return texts[0], lgt.Booster(model_str=texts[0], device="cpu")


def _res(ranks, world=2):
    ranks.wait()
    return [json.load(open(os.path.join(ranks.out_dir, f"res_{r}.json")))
            for r in range(world)]


def _assert_single(text, dist, refs, name, X, trees=None):
    """``dist``'s structure is the JAX reference ``name``'s (its first
    ``trees`` trees), its predictions within 5e-6 of the reference's."""
    single_text, single_pred = refs.get(name)
    assert structure(text) == structure(single_text, trees)
    np.testing.assert_allclose(dist.predict(X),
                               single_pred[(trees or 0) - 1], rtol=0,
                               atol=5e-6)


def test_binary_unequal_shards_match_single(two, refs):
    X = binary_data()[0]
    _assert_single(*_rank_model(two, "binary"), refs, "binary", X)


def test_multiclass_weighted_matches_single(two, refs):
    X = multiclass_data()[0]
    text, dist = _rank_model(two, "multiclass")
    assert dist.num_trees() == 12
    _assert_single(text, dist, refs, "multiclass", X)


def test_goss_matches_single(two, refs):
    X = goss_data()[0]
    _assert_single(*_rank_model(two, "goss"), refs, "goss", X)


def test_lambdarank_pooled_ndcg_and_early_stopping(two, refs):
    from lightgbm_tpu.io.dataset import Metadata
    from lightgbm_tpu.metric.rank import NDCGMetric
    X, y, nq, qsize = rank_data()
    text, dist = _rank_model(two, "rank")
    res = _res(two)
    assert res[0]["rank"] == res[1]["rank"]
    ev, best = res[0]["rank"]
    key = [k for k in ev if "ndcg" in k][0]
    assert 1 <= best <= len(ev[key]) <= 6
    _assert_single(text, dist, refs, "rank", X, trees=dist.num_trees())
    # the pooled NDCG@5 is the single-process NDCG over the union of the
    # two validation shards (each rank's last 10 queries)
    keep_q = list(range(nq // 2 - 10, nq // 2)) + list(range(nq - 10, nq))
    rows = np.concatenate([np.arange(q * qsize, (q + 1) * qsize)
                           for q in keep_q])
    md = Metadata(len(rows))
    md.set_field("label", y[rows])
    md.set_field("group", np.full(20, qsize, np.int64))
    m = NDCGMetric(JConfig.from_params({"eval_at": [5]}))
    m.init(md, len(rows))
    (_, expect, _), = m.eval(dist.predict(X[rows], raw_score=True))
    assert abs(ev[key][-1] - expect) < 1e-6


def test_pooled_auc_exact(two):
    from sklearn.metrics import roc_auc_score
    X, y, cuts, vsz = auc_data()
    res = _res(two)
    assert res[0]["auc"] == res[1]["auc"]
    _, dist = _rank_model(two, "auc")
    rows = np.concatenate([np.arange(cuts[1] - vsz[0], cuts[1]),
                           np.arange(cuts[2] - vsz[1], cuts[2])])
    expect = roc_auc_score(y[rows], dist.predict(X[rows]))
    assert abs(res[0]["auc"][-1] - expect) < 1e-9


def test_efb_matches_single(two, refs):
    X, y, _ = efb_data()
    res = _res(two)
    assert res[0]["bundles"] == res[1]["bundles"] < X.shape[1]
    _assert_single(*_rank_model(two, "efb"), refs, "efb", X)


def test_dist_classifier_matches_single(two, refs):
    """``DistLGBMClassifier`` with the binary case's parameters (labels 3
    and 4) trains the binary case's single-process model."""
    X = binary_data()[0]
    res = _res(two)
    assert res[0]["classes"] == res[1]["classes"] == [3, 4]
    _assert_single(*_rank_model(two, "classifier"), refs, "binary", X)


def test_distributed_dataset_mappers_match_pooled_sample(two):
    """A sample smaller than the data: each rank draws its share by
    ``Random(data_random_seed + rank)``; the mappers are the JAX package's
    ``_find_bin_one`` over the pooled sample."""
    X, _, cuts = binary_data()
    cfg = JConfig.from_params(SAMPLE_CFG)
    n = X.shape[0]
    budget = min(n, cfg.bin_construct_sample_cnt)
    parts = []
    for r in range(2):
        local = X[cuts[r]:cuts[r + 1]]
        cnt = max(1, min(len(local), int(round(budget * len(local) / n))))
        parts.append(local[JRandom(cfg.data_random_seed + r).sample(
            len(local), cnt)])
    pooled = np.concatenate(parts)
    assert len(pooled) < n
    ref = JDataset(cfg)
    want = [ref._find_bin_one(j, pooled[:, j], len(pooled), set()).to_state()
            for j in range(X.shape[1])]
    res = _res(two)
    assert res[0]["mappers"] == res[1]["mappers"]
    assert json.dumps(res[0]["mappers"], sort_keys=True) == json.dumps(
        json.loads(json.dumps(want)), sort_keys=True)


def test_streamed_rank_plan_is_not_ported(two):
    res = _res(two)
    assert all("A21b" in r["stream"] for r in res)


def test_three_ranks_unequal_shards_with_bagging(three, refs):
    X, y, cuts = three_data()
    assert cuts[2] - cuts[1] == 40
    _assert_single(*_rank_model(three, "three", world=3), refs, "three", X)
