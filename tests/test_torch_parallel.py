"""PyTorch port, the parallel tree learners in ``lgb.train`` against the
JAX package's, on the CPU.

Two ranks of a ``gloo`` group (one launch for the file: each rank a
process running ``_WORKER``) train ``tree_learner=data|feature|voting``
on the same full data; each rank keeps its block of rows or feature
columns.  Both ranks must write the same model text, whose structure
(``split_feature``, ``threshold``, ``left_child``, ``right_child``,
``leaf_count``) is the JAX package's with the same learner on a 2-device
mesh (``mesh_shape=[2]``, the conftest's virtual CPU devices) and the
port's serial model's, with predictions within 5e-6 of the JAX
package's.  The data is the JAX package's test data
(tests/test_parallel.py: n = 1001 avoids a near-tie gain that the
learners' summation order may flip).  In-process cases: the voting
proposal's per-feature gains against the JAX package's, ``set_network``'s
machine-list rules against the JAX package's, a parallel learner without
a process group (serial, with a warning), a ``mesh_shape`` that is not the
world size.  The JAX models are trained beside the ranks, in helper
processes that import this directory's conftest (``JaxRefs``): JAX traces
and compiles each configuration anew, several seconds apiece, so one after
another in the test process they would take most of a minute.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightgbm_tpu_torch as lgt

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
STRUCT = ("split_feature=", "threshold=", "left_child=", "right_child=",
          "leaf_count=")
LEARNERS = ("data", "feature", "voting")


class Ranks:
    """``world`` rank processes of one script over ``gloo`` on localhost,
    each with ``OMP_NUM_THREADS=1``; ``wait()`` joins them under a hard
    timeout (a hang fails the test, and every rank is killed)."""

    def __init__(self, out_dir, src: str, world: int, timeout: int = 120):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        script = os.path.join(str(out_dir), "worker.py")
        with open(script, "w") as fh:
            fh.write(src)
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        self.out_dir = str(out_dir)
        self.timeout = timeout
        self.procs = [subprocess.Popen(
            [sys.executable, script, str(r), str(world), str(port),
             self.out_dir], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        self._outs = None

    def wait(self):
        if self._outs is None:
            try:
                self._outs = [p.communicate(timeout=self.timeout)[0]
                              for p in self.procs]
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
            for r, (p, out) in enumerate(zip(self.procs, self._outs)):
                assert p.returncode == 0, f"rank {r} failed:\n{out}"
        return self._outs

    def text(self, name: str) -> str:
        self.wait()
        with open(os.path.join(self.out_dir, name)) as fh:
            return fh.read()


_REF_SCRIPT = r"""
import json, os, sys
import numpy as np
tests, out, jobs = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
sys.path[:0] = [tests, os.path.dirname(tests)]
import conftest  # JAX on the CPU, the virtual devices mesh_shape takes
import lightgbm_tpu as lgb
exec(open(os.path.join(out, "setup.py")).read())
for name, (expr, iters) in jobs.items():
    booster, X = eval(expr)
    with open(os.path.join(out, name + ".txt"), "w") as fh:
        fh.write(booster.model_to_string())
    np.save(os.path.join(out, name + ".npy"),
            np.stack([booster.predict(X, num_iteration=k)
                      for k in iters or [None]]))
"""


class JaxRefs:
    """The JAX package's reference models, trained in ``procs`` helper
    processes started at once (beside the ranks).  ``setup`` is source
    that defines what the jobs call (``lgb`` is the JAX package); ``jobs``
    maps a name to ``(expression, iterations)``: the expression gives
    ``(booster, X)``, and ``get(name)`` returns the booster's model text
    and its predictions on ``X`` at each ``num_iteration`` of
    ``iterations`` (None: every tree), stacked."""

    def __init__(self, out_dir, setup: str, jobs: dict, procs: int,
                 timeout: int = 240):
        self.out_dir = str(out_dir)
        self.timeout = timeout
        with open(os.path.join(self.out_dir, "setup.py"), "w") as fh:
            fh.write(setup)
        script = os.path.join(self.out_dir, "refs.py")
        with open(script, "w") as fh:
            fh.write(_REF_SCRIPT)
        names = list(jobs)
        shares = [{n: jobs[n] for n in names[i::procs]} for i in range(procs)]
        self.procs = [subprocess.Popen(
            [sys.executable, script, TESTS, self.out_dir, json.dumps(share)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for share in shares if share]
        self._outs = None

    def get(self, name: str):
        if self._outs is None:
            try:
                self._outs = [p.communicate(timeout=self.timeout)[0]
                              for p in self.procs]
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
        for p, out in zip(self.procs, self._outs):
            assert p.returncode == 0, f"JAX reference failed:\n{out}"
        with open(os.path.join(self.out_dir, name + ".txt")) as fh:
            text = fh.read()
        return text, np.load(os.path.join(self.out_dir, name + ".npy"))


# the data and parameters, the same in the test process, the ranks and the
# JAX reference processes
_COMMON = r"""
import numpy as np


def api_data(n, f=8, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] + 0.5 * X[:, 1] ** 2 + 0.3 * rng.normal(size=n) > 0.3)
    return X, y.astype(np.float64)


def params(tl="serial", **extra):
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
         "max_bin": 63, "verbose": -1, "tree_learner": tl, "seed": 7}
    p.update(extra)
    return p
"""
exec(_COMMON)

# the rank script: imports only the port
_WORKER = _COMMON + r"""
import json, sys
import torch
torch.set_num_threads(1)
rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.parallel import (default_mesh, free_network,
                                         init_distributed, mesh_2d)
init_distributed(f"127.0.0.1:{port}", world, rank, timeout_secs=60,
                 backend="gloo")
assert "jax" not in sys.modules


def train(tl, X, y, rounds=5, **extra):
    p = params(tl, **extra)
    return lgt.train(p, lgt.Dataset(X, label=y, params=p), rounds,
                     device="cpu")


def save(name, booster):
    with open(f"{out}/{name}_{rank}.txt", "w") as fh:
        fh.write(booster.model_to_string())


X, y = api_data(1001)
for tl in ("data", "feature", "voting"):
    save(tl, train(tl, X, y))
# the data learner's reduce-scatter search (the sequential grower)
save("data_serial", train("data", X, y, tree_grower="serial"))
# u16 bins: each rank's block of rows or columns
for tl in ("data", "feature"):
    save(f"{tl}_u16", train(tl, X, y, rounds=3, max_bin=300))
X2, y2 = api_data(999)
save("bag", train("data", X2, y2, bagging_fraction=0.7, bagging_freq=1,
                  bagging_seed=11))

res = {}
b = train("voting", X, y, rounds=2)
b.reset_parameter({"num_leaves": 7})
res["reset_mode"] = b._gbdt._grower_cfg.parallel_mode
b.update()
res["reset_trees"] = b.num_trees()

mesh = default_mesh()
t = torch.tensor([rank + 1.0, 10.0 * (rank + 1)])
res["sum"] = mesh.all_reduce(t).tolist()
res["max"] = mesh.all_reduce(t, "max").tolist()
res["min"] = mesh.all_reduce(t, "min").tolist()
res["scatter"] = mesh.reduce_scatter(torch.arange(4.0) * (rank + 1)).tolist()
res["gather"] = mesh.all_gather(torch.tensor([rank, 7])).tolist()
res["bcast"] = mesh.broadcast(torch.tensor([rank + 5]), 1).tolist()
res["calls"] = mesh.stats["calls"]
grid = mesh_2d(1, world)
res["grid"] = [grid.feature.rank, grid.feature.size, grid.data.size,
               grid.feature.all_reduce(torch.tensor([rank + 1])).tolist()]
with open(f"{out}/res_{rank}.json", "w") as fh:
    json.dump(res, fh)
free_network()
"""


# each learner on a 2-device JAX mesh, the shard count of the two ranks
_REF_SETUP = _COMMON + r"""


def jax_train(tl):
    X, y = api_data(1001)
    p = params(tl, mesh_shape=[2])
    return lgb.train(p, lgb.Dataset(X, label=y, params=p),
                     num_boost_round=5), X
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return Ranks(tmp_path_factory.mktemp("parallel"), _WORKER, 2)


@pytest.fixture(scope="module")
def refs(tmp_path_factory, ranks):
    return JaxRefs(tmp_path_factory.mktemp("refs"), _REF_SETUP,
                   {tl: (f"jax_train({tl!r})", None) for tl in LEARNERS},
                   procs=len(LEARNERS))


@pytest.fixture(scope="module", autouse=True)
def _launch(ranks, refs):
    """Start the ranks and the JAX references before the module's first
    test: the in-process tests, which come first, run beside them."""


def _port_train(X, y, rounds=5, **extra):
    p = params(**extra)
    return lgt.train(p, lgt.Dataset(X, label=y, params=p), rounds,
                     device="cpu")


def structure(text, trees=None):
    """The structure lines of the model text's trees (its first ``trees``
    trees)."""
    if trees is not None:
        text = text.split(f"\nTree={trees}\n")[0]
    return [line for line in text.splitlines() if line.startswith(STRUCT)]


def _rank_model(ranks, name):
    """Both ranks' model text of ``name`` (equal, byte for byte)."""
    texts = [ranks.text(f"{name}_{r}.txt") for r in range(2)]
    assert texts[0] == texts[1]
    return texts[0]


def test_per_feature_gains_match_jax():
    from lightgbm_tpu.ops import split as jsplit
    from lightgbm_tpu_torch.ops import split as tsplit
    rng = np.random.default_rng(3)
    f, b = 6, 16
    hist = np.zeros((f, b, 3), np.float32)
    hist[..., 0] = rng.normal(size=(f, b))
    hist[..., 1] = rng.uniform(0.5, 2.0, size=(f, b))
    hist[..., 2] = rng.integers(1, 30, size=(f, b))
    nb = np.array([16, 12, 16, 9, 16, 5], np.int32)
    for i in range(f):
        hist[i, nb[i]:] = 0.0
    nan = np.array([-1, 11, -1, -1, 15, -1], np.int32)
    tot = hist[0].sum(0)
    fmask = np.array([1, 1, 0, 1, 1, 1], np.float32)
    mono = np.array([0, 1, 0, -1, 0, 0], np.int32)
    sp = dict(lambda_l1=0.1, lambda_l2=1.0, min_data_in_leaf=5,
              min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0,
              max_delta_step=0.0, path_smooth=0.0, cat_smooth=10.0,
              cat_l2=10.0, max_cat_to_onehot=4)
    pj = jsplit.SplitParams(**sp)
    pt = tsplit.SplitParams(**sp)
    want = np.asarray(jsplit.per_feature_gains(
        jnp.asarray(hist), jnp.asarray(nb), jnp.asarray(nan),
        jnp.zeros(f, bool), jnp.asarray(mono), tot[0], tot[1], tot[2], pj,
        jnp.asarray(fmask), sorted_cat=False))
    got = tsplit.per_feature_gains(
        torch.as_tensor(hist)[None], torch.as_tensor(nb),
        torch.as_tensor(nan), torch.tensor([tot[0]]), torch.tensor([tot[1]]),
        torch.tensor([tot[2]]), pt, torch.as_tensor(fmask),
        monotone=torch.as_tensor(mono))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert got[2] <= -1e29 and (got > -1e29).sum() >= 3


@pytest.mark.parametrize("machines", [
    ["127.0.0.1:23456", "10.255.255.1:23456"],
    ["10.255.255.1:23001", "localhost:23002"],
    "10.255.255.2,127.0.0.1,10.255.255.3",
    {"127.0.0.1:24000", "10.255.255.9:24001"},
    ["10.255.255.1", "10.255.255.2"],
    ["127.0.0.1:1", "localhost:2"],
])
def test_set_network_resolves_like_jax(monkeypatch, machines):
    """The same coordinator, rank, process count and timeout (minutes to
    seconds) from the same machine list, or the same refusal, with each
    package's init_distributed recording its arguments."""
    from lightgbm_tpu.parallel import mesh as jmesh
    from lightgbm_tpu_torch.parallel import mesh as tmesh
    calls = {}
    for name, mod in (("jax", jmesh), ("torch", tmesh)):
        monkeypatch.setattr(
            mod, "init_distributed",
            lambda name=name, **kw: calls.__setitem__(name, kw))
    outcome = {}
    for name, mod in (("jax", jmesh), ("torch", tmesh)):
        try:
            mod.set_network(machines, local_listen_port=12400,
                            listen_time_out=2)
            kw = calls[name]
            outcome[name] = (kw["coordinator_address"], kw["num_processes"],
                             kw["process_id"], kw["timeout_secs"])
        except ValueError as e:
            outcome[name] = type(e).__name__
    assert outcome["jax"] == outcome["torch"]


def test_parallel_learner_without_group_trains_serially():
    X, y = api_data(1001)
    serial = _port_train(X, y, rounds=3, verbose=0)
    records = []
    lgt.register_log_callback(records.append)
    try:
        par = _port_train(X, y, rounds=3, tree_learner="data", verbose=0)
    finally:
        lgt.register_log_callback(None)
    assert par._gbdt._pmesh is None
    trees = [b.model_to_string().split("parameters:")[0]
             for b in (par, serial)]
    assert trees[0] == trees[1]
    assert any("training serially" in str(m) for m in records)


def test_mesh_shape_must_be_the_world_size():
    X, y = api_data(300)
    with pytest.raises(lgt.LightGBMError, match="world size 1"):
        _port_train(X, y, rounds=1, tree_learner="feature", mesh_shape=[2])


@pytest.mark.parametrize("learner", LEARNERS)
def test_learner_matches_jax_and_serial(ranks, refs, learner):
    X, y = api_data(1001)
    jax_text, jax_pred = refs.get(learner)
    serial = _port_train(X, y)
    text = _rank_model(ranks, learner)
    assert structure(text) == structure(jax_text)
    assert structure(text) == structure(serial.model_to_string())
    par = lgt.Booster(model_str=text, device="cpu")
    np.testing.assert_allclose(par.predict(X), jax_pred[0], rtol=0,
                               atol=5e-6)


def test_data_learner_scatter_search_matches_serial(ranks):
    """``tree_grower=serial`` under the data learner: each split's
    histograms reduce-scattered to a block of features per rank, searched
    there, the winners joined."""
    X, y = api_data(1001)
    serial = _port_train(X, y, tree_grower="serial")
    text = _rank_model(ranks, "data_serial")
    assert structure(text) == structure(serial.model_to_string())
    np.testing.assert_allclose(
        lgt.Booster(model_str=text, device="cpu").predict(X),
        serial.predict(X), rtol=0, atol=5e-6)


@pytest.mark.parametrize("learner", ("data", "feature"))
def test_u16_bins_match_serial(ranks, learner):
    X, y = api_data(1001)
    serial = _port_train(X, y, rounds=3, max_bin=300)
    assert serial._gbdt._dd.bins.dtype == torch.uint16
    text = _rank_model(ranks, f"{learner}_u16")
    assert structure(text) == structure(serial.model_to_string())


def test_bagging_data_matches_serial(ranks):
    """The bag is drawn over the full row order on every rank, then each
    rank keeps its block of it."""
    X, y = api_data(999)
    serial = _port_train(X, y, bagging_fraction=0.7, bagging_freq=1,
                         bagging_seed=11)
    text = _rank_model(ranks, "bag")
    assert structure(text) == structure(serial.model_to_string())
    np.testing.assert_allclose(
        lgt.Booster(model_str=text, device="cpu").predict(X),
        serial.predict(X), rtol=0, atol=5e-6)


def test_collectives_and_reset_parameter(ranks):
    ranks.wait()
    res = [json.load(open(os.path.join(ranks.out_dir, f"res_{r}.json")))
           for r in range(2)]
    for r, d in enumerate(res):
        assert d["reset_mode"] == "voting" and d["reset_trees"] == 3
        assert d["sum"] == [3.0, 30.0]
        assert d["max"] == [2.0, 20.0] and d["min"] == [1.0, 10.0]
        assert d["scatter"] == [[0.0, 3.0], [6.0, 9.0]][r]
        assert d["gather"] == [[0, 7], [1, 7]]
        assert d["bcast"] == [6]
        assert d["calls"] == 6
        assert d["grid"] == [r, 2, 1, [3]]
