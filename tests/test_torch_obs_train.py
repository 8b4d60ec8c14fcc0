"""PyTorch port, the observability plane in the boosting loop, against
the JAX package on the CPU.

The numeric sentinels (``obs_health_check_iters``): the same NaN-gradient
objective makes both packages raise ``DivergenceError`` at iteration 0,
with the same ``numeric_health`` stats, and on finite arrays the port's
sentinel numbers are the JAX package's ``_health_stats_fn``'s.  Telemetry
(``obs_telemetry``): both packages write the same sequence of events for
the same data, the same iterations, leaves and split gains (float32 in
JAX, float64 sums in the port: 1e-4 relative), and with telemetry off no
journal.  Journals go under ``tmp_path``.
"""
import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.models.gbdt import GBDT as JGBDT
from lightgbm_tpu.obs import flight as jflight
from lightgbm_tpu.obs import health as jhealth
from lightgbm_tpu.obs.tracer import get_tracer as jget_tracer
from lightgbm_tpu.utils.timer import global_timer as jtimer
from lightgbm_tpu_torch.models.gbdt import GBDT as TGBDT
from lightgbm_tpu_torch.obs import costs as tcosts
from lightgbm_tpu_torch.obs import flight as tflight
from lightgbm_tpu_torch.obs import health as thealth
from lightgbm_tpu_torch.obs.tracer import get_tracer as tget_tracer
from lightgbm_tpu_torch.utils.timer import global_timer as ttimer

pytestmark = pytest.mark.torch_port

GAIN_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _clean_obs_state():
    """Both packages' health planes, flight recorders and timer bridges
    are process-global: each test starts with an empty cost ledger and
    ends with them clean."""
    tcosts.reset_ledger()
    yield
    for health, flight, tracer, timer in (
            (thealth, tflight, tget_tracer(), ttimer),
            (jhealth, jflight, jget_tracer(), jtimer)):
        health.stop_health_server()
        health._reset_status()
        flight.uninstall()
        timer.detach_tracer()
        tracer.reset()
    tcosts.reset_ledger()


def _events(path):
    return [json.loads(line) for line in open(path)]


def _nan_fobj(preds, train_set):
    n = len(preds)
    return np.full(n, np.nan), np.ones(n)


def test_nan_gradients_raise_divergence_at_the_same_iteration(tmp_path):
    """C11: the port read none of the obs_* knobs and trained on NaN
    gradients; now both packages stop at iteration 0."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2000, 5)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float64)
    base = {"objective": "none", "num_leaves": 7, "verbose": -1,
            "obs_health_check_iters": 1, "obs_telemetry": True}
    got = {}
    for name, pkg, kw in (("jax", lgb, {}), ("torch", lgt,
                                            {"device": "cpu"})):
        journal = tmp_path / f"{name}.jsonl"
        params = dict(base, obs_events_path=str(journal))
        error = (jhealth if name == "jax" else thealth).DivergenceError
        with pytest.raises(error) as ei:
            pkg.train(params, pkg.Dataset(X, label=y), 3, fobj=_nan_fobj,
                      verbose_eval=False, **kw)
        assert ei.value.iteration == 0
        assert "non-finite values in grad" in str(ei.value)
        (rec,) = [e for e in _events(journal)
                  if e["event"] == "numeric_health"]
        got[name] = rec
        assert ei.value.flight_path is not None
    keys = [f"{a}_{s}" for a in ("grad", "hess", "leaf_value")
            for s in ("finite_frac", "max_abs")]
    assert ({k: got["torch"][k] for k in keys}
            == {k: got["jax"][k] for k in keys})
    assert got["torch"]["ok"] is False and got["torch"]["iteration"] == 0
    assert got["torch"]["grad_finite_frac"] == 0.0


def test_sentinel_numbers_equal_the_jax_function():
    rng = np.random.default_rng(7)
    g = rng.normal(size=5000).astype(np.float32) * 3
    h = rng.uniform(0.01, 0.3, 5000).astype(np.float32)
    leaf = rng.normal(size=31).astype(np.float32)
    jstats = JGBDT(JConfig())._health_stats_fn()(g, h, leaf)
    want = np.stack([np.asarray(s) for s in jstats])
    tstats = TGBDT._health_stats(*(torch.as_tensor(a) for a in (g, h, leaf)))
    assert tstats.dtype == torch.float32 and tstats.shape == (3, 2)
    np.testing.assert_array_equal(tstats.numpy(), want)
    # a non-finite entry: the fraction drops, the max skips it
    g[::4] = np.inf
    jstats = JGBDT(JConfig())._health_stats_fn()(g, h, leaf)
    got = TGBDT._health_stats(*(torch.as_tensor(a) for a in (g, h, leaf)))
    np.testing.assert_array_equal(got.numpy()[0], np.asarray(jstats[0]))
    assert got[0, 0] == 0.75


def _tree_events(path):
    return [(e["iteration"], e["num_leaves"], e["split_gain"])
            for e in _events(path) if e["event"] == "train_tree"]


def test_telemetry_events_match_jax(tmp_path):
    rng = np.random.default_rng(11)
    X = rng.normal(size=(10_000, 28)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2]
         + 0.5 * rng.normal(size=10_000) > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 31, "verbose": -1,
              "obs_telemetry": True}
    paths = {}
    for name, pkg, kw in (("jax", lgb, {}), ("torch", lgt,
                                            {"device": "cpu"})):
        paths[name] = tmp_path / f"{name}.jsonl"
        bst = pkg.train(dict(params, obs_events_path=str(paths[name])),
                        pkg.Dataset(X, label=y), 5, verbose_eval=False, **kw)
        bst._gbdt.models                        # drain the pending trees
    ev = {n: _events(p) for n, p in paths.items()}
    assert ([e["event"] for e in ev["torch"]]
            == [e["event"] for e in ev["jax"]])
    assert [e["event"] for e in ev["torch"]].count("train_iter") == 5
    assert ([e["iteration"] for e in ev["torch"]]
            == [e["iteration"] for e in ev["jax"]])
    for e in ev["torch"]:
        if e["event"] == "train_iter":
            assert e["trees"] == 1
            assert set(e["phase_seconds"]) == {"gradients", "grow_tree",
                                               "update_score"}
            assert "device_memory" not in e          # the CPU has none
    tt, jt = _tree_events(paths["torch"]), _tree_events(paths["jax"])
    assert len(tt) == len(jt) == 5
    for (ti, tl, tg), (ji, jl, jg) in zip(tt, jt):
        assert (ti, tl, tg["splits"]) == (ji, jl, jg["splits"])
        for key in ("max", "total"):
            assert tg[key] == pytest.approx(jg[key], rel=GAIN_RTOL)
    # one run id a journal, and the ledger's grow record was observed
    assert len({e["run_id"] for e in ev["torch"]}) == 1
    (row,) = tcosts.get_ledger().rooflines()
    assert row["program"] == "train.grow_tree" and row["calls"] == 5


def test_telemetry_off_writes_no_journal(tmp_path, monkeypatch):
    monkeypatch.setenv("WATCHER_PERF_LOG", str(tmp_path / "default.jsonl"))
    rng = np.random.default_rng(2)
    X = rng.normal(size=(1000, 4)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float64)
    path = tmp_path / "off.jsonl"
    bst = lgt.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
                     "obs_events_path": str(path)},
                    lgt.Dataset(X, label=y), 3, verbose_eval=False,
                    device="cpu")
    assert bst._gbdt._obs is None
    bst._gbdt.models
    assert list(tmp_path.iterdir()) == []
