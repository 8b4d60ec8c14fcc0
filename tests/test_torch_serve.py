"""PyTorch port, serving (``lightgbm_tpu_torch/serve``) on the CPU.

The cases of ``tests/test_serve.py`` against the port's own artifact: it
is bit-exact against the port's ``GBDT.predict`` on its device path
(``pred_device=device``) at and around every bucket, pads and chunks
without preparing a new bucket, saves and loads, serves multiclass,
refuses a wrong width and passes its parity gate.  The micro-batcher
coalesces, sheds, closes, and survives a worker error or crash; the
``Predictor`` routes, hot-swaps with zero dropped requests, rolls a failed
gate back and refuses a shape-changing swap.  Against the JAX package:
one port model's text served by both packages' artifacts (buckets 64 and
256) gives raw scores within 1e-6 relative and transformed scores within
1e-6 absolute (the JAX package traverses and sums in float32 under XLA,
the port in float32 under PyTorch; the two agree to float32 rounding).
On the card, the graph capture is held bit-exact against eager by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""
import threading
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.serve import (MicroBatcher, Predictor,
                                      PredictorArtifact, QueueSaturatedError)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

BUCKETS = (64, 256)
RAW_RTOL = 1e-6      # port artifact vs JAX artifact, raw scores
OUT_ATOL = 1e-6      # and transformed scores


@pytest.fixture(scope="module")
def serve_data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(600, 8))
    y = (X[:, 0] + np.sin(X[:, 1]) + 0.2 * rng.normal(size=600) > 0
         ).astype(np.float64)
    return X, y


def _train(X, y, rounds=8, **extra):
    # pred_device=device: the booster's own predict runs the stacked
    # traversal the artifact captures, so parity can be bit-exact
    p = {"objective": "binary", "num_leaves": 7, "verbose": -1,
         "pred_device": "device", "serve_buckets": list(BUCKETS), **extra}
    return lgt.train(p, lgt.Dataset(X, label=y, params=p), rounds,
                     device="cpu")


def _freeze(model, **kw):
    return PredictorArtifact.freeze(model, device="cpu", **kw)


@pytest.fixture(scope="module")
def booster(serve_data):
    return _train(*serve_data)


@pytest.fixture(scope="module")
def artifact(booster):
    return _freeze(booster)


@pytest.fixture(scope="module")
def artifact_b(serve_data):
    """A different second model (only the round count differs)."""
    return _freeze(_train(*serve_data, rounds=16))


# ---------------------------------------------------------------------------
# artifact: parity, padding, chunking, capture accounting
def test_artifact_bit_exact_vs_gbdt_predict(serve_data, booster, artifact):
    X, _ = serve_data
    for n in (1, 63, 64, 65, 256, 600):     # below/at/above every bucket
        got = artifact.predict(X[:n])
        exp = np.asarray(booster.predict(X[:n]), np.float64)
        assert got.shape == exp.shape
        assert np.array_equal(got, exp), f"rows={n}"
    raw = artifact.predict(X[:100], raw_score=True)
    raw_exp = np.asarray(booster.predict(X[:100], raw_score=True), np.float64)
    assert np.array_equal(raw, raw_exp)


def test_artifact_padding_and_captures(serve_data, artifact):
    # a padded request (1 row in a 64-row bucket) equals the same row
    # inside a full bucket: pad rows are traversed but row-independent;
    # every size is served by the same finite bucket set
    X, _ = serve_data
    full = artifact.predict(X[:64])
    for i in (0, 7, 63):
        assert np.array_equal(artifact.predict(X[i:i + 1]), full[i:i + 1])
    assert artifact.predict(np.zeros((0, X.shape[1]))).shape == (0,)
    assert artifact.compile_count == len(BUCKETS)
    for n in (1, 3, 64, 100, 300, 600):
        artifact.predict(X[:n])
    assert artifact.compile_count == len(BUCKETS)


def test_artifact_save_load_roundtrip(tmp_path, serve_data, artifact):
    X, _ = serve_data
    path = str(tmp_path / "artifact.txt")
    artifact.save(path)
    loaded = PredictorArtifact.load(path, device="cpu")
    assert loaded.buckets == artifact.buckets
    assert loaded.name == artifact.name
    assert loaded.compile_count == len(BUCKETS)
    assert np.array_equal(loaded.predict(X), artifact.predict(X))
    assert loaded.compile_count == len(BUCKETS)
    # the artifact file is still a plain model file for both packages
    assert lgt.Booster(model_file=path, device="cpu").num_trees() == \
        artifact.num_trees
    assert lgb.Booster(model_file=path).num_trees() == artifact.num_trees


def test_artifact_multiclass_parity(serve_data):
    X, _ = serve_data
    y3 = np.digitize(X[:, 0] + X[:, 1], [-0.5, 0.5]).astype(np.float64)
    p = {"objective": "multiclass", "num_class": 3, "num_leaves": 7,
         "verbose": -1, "pred_device": "device"}
    bst = lgt.train(p, lgt.Dataset(X, label=y3, params=p), 3, device="cpu")
    art = _freeze(bst, buckets=[100])
    got = art.predict(X[:77])
    assert np.array_equal(got, np.asarray(bst.predict(X[:77]), np.float64))
    assert np.allclose(got.sum(axis=1), 1.0, rtol=1e-5)


def test_artifact_refusals_and_gate(serve_data, artifact, booster):
    X, _ = serve_data
    with pytest.raises(lgt.LightGBMError, match="features"):
        artifact.predict(np.zeros((4, 3)))
    ok, reason = artifact.parity_check(X[:100])
    assert ok, reason
    # an artifact whose leaf values were scaled fails the gate
    bad = _freeze(booster)
    bad._ens = bad._ens._replace(leaf_value=bad._ens.leaf_value * 2)
    ok, reason = bad.parity_check(X[:100])
    assert not ok and "mismatch" in reason
    # the default device is the card, and there is none here
    with pytest.raises(lgt.NoCudaDeviceError):
        PredictorArtifact.freeze(booster)


def test_artifact_matches_jax_artifact(serve_data, booster):
    """One port model's text through both packages' artifacts."""
    from lightgbm_tpu.serve import PredictorArtifact as JaxArtifact
    X, _ = serve_data
    text = booster.model_to_string()
    ja = JaxArtifact.from_string(text, buckets=list(BUCKETS))
    ta = PredictorArtifact.from_string(text, buckets=list(BUCKETS),
                                       device="cpu")
    for n in (1, 64, 600):
        np.testing.assert_allclose(ta.predict(X[:n], raw_score=True),
                                   ja.predict(X[:n], raw_score=True),
                                   rtol=RAW_RTOL, atol=1e-7)
        np.testing.assert_allclose(ta.predict(X[:n]), ja.predict(X[:n]),
                                   rtol=0, atol=OUT_ATOL)


# ---------------------------------------------------------------------------
# micro-batcher: coalescing, fan-out, shedding, close, failures
def test_batcher_coalesces_and_fans_out(serve_data, artifact):
    X, _ = serve_data
    mb = MicroBatcher(artifact.predict, max_batch_rows=BUCKETS[-1],
                      deadline_ms=30.0, queue_depth=64, name="t",
                      num_features=artifact.num_features)
    try:
        futs = [mb.submit(X[i * 10:(i + 1) * 10]) for i in range(12)]
        outs = [f.result(timeout=30) for f in futs]
        with pytest.raises(lgt.LightGBMError, match="features"):
            mb.submit(X[:2, :3])          # refused at the door
    finally:
        mb.close()
    direct = artifact.predict(X[:120])
    for i, out in enumerate(outs):
        assert np.array_equal(out, direct[i * 10:(i + 1) * 10])
    assert mb.stats["requests"] == 12
    assert mb.stats["batches"] < 12
    assert mb.stats["max_batch_requests"] > 1
    with pytest.raises(lgt.LightGBMError, match="closed"):
        mb.submit(X[:1])


def test_batcher_queue_saturation_sheds(serve_data):
    X, _ = serve_data
    release = threading.Event()

    def slow_predict(xb):
        release.wait(10)
        return np.zeros(xb.shape[0])

    mb = MicroBatcher(slow_predict, max_batch_rows=1, deadline_ms=0.0,
                      queue_depth=2, name="sat")
    try:
        first = mb.submit(X[:1])          # the worker takes it and blocks
        time.sleep(0.1)
        mb.submit(X[:1])
        mb.submit(X[:1])                  # the queue is full
        with pytest.raises(QueueSaturatedError, match="saturated"):
            mb.submit(X[:1])
        assert mb.stats["shed"] == 1
        release.set()
        first.result(timeout=10)
    finally:
        release.set()
        mb.close()
    assert lgt.QueueSaturatedError is QueueSaturatedError


def test_batcher_close_with_full_queue_does_not_block(serve_data):
    X, _ = serve_data
    gate = threading.Event()

    def wedged(xb):
        gate.wait(10)
        return np.zeros(xb.shape[0])

    mb = MicroBatcher(wedged, max_batch_rows=1, deadline_ms=0.0,
                      queue_depth=2, name="wedge")
    first = mb.submit(X[:1])
    time.sleep(0.1)
    pend = [mb.submit(X[:1]), mb.submit(X[:1])]
    t0 = time.monotonic()
    mb.close(timeout=0.2)
    assert time.monotonic() - t0 < 5
    for f in pend:
        with pytest.raises(lgt.LightGBMError, match="closed"):
            f.result(timeout=5)
    gate.set()
    assert first.result(timeout=10).shape == (1,)
    mb._worker.join(5)
    assert not mb._worker.is_alive()


def test_batcher_worker_error_and_crash(serve_data):
    X, _ = serve_data

    def broken(xb):
        raise ValueError("boom")

    mb = MicroBatcher(broken, deadline_ms=0.0, queue_depth=4, name="err")
    try:
        for _ in range(2):        # a per-batch failure: the worker lives on
            with pytest.raises(ValueError, match="boom"):
                mb.submit(X[:2]).result(timeout=10)
    finally:
        mb.close()
    mb = MicroBatcher(lambda xb: np.zeros(xb.shape[0]), deadline_ms=0.0,
                      queue_depth=4, name="crash")

    def bomb(batch):
        raise RuntimeError("hard crash")

    mb._run_batch = bomb
    with pytest.raises(RuntimeError, match="hard crash"):
        mb.submit(X[:1]).result(timeout=10)
    mb._worker.join(5)
    with pytest.raises(lgt.LightGBMError, match="died"):
        mb.submit(X[:1])
    mb.close()


# ---------------------------------------------------------------------------
# server: routing + hot-swap
def test_predictor_routing_and_batching(serve_data, artifact):
    X, _ = serve_data
    srv = Predictor(artifact)
    try:
        assert np.array_equal(srv.predict(X[:10]), artifact.predict(X[:10]))
        with pytest.raises(lgt.LightGBMError, match="unknown model"):
            srv.predict(X[:10], model="nope")
        info = srv.models()["default"]
        assert info["generation"] == 1 and not info["staged"]
    finally:
        srv.close()
    srv = Predictor(artifact, batching=True, deadline_ms=20.0)
    try:
        futs = [srv.submit(X[i:i + 1]) for i in range(20)]
        direct = artifact.predict(X[:20])
        for i, f in enumerate(futs):
            assert np.array_equal(f.result(timeout=30), direct[i:i + 1])
    finally:
        srv.close()


def test_hot_swap_zero_dropped_requests(serve_data, artifact, artifact_b):
    """Requests during a swap all complete, each equal to one of the two
    versions, and requests after swap() returns see the new one."""
    X, _ = serve_data
    exp_a = artifact.predict(X[:32])
    exp_b = artifact_b.predict(X[:32])
    assert not np.array_equal(exp_a, exp_b)
    srv = Predictor(artifact)
    results, errors = [], []
    stop = threading.Event()

    def client():
        while not stop.is_set():
            try:
                results.append(np.asarray(srv.predict(X[:32])))
            except Exception as e:       # any drop/refusal fails the test
                errors.append(e)

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.2)
        srv.stage("default", artifact_b)
        gen = srv.swap("default", parity_X=X[:64])
        after_swap = srv.predict(X[:32])
        time.sleep(0.2)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        srv.close()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert gen == 2
    assert np.array_equal(after_swap, exp_b)
    assert results
    for r in results:
        assert np.array_equal(r, exp_a) or np.array_equal(r, exp_b)


def test_hot_swap_gate_rollback_and_shape_refusal(serve_data, artifact,
                                                  booster):
    X, _ = serve_data
    bad = _freeze(booster)
    bad._ens = bad._ens._replace(leaf_value=bad._ens.leaf_value * 2)
    y3 = np.digitize(X[:, 0], [-0.5, 0.5]).astype(np.float64)
    p = {"objective": "multiclass", "num_class": 3, "num_leaves": 7,
         "verbose": -1}
    mc = _freeze(lgt.train(p, lgt.Dataset(X, label=y3, params=p), 2,
                           device="cpu"), buckets=[64])
    srv = Predictor(artifact)
    try:
        before = srv.predict(X[:16])
        srv.stage("default", bad)          # fails its gate: rolled back
        with pytest.raises(lgt.LightGBMError, match="mismatch"):
            srv.swap("default", parity_X=X[:16])
        assert np.array_equal(srv.predict(X[:16]), before)
        info = srv.models()["default"]
        assert info["generation"] == 1 and not info["staged"]
        srv.stage("default", mc)           # [N] -> [N, K]: refused
        with pytest.raises(lgt.LightGBMError, match="rejected"):
            srv.swap("default")
        assert srv.models()["default"]["generation"] == 1
    finally:
        srv.close()


def test_hot_swap_rollback_restores_previous(serve_data, artifact,
                                             artifact_b):
    X, _ = serve_data
    srv = Predictor(artifact)
    try:
        srv.stage("default", artifact_b)
        srv.swap("default", parity_X=X[:32])
        assert np.array_equal(srv.predict(X[:8]), artifact_b.predict(X[:8]))
        srv.rollback("default")
        assert np.array_equal(srv.predict(X[:8]), artifact.predict(X[:8]))
    finally:
        srv.close()
