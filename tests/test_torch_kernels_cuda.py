"""PyTorch port, the hand-written CUDA kernels on the card.

The kernels have no CPU mode, so every test here needs a CUDA card and
skips without one.  This file imports neither JAX nor the JAX package, so
it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)  Each kernel is held
against its plain PyTorch version on the same CUDA tensors at relative
error ``|a-b|/(|b|+1)`` <= 1e-5: both sum in float64 and round once, so only
the float64 summation order differs.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import histogram as thist

pytestmark = [pytest.mark.torch_port, pytest.mark.cuda]

TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def relerr(a, b):
    return float(((a - b).abs() / (b.abs() + 1.0)).max())


def _rows(rng, n, dev):
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.05, 0.25, n).astype(np.float32)
    m = np.where(rng.random(n) < 0.2, 0.0,
                 np.where(rng.random(n) < 0.3, 2.5, 1.0)).astype(np.float32)
    return [torch.as_tensor(a).to(dev) for a in (g, h, m)]


@pytest.mark.parametrize("n,f,ncols,B", [(50_003, 13, 13, 64),
                                         (20_000, 28, 40, 256)])
def test_hist_full_matches_plain(dev, n, f, ncols, B):
    rng = np.random.default_rng(n)
    bins = torch.as_tensor(rng.integers(0, 256, (n, ncols)).astype(np.uint8)
                           ).to(dev)                  # bins >= B are dropped
    g, h, m = _rows(rng, n, dev)
    with thist.force_plain():
        ref = thist.build_histogram(bins, g, h, m, B, f_limit=f)
    before = thist.launch_counts["hist_full"]
    got = thist.build_histogram(bins, g, h, m, B, f_limit=f)
    torch.cuda.synchronize()
    assert thist.launch_counts["hist_full"] == before + 1
    assert got.shape == (f, B, 3) and got.dtype == torch.float32
    assert relerr(got, ref) <= TOL


def test_hist_leaves_matches_plain(dev):
    rng = np.random.default_rng(7)
    k, BR, f, nc, B = 6, 512, 28, 40, 256
    block_leaf = np.array([4, 0, 2, 4, 1, 5, 0, 2, 1, 4], np.int32)  # 3 empty
    C = block_leaf.size * BR
    comb = torch.as_tensor(rng.integers(0, 256, (C, nc)).astype(np.uint8)
                           ).to(dev)
    g, h, m = _rows(rng, C, dev)
    nan_block = 5
    g[nan_block * BR + 3] = float("nan")
    bl = torch.as_tensor(block_leaf).to(dev)
    with thist.force_plain():
        ref = thist.build_histogram_leaves(comb, g, h, m, bl, k, B,
                                           block_rows=BR, f_limit=f)
    before = thist.launch_counts["hist_leaves"]
    got = thist.build_histogram_leaves(comb, g, h, m, bl, k, B,
                                       block_rows=BR, f_limit=f)
    torch.cuda.synchronize()
    assert thist.launch_counts["hist_leaves"] == before + 1
    assert got.shape == (k, f, B, 3)
    assert bool((got[3] == 0).all())                      # empty slot
    nan_slot = int(block_leaf[nan_block])
    assert bool(torch.isnan(got[nan_slot]).any())
    others = [s for s in range(k) if s != nan_slot]
    assert bool(torch.isfinite(got[others]).all())        # NaN stays put
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    fin = torch.isfinite(ref)
    assert relerr(got[fin], ref[fin]) <= TOL


def test_wrappers_check_their_inputs(dev):
    bins = torch.zeros(1024, 4, dtype=torch.uint8, device=dev)
    z = torch.zeros(1024, device=dev)
    with pytest.raises(ValueError, match="uint8"):
        thist.hist_full(bins.float(), z, z, z, 16)
    with pytest.raises(ValueError, match="grad"):
        thist.hist_full(bins, z.double(), z, z, 16)
    with pytest.raises(ValueError, match="block_leaf"):
        thist.hist_leaves(bins, z, z, z, torch.zeros(2, device=dev), 2, 16,
                          block_rows=512)
    with pytest.raises(ValueError, match="multiple"):
        thist.hist_leaves(bins[:1000], z[:1000], z[:1000], z[:1000],
                          torch.zeros(2, dtype=torch.int32, device=dev), 2,
                          16, block_rows=512)


def test_training_launches_both_kernels_and_matches_plain(dev):
    """A small binary run through the kernels grows the same trees as the
    same run under force_plain() on the card."""
    import lightgbm_tpu_torch as lgt
    rng = np.random.default_rng(0)
    X = rng.normal(size=(20_000, 10)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] * X[:, 2] + 0.5 * rng.normal(size=20_000)
         > 0).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 31, "verbose": -1}
    thist.reset_launch_counts()
    bk = lgt.train(params, lgt.Dataset(X, label=y), 5, verbose_eval=False,
                   device="cuda")
    assert thist.launch_counts["hist_full"] == 5
    assert thist.launch_counts["hist_leaves"] >= 5
    thist.reset_launch_counts()
    with thist.force_plain():
        bp = lgt.train(params, lgt.Dataset(X, label=y), 5,
                       verbose_eval=False, device="cuda")
    assert thist.launch_counts == {"hist_full": 0, "hist_leaves": 0}
    for tk, tp in zip(bk._gbdt.models, bp._gbdt.models):
        assert np.array_equal(tk.split_feature, tp.split_feature)
        assert np.array_equal(tk.threshold, tp.threshold)
    np.testing.assert_allclose(bk.predict(X[:2000]), bp.predict(X[:2000]),
                               rtol=0, atol=1e-6)
