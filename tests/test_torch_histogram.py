"""PyTorch port, histogram layer: plain versions vs the JAX references.

The port's ``ops/histogram.py`` holds the two hand-written CUDA kernels'
plain PyTorch versions; on the CPU every call takes them.  Here they are
held against the JAX package's exact scatter-add (``_hist_scatter``) and its
XLA per-leaf fallback at 1e-5 (f32 reassociation only; measured exact), and
against the Pallas kernels in interpret mode at ``HIST_PARITY_TOL`` (their
bf16 hi/lo split carries ~2^-18 relative error per row).  The kernels
themselves run only on the card: ``tests/test_torch_kernels_cuda.py``.
"""
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import histogram as jhist
from lightgbm_tpu_torch.ops import histogram as thist

pytestmark = pytest.mark.torch_port
# one intra-op thread each: the suite runs in several worker processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAIN_TOL = 1e-5


def relerr(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (np.abs(b) + 1.0), initial=0.0))


def _rows(rng, n):
    """grad/hess with masked rows (mask 0) and fractional GOSS-style weights."""
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.05, 0.25, n).astype(np.float32)
    m = np.where(rng.random(n) < 0.2, 0.0,
                 np.where(rng.random(n) < 0.3, 2.5, 1.0)).astype(np.float32)
    return g, h, m


def _t(*arrs):
    return [torch.as_tensor(a) for a in arrs]


@pytest.mark.parametrize("max_bin", [64, 256])
def test_build_histogram_plain_matches_scatter(max_bin):
    rng = np.random.default_rng(max_bin)
    n, f = 3000, 7
    bins = rng.integers(0, max_bin, (n, f)).astype(np.uint8)
    g, h, m = _rows(rng, n)
    ref = np.asarray(jax.jit(jhist._hist_scatter, static_argnums=4)(
        bins, g, h, m, max_bin))
    got = thist.build_histogram(*_t(bins, g, h, m), max_bin)
    assert got.shape == (f, max_bin, 3) and got.dtype == torch.float32
    assert relerr(got.numpy(), ref) <= PLAIN_TOL


def test_build_histogram_f_limit_and_out_of_range_bins():
    """Columns past f_limit are ignored; bins >= B match nothing (the
    Pallas kernels' rule), unlike the scatter reference, which clips them."""
    rng = np.random.default_rng(3)
    n, f, B = 1000, 4, 32
    bins = rng.integers(0, B, (n, f + 3)).astype(np.uint8)
    bins[::7, 1] = 200                                   # out of range
    g, h, m = _rows(rng, n)
    got = thist.build_histogram(*_t(bins, g, h, m), B, f_limit=f).numpy()
    assert got.shape == (f, B, 3)
    keep = bins[:, 1] < B
    ref1 = np.asarray(jhist._hist_scatter(bins[keep][:, 1:2], g[keep],
                                          h[keep], m[keep], B))
    assert relerr(got[1:2], ref1) <= PLAIN_TOL
    ref0 = np.asarray(jhist._hist_scatter(bins[:, :1], g, h, m, B))
    assert relerr(got[:1], ref0) <= PLAIN_TOL


def _leaves_case(rng, nb=9, BR=128, f=6, extra=12, k=5, nan_block=4):
    """Unsorted block_leaf, slot 3 empty, a NaN gradient in one block, and
    f_limit < NC (the frontier's 12 packed gradient bytes)."""
    C = nb * BR
    comb = rng.integers(0, 64, (C, f + extra)).astype(np.uint8)
    g, h, m = _rows(rng, C)
    if nan_block is not None:
        g[nan_block * BR + 5] = np.nan
    block_leaf = np.array([2, 0, 4, 1, 2, 0, 4, 1, 2][:nb], np.int32)
    assert 3 not in block_leaf
    return comb, g, h, m, block_leaf, k, BR, f


def test_build_histogram_leaves_plain_matches_xla():
    rng = np.random.default_rng(11)
    comb, g, h, m, bl, k, BR, f = _leaves_case(rng)
    B = 64
    ref = np.asarray(jhist.build_histogram_leaves(
        comb, g, h, m, bl, k, B, method="scatter", block_rows=BR, f_limit=f))
    got = thist.build_histogram_leaves(*_t(comb, g, h, m, bl), k, B,
                                       block_rows=BR, f_limit=f).numpy()
    assert got.shape == (k, f, B, 3)
    nan_slot = int(bl[4])
    assert np.isnan(got[nan_slot]).any()
    for s in range(k):
        if s != nan_slot:
            assert np.isfinite(got[s]).all(), f"NaN leaked into slot {s}"
    assert np.all(got[3] == 0.0)                          # empty slot
    fin = [s for s in range(k) if s != nan_slot]
    assert relerr(got[fin], ref[fin]) <= PLAIN_TOL
    same_nan = np.isnan(got[nan_slot]) == np.isnan(ref[nan_slot])
    assert same_nan.all()
    ok = ~np.isnan(ref[nan_slot])
    assert relerr(got[nan_slot][ok], ref[nan_slot][ok]) <= PLAIN_TOL


_PALLAS_SCRIPT = r"""
import sys, numpy as np, jax
jax.config.update("jax_platforms", "cpu")
from lightgbm_tpu.ops.histogram import _hist_pallas, _hist_leaves_pallas
d = np.load(sys.argv[1])
full = _hist_pallas(d["bins"], d["g"], d["h"], d["m"], int(d["B"]),
                    f_limit=int(d["f"]), interpret=True)
leaves = _hist_leaves_pallas(d["comb"], d["lg"], d["lh"], d["lm"], d["bl"],
                             int(d["k"]), int(d["B"]), int(d["BR"]),
                             int(d["lf"]), interpret=True)
np.savez(sys.argv[2], full=np.asarray(full), leaves=np.asarray(leaves))
print("OK")
"""


def test_plain_matches_pallas_interpret():
    """Both Pallas kernels in interpret mode, in a clean subprocess (the
    conftest strips the backends Pallas registers its lowerings with)."""
    rng = np.random.default_rng(5)
    B = 64
    n, f = 1024, 5
    bins = rng.integers(0, B, (n, f + 2)).astype(np.uint8)
    g, h, m = _rows(rng, n)
    comb, lg, lh, lm, bl, k, BR, lf = _leaves_case(rng, nb=5, f=4,
                                                   nan_block=None)
    with tempfile.TemporaryDirectory() as td:
        src, dst = os.path.join(td, "in.npz"), os.path.join(td, "out.npz")
        np.savez(src, bins=bins, g=g, h=h, m=m, B=B, f=f, comb=comb, lg=lg,
                 lh=lh, lm=lm, bl=bl, k=k, BR=BR, lf=lf)
        env = {kk: v for kk, v in os.environ.items() if "PYTHONPATH" not in kk}
        env["PYTHONPATH"] = REPO
        env["JAX_PLATFORMS"] = "cpu"
        r = subprocess.run([sys.executable, "-c", _PALLAS_SCRIPT, src, dst],
                           env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
        out = np.load(dst)
        full, leaves = out["full"], out["leaves"]
    got = thist.build_histogram(*_t(bins, g, h, m), B, f_limit=f).numpy()
    assert relerr(got, full) <= jhist.HIST_PARITY_TOL
    got_l = thist.build_histogram_leaves(*_t(comb, lg, lh, lm, bl), k, B,
                                         block_rows=BR, f_limit=lf).numpy()
    assert got_l.shape == leaves.shape
    assert relerr(got_l, leaves) <= jhist.HIST_PARITY_TOL


def test_subtract_and_unrolled_rank_match_jax():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(3, 4, 3)).astype(np.float32)
    b = rng.normal(size=(3, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        thist.subtract_histogram(*_t(a, b)).numpy(),
        np.asarray(jhist.subtract_histogram(jnp.asarray(a), jnp.asarray(b))))
    vals = np.sort(rng.integers(0, 50, 40)).astype(np.int32)
    tg = rng.integers(-3, 55, 30).astype(np.int32)
    for strict in (True, False):
        np.testing.assert_array_equal(
            thist.unrolled_rank(*_t(vals, tg), strict).numpy(),
            np.asarray(jhist.unrolled_rank(jnp.asarray(vals),
                                           jnp.asarray(tg), strict)))


def test_cpu_tensors_take_the_plain_path_and_wrappers_refuse_them():
    """A CPU tensor takes the plain version and launches nothing; the
    kernel wrappers themselves accept only CUDA tensors."""
    rng = np.random.default_rng(0)
    bins = rng.integers(0, 16, (256, 3)).astype(np.uint8)
    g, h, m = _rows(rng, 256)
    thist.reset_launch_counts()
    thist.build_histogram(*_t(bins, g, h, m), 16)
    thist.build_histogram_leaves(*_t(bins, g, h, m),
                                 torch.zeros(2, dtype=torch.int32), 1, 16,
                                 block_rows=128)
    assert thist.launch_counts == {"hist_full": 0, "hist_leaves": 0}
    with pytest.raises(ValueError, match="CUDA"):
        thist.hist_full(*_t(bins, g, h, m), 16)
    with pytest.raises(ValueError, match="CUDA"):
        thist.hist_leaves(*_t(bins, g, h, m),
                          torch.zeros(2, dtype=torch.int32), 1, 16,
                          block_rows=128)
    assert thist.launch_counts == {"hist_full": 0, "hist_leaves": 0}


def test_force_plain_is_scoped():
    assert not thist._force_plain
    with thist.force_plain():
        assert thist._force_plain
    assert not thist._force_plain
